"""The inference server of the port (counterpart of
``containerpilot_tpu/workload/serve.py``).

API (token-level):

    POST /v1/generate {"tokens": [[1,2,3]], "max_new_tokens": 16,
                       "temperature": 0.0, "n": 1, ...}
        -> {"tokens": [[...generated ids...]]}
        ("logprobs": true echoes per-token logprobs of the trimmed
        generated ids; "stream": true, with --slots, answers with SSE
        events {"tokens": [delta]} ... {"done": true, "count": n};
        "beam_width": W, with "length_penalty", returns the best of W
        beams for one prompt row)
    POST /v1/score {"tokens": [[...]]}
        -> {"logprobs": [[lp(t1|t0), lp(t2|t0..1), ...]],
            "sums": [total lp per row]}   (teacher-forced scoring)
    POST /v1/completions {"prompt": "text", ...}   (behind --text)
        -> {"text": "...", "tokens": [...]}  (byte-level tokenizer;
        "stream": true, with --slots, answers SSE events carrying
        each delta's ids and text)
    GET /health     -> 200 once warm (503 while draining)
    GET /v1/model   -> config summary (the reference's schema; the
                       features not ported yet report None)
    GET /metrics    -> Prometheus exposition (requests, latency, tokens,
                       the device-time ledger, event-loop lag)
    GET /v1/traces  -> the replica's trace ring (recent and slowest)
    GET /v1/goodput -> the device-time ledger (stages summing to uptime,
                       dispatches/token, scheduling gaps)

The fleet verbs (kvtier/handoff.py, fleet/standby.py):

    POST /v1/prefill {"tokens": [[...]]}  -> run one prompt through the
        slot engine's admission for its side effect (the prompt's KV in
        the prefix cache), {"ok", "cached", "tokens_prefilled"}
    POST /v1/kv[?chunk=K] {"tokens": [[...]]}  -> that prompt's cached KV
        entry as a manifest-framed, digest-verified chunk stream
    POST /v1/kv/pull {"tokens": [[...]], "from": "host:port"}  -> fetch
        the entry from the peer into the spill tier; the next request for
        the prompt readmits it through ``reuse_admission``
    POST /v1/migrate  -> drain-migration progress, or {"targets": [...]}
        to evacuate the cached sessions toward them
    GET /v1/weights[?chunk=K]  -> the params as a manifest-framed chunk
        stream (what a standby's --weights-from fetches)
    POST /v3/standby/promote  -> a standby turns active

Requests route as the reference routes them: beams first
(serve_strategies.run_beam, models/beam.py); then greedy, penalty-free,
bias-free single rows through the speculative engine (``--draft-layers``
and ``--speculate``: a slot engine over models/speculative.py's
SpeculativeStepProgram, the target's first N layers drafting); then
single rows through the slot engine (``--slots``, serve_slots.py:
continuous admission into a pool decoded by CUDA-graph replays), a
prefix-cache hit (``--prefix-cache``, serve_prefix.py) or chunked
prefill (``--prefill-chunk``, serve_strategies.py); everything else goes
through the continuous batcher (serve_batcher.py) into
``models.decode.generate``. Generation runs on worker threads, so the
event loop (health checks included) never waits on the device. Every
CUDA graph of the slot engine is captured, and every speculative round
shape run, while the server warms, before ``/health`` turns 200. Unlike
the reference, ``max_new_tokens`` is not bucketed to a multiple of 16
(eager torch compiles nothing); the trimmed output is the same.

The telemetry face is the reference's: every API route is counted, timed
and traced (``_instrumented``: the caller's ``X-CP-Trace`` id adopted
and echoed, the span digest returned in ``X-CP-Span-Digest`` or in a
stream's final event); the device-time ledger (telemetry/goodput.py)
runs from construction (``boot``) through ``compile_warmup`` to
``idle`` before ``/health`` turns 200, and the slot engine stamps
prefill/decode/idle at request boundaries. The server speaks cp-mux/1
(utils/http.py) unless built with ``mux=False``.

Serving over ranks (``mesh``, ``lockstep``: ``--tp``/``--cp``, one
process a rank, parallel/serving.py): this server is the FRONT, on rank
0, over its blocks of the params. Every device call (a Batcher batch,
chunked and context-parallel prefill, a beam, a prefix-cache request,
``/v1/score``, the slot and speculative engines' verbs, the warmup, the
fleet verbs' gathers and scatters) is a lockstep op: broadcast to the
followers (``ServingFollower``, no HTTP surface), then run here. Single
rows at least ``cp_min_len`` long ring their prefill over the mesh's
``seq`` axis (``cp_mesh``; serve_strategies.run_cp, or the slot engine's
admission). Every rank keeps a prefix cache (and spill tier) of its own
KV blocks under the same keys, and the lockstep's check holds their
keys equal. The fleet's wire does not change: ``/v1/kv`` and
``/v1/weights`` send whole entries and params, gathered over ``model``
(``parallel.sharding.gather_kv_entry``, ``gather_leaf``), and
``/v1/kv/pull`` hands the whole entry to every rank, which keeps its
part (``local_kv_entry``), so a pod, a one-rank replica and a JAX
replica read each other. ``/v1/model`` reports ``mesh`` and ``cp`` in
the reference's schema, and ``lockstep`` (the ranks, the step program's
mode, whether every rank's tokens and caches agree). Under ``--cp`` the
reference's own refusals stand (``refuse_cp_compositions``).

A fleet member (fleet/member.py) heartbeats the server's ``occupancy``,
``role``, ``kv_note``, ``prefix_digest_note``, ``goodput_note`` and
``migrate_note``; its drain runs ``migrate_sessions``, and while draining a
refused request carries a migration-aware ``Retry-After`` and, once its
prefix landed on a survivor, ``X-CP-Migrated-To``. A ``standby`` answers
``/health`` and generate 503 until promoted; ``prefill`` and ``decode``
are routing advice and serve anything.

``python -m containerpilot_tpu_torch.workload.serve`` runs the CLI
(serve_cli.py).
"""
from __future__ import annotations

import asyncio
import json
import logging
import threading
import time
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Awaitable, Callable, Dict, List, Optional

import torch

from .. import resolve_device
from ..models.beam import validate_beam_args
from ..models.decode import generate
from ..models.speculative import warm_speculative
from ..models.transformer import TransformerConfig
from ..analysis.loopcheck import LoopLagProbe
from ..telemetry import tracing
from ..telemetry.goodput import DeviceTimeLedger, goodput_payload
from ..utils.http import HTTPServer, Request, Response, StreamingResponse
from ..utils.prom import (
    Counter,
    Histogram,
    Registry,
    ensure_build_info,
    ensure_goodput_gauges,
    ensure_loop_lag_gauge,
    exposition,
)
from . import serve_strategies
from .modelcfg import (
    parse_logit_bias,
    parse_stop_ids,
    parse_stop_strings,
    score_logprobs_fn,
)
from .serve_batcher import Batcher, GenJob, generate_rows
from .serve_cli import main  # noqa: F401  (one import path for the CLI)
from .serve_prefix import MIN_REUSE, PrefixCache, generate_with_prefix

log = logging.getLogger("containerpilot.serve")

# warmup()'s slot-engine request: this many prompt ids + (chunk+1) new
# tokens (chunk+2 with fused windows). The construction-time max_len
# guard and the warm request itself must agree.
WARMUP_PROMPT_LEN = 4


def slot_window_for(max_len: int, slot_chunk: int, slot_window: int) -> int:
    """The slot engine's rounds a dispatch: fused windows need a warmup
    request that rides one pure-decode cycle (chunk+2 new tokens); a
    max_len too tight for that clamps the engine to one-round dispatches,
    as the reference does."""
    if WARMUP_PROMPT_LEN + slot_chunk + 2 > max_len:
        return 1
    return slot_window


def score_rows(srv: Any, tokens: List[List[int]]):
    """Teacher-forced logprobs of token rows [b, n] -> numpy [b, n - 1]
    (the device call of /v1/score and the logprobs echo)."""
    toks = torch.tensor(tokens, dtype=torch.int64, device=srv.device)
    picked = srv._score_fn(srv.params, toks).cpu().double().numpy()
    if srv.lockstep is not None:
        srv.lockstep.record_tokens(picked)
    return picked


def warm_shapes(srv: Any) -> None:
    """The warmup's device work: the default-shaped requests once, one
    sampled token (the draw kernel builds here, not under the first
    sampled request), then, with a draft, every speculative round
    shape."""
    for prompt_len in (4, 16):
        if prompt_len + 16 > srv.max_len:
            continue
        prompt = torch.zeros(
            (1, prompt_len), dtype=torch.int64, device=srv.device
        )
        generate(
            srv.params, prompt, srv.cfg, max_new_tokens=16,
            max_len=srv.max_len, mesh=srv.mesh,
        )
    if srv.max_len >= 5:
        generate(
            srv.params, torch.zeros((1, 4), dtype=torch.int64,
                                    device=srv.device),
            srv.cfg, max_new_tokens=1, max_len=srv.max_len,
            temperature=1.0, mesh=srv.mesh,
        )
    if srv.draft_params is not None and srv.max_len >= 20:
        warm_speculative(
            srv.params, srv.draft_params, srv.cfg, srv.draft_cfg,
            srv.speculate, srv.max_len, mesh=srv.mesh,
        )


def _split(srv: Any) -> bool:
    """Whether ``srv``'s params and KV are cut over a ``model`` axis."""
    return srv.mesh is not None and srv.mesh.axis_size("model") > 1


def _every_rank(srv: Any, flag: bool) -> bool:
    """``flag`` and-ed over every rank (one gather on the op channel)."""
    if srv.lockstep is None:
        return flag
    flags = [None] * srv.lockstep.size
    torch.distributed.all_gather_object(flags, bool(flag),
                                        group=srv.lockstep.group)
    return all(flags)


def export_kv(srv: Any, key: tuple):
    """The prefix cache's entry for ``key`` as a whole host tree (device
    tier first, else the spill tier; no readmit, no MRU bump), or None
    when it is gone. Over ranks every rank's part is gathered over
    ``model``, and the front gets the tree."""
    from ..kvtier.spill import to_device, to_host
    from ..parallel.sharding import gather_kv_entry

    pc = srv.prefix_cache
    entry = pc.device_entry(key)
    if entry is None and pc.spill is not None:
        # spilled entries are already on the host
        entry = pc.spill.peek(key)
    if not _every_rank(srv, entry is not None):
        return None
    if _split(srv):
        entry = gather_kv_entry(to_device(entry, srv.device), srv.cfg,
                                srv.mesh)
        if not srv.lockstep.front:
            return None
    return to_host(entry)


def adopt_kv(srv: Any, key: tuple, host_tree: Any) -> int:
    """A whole host entry into the spill tier (``PrefixCache.adopt_host``);
    over ranks each rank adopts its part. Returns the bytes adopted
    here."""
    if _split(srv):
        from ..parallel.sharding import local_kv_entry

        host_tree = local_kv_entry(host_tree, srv.cfg, srv.mesh)
    return srv.prefix_cache.adopt_host(tuple(key), host_tree)


def _param_leaves(srv: Any):
    """(keystr name, leaf, rule) of the params in the wire's order; the
    rule is None when the leaf is whole on this rank."""
    from ..fleet.standby import param_leaves
    from ..parallel.sharding import leaf_rules, sharded_by

    leaves = param_leaves(srv.params)
    if not _split(srv):
        return [(name, leaf, None) for name, leaf in leaves]
    rules = param_leaves(leaf_rules(srv.params, srv.mesh, srv.cfg))
    return [(name, leaf, rule if sharded_by(rule, srv.mesh) else None)
            for (name, leaf), (_n, rule) in zip(leaves, rules)]


def _whole(srv: Any, leaf, rule):
    """A leaf whole: gathered along its rule over ranks (collective)."""
    from ..parallel.sharding import gather_leaf

    return leaf if rule is None else gather_leaf(leaf.detach(), rule,
                                                 srv.mesh)


def weights_manifest_op(srv: Any):
    """The weight wire's manifest of the whole params (the front's;
    None on a follower, which only takes part in the gathers). Each leaf
    is gathered as the manifest reaches it and dropped after."""
    from ..fleet.standby import manifest_of_leaves

    leaves = ((name, _whole(srv, leaf, rule))
              for name, leaf, rule in _param_leaves(srv))
    if srv.lockstep is not None and not srv.lockstep.front:
        for _leaf in leaves:
            pass
        return None
    return manifest_of_leaves(leaves)


def weight_leaf_bytes(srv: Any, index: int):
    """The byte image of whole leaf ``index`` (the front's; None on a
    follower)."""
    from ..fleet.standby import leaf_bytes

    _name, leaf, rule = _param_leaves(srv)[index]
    leaf = _whole(srv, leaf, rule)
    if srv.lockstep is not None and not srv.lockstep.front:
        return None
    return leaf_bytes(leaf)


def serving_ops(srv: Any) -> Dict[str, Any]:
    """The server's lockstep ops (besides the slot and speculative
    engines' verbs), each a call on ``srv``: an ``InferenceServer`` on
    the front, a ``ServingFollower`` elsewhere."""
    return {
        "generate": lambda jobs: generate_rows(srv, jobs),
        "chunked": lambda *args: serve_strategies.run_chunked(srv, *args),
        "cp": lambda tokens, p: serve_strategies.run_cp(srv, tokens, p),
        "beam": lambda *args: serve_strategies.run_beam(srv, *args),
        "prefix": lambda *args: generate_with_prefix(srv, *args),
        "score": lambda tokens: score_rows(srv, tokens),
        "warm": lambda: warm_shapes(srv),
        "kv.export": lambda key: export_kv(srv, key),
        "kv.adopt": lambda key, tree: adopt_kv(srv, key, tree),
        "weights.manifest": lambda: weights_manifest_op(srv),
        "weights.leaf": lambda index: weight_leaf_bytes(srv, index),
    }


def make_prefix_cache(entries: int, spill_bytes: int, device,
                      lockstep: Any = None) -> Optional[PrefixCache]:
    """``--prefix-cache`` with its spill tier (``--kv-spill-mb``, a
    rank's budget over ranks), held to agreement over a lockstep."""
    if entries <= 0:
        return None
    spill = None
    if spill_bytes > 0:
        # host-RAM floor under the device LRU: evictions spill, later
        # matches copy back (kvtier/spill.py)
        from ..kvtier.spill import HostSpillTier

        spill = HostSpillTier(spill_bytes, device=device)
    pc = PrefixCache(entries, spill=spill)
    if lockstep is not None:
        lockstep.watch("prefix", pc.keys_digest)
    return pc


def make_spec_engine(srv: Any, draft_layers: int, prefill_chunk: int,
                     worker: bool = True):
    """The speculative engine: a slot engine over a
    ``SpeculativeStepProgram`` whose draft is the target's first
    ``draft_layers`` layers (of a rank's blocks, over ranks). Sets
    ``srv.draft_params``/``draft_cfg``; its verbs are ``spec.*`` ops."""
    from ..models.speculative import (
        SpeculativeStepProgram,
        layer_prefix_draft,
    )
    from .serve_slots import SlotEngine

    srv.draft_params, srv.draft_cfg = layer_prefix_draft(
        srv.params, srv.cfg, draft_layers
    )
    # one slot, the verify rollback a per-sequence pos rewind. No
    # ledger: the slot engine (or, without one, the handler window in
    # _instrumented) owns the stamps
    return SlotEngine(
        srv.cfg, srv.params, srv.max_len, prefill_chunk=prefill_chunk,
        program=SpeculativeStepProgram(
            srv.cfg, srv.draft_cfg, srv.params, srv.draft_params,
            srv.max_len, speculate=srv.speculate, mesh=srv.mesh,
        ),
        mesh=srv.mesh, lockstep=srv.lockstep, worker=worker, name="spec",
    )


def refuse_cp_compositions(draft_layers: int, prefix_cache_entries: int,
                           window: int) -> None:
    """The compositions --cp refuses, with the reference's messages."""
    for flag, why in (
        (draft_layers > 0, "--draft-layers (speculative prefill is "
         "chunk-driven)"),
        (prefix_cache_entries > 0, "--prefix-cache (cached prefixes "
         "bypass the ring)"),
        (window > 0, "--window (ring attention rejects sliding windows)"),
    ):
        if flag:
            raise ValueError(f"--cp does not compose with {why}")


def resolve_cp(cp_mesh, cp_min_len: int, max_len: int, cfg,
               draft_layers: int = 0, prefix_cache_entries: int = 0) -> int:
    """The reference's --cp validation: a seq axis > 1, the threshold
    policy, and the compositions it refuses. Returns the threshold."""
    from ..parallel.context import resolve_cp_min_len

    seq_axis = cp_mesh.shape.get("seq", 1)
    if seq_axis <= 1:
        raise ValueError(
            "--cp mesh needs a seq axis > 1 (MeshPlan(seq=...))"
        )
    cp_min_len = resolve_cp_min_len(cp_min_len, seq_axis, max_len)
    refuse_cp_compositions(draft_layers, prefix_cache_entries, cfg.window)
    return cp_min_len


def _parse_token_rows(body: Dict[str, Any], vocab: int, min_row_len: int):
    """A non-empty list of equal-length integer rows within the vocab.
    Raises ValueError with a client-facing message."""
    tokens = body["tokens"]
    if not isinstance(tokens, list) or not tokens or not all(
        isinstance(row, list) and len(row) >= min_row_len for row in tokens
    ):
        raise ValueError(
            f"'tokens' must be a non-empty list of rows with "
            f">= {min_row_len} ids"
        )
    row_len = len(tokens[0])
    if any(len(row) != row_len for row in tokens):
        raise ValueError("all rows must share a length (pad first)")
    if any(
        not isinstance(t, int) or isinstance(t, bool) or t < 0 or t >= vocab
        for row in tokens
        for t in row
    ):
        raise ValueError(f"token ids must be integers in [0, {vocab})")
    return tokens, row_len


class InferenceServer:
    def __init__(
        self,
        cfg: TransformerConfig,
        params: Any,
        host: str,
        port: int,
        max_len: int,
        max_batch_rows: int = 16,
        device="cuda",
        prefix_cache_entries: int = 0,
        prefill_chunk: int = 0,
        slots: int = 0,
        slot_chunk: int = 8,
        slot_window: int = 4,
        checkpoint: Optional[Dict[str, Any]] = None,
        draft_layers: int = 0,
        speculate: int = 4,
        text: bool = False,
        mux: bool = True,
        kv_spill_bytes: int = 0,
        role: str = "active",
        mesh: Any = None,
        cp_mesh: Any = None,
        cp_min_len: int = 0,
        lockstep: Any = None,
    ) -> None:
        # device-time ledger: every wall-second of this replica's life in
        # exactly one stage, starting now in ``boot``; warmup() moves it
        # to compile_warmup and then idle, before /health turns 200
        self.ledger = DeviceTimeLedger()
        self.device = resolve_device(device)
        if params["norm_out"].device != self.device:
            raise ValueError(
                f"params live on {params['norm_out'].device}, the server "
                f"on {self.device}"
            )
        self.cfg = cfg
        self.params = params
        # serving over ranks: the params are this rank's blocks of
        # ``mesh`` (the cp mesh serves both), every device call a
        # lockstep op
        self.mesh = mesh if mesh is not None else cp_mesh
        self.lockstep = lockstep
        self.sharded = self.mesh is not None and self.mesh.size > 1
        self.host = host
        self.port = port
        self.max_len = max_len
        self.ready = False
        # time.monotonic() when /health turned 200 (None before)
        self.ready_at = None
        # fleet role: a "standby" warms like an active replica but
        # answers /health and generate 503 until POST /v3/standby/promote;
        # "prefill" and "decode" are the disaggregated pools' routing
        # advice and serve anything
        if role not in ("active", "standby", "prefill", "decode"):
            raise ValueError(
                "role must be 'active', 'standby', 'prefill', or "
                "'decode'"
            )
        self.role = role
        # the cc= advertisement of the kernel build directory, computed
        # once when warmup built the kernels (never on a heartbeat)
        self._compile_cache_note = ""
        # peer weight transfer: the manifest is built once (executor)
        # and cached; chunk bytes are re-derived per request, so the
        # server never holds a second full copy of the params
        self._weights_manifest_cache: Optional[Dict[str, Any]] = None
        self._weights_manifest_bytes = b""
        self._weights_lock: Optional[asyncio.Lock] = None
        # maintenance drain: /health 503, new generate/completions 503 +
        # Retry-After, everything admitted decodes to completion
        self.draining = False
        self._inflight = 0
        # drain migration (kvtier/handoff.py in reverse): the current
        # evacuation's progress and cumulative counters for ``mg=``;
        # ``landed`` maps fingerprint -> target id, most recent last
        self.migration: Dict[str, Any] = {
            "active": False, "total": 0, "done": 0, "failed": 0,
            "timeout": 0, "window_s": 0.0, "started_at": 0.0,
        }
        self._migration_landed: "OrderedDict[int, str]" = OrderedDict()
        self._migration_counters = {
            "done": 0, "total": 0, "failed": 0, "timeout": 0,
        }
        # test-only fault-injection seam (the chaos harness): when set,
        # awaited before every instrumented API handler and at warm-up.
        # Injects per-request latency (slow-replica brownouts) or raises
        # to fail requests, without touching any serving path. Never
        # set in production; None costs one attribute load per request.
        self.chaos_hook: Optional[
            Callable[[str], Awaitable[None]]
        ] = None
        # context-parallel prefill: single rows at least cp_min_len long
        # ring over the mesh's seq axis; compositions validated here
        self.cp_mesh = cp_mesh
        self.cp_min_len = cp_min_len
        if cp_mesh is not None:
            self.cp_min_len = resolve_cp(
                cp_mesh, cp_min_len, max_len, cfg, draft_layers,
                prefix_cache_entries)
        if self.sharded:
            if lockstep is None and torch.distributed.is_initialized():
                raise ValueError(
                    "serving over ranks needs a lockstep "
                    "(parallel/serving.py): every device call must reach "
                    "every rank")
        self.max_batch_rows = max_batch_rows
        # what the weights came from: {"step": n, "ema": bool} for a
        # restored checkpoint, None for the seeded initialization
        self.checkpoint = checkpoint
        # self-speculative decoding: a layer-prefix draft speeds up greedy
        # single-row generation, output unchanged
        self.draft_params = self.draft_cfg = None
        self.speculate = speculate
        if draft_layers > 0 and speculate < 1:
            raise ValueError("speculate must be >= 1")
        if draft_layers > 0 and cfg.window > 0:
            raise ValueError(
                "--draft-layers does not compose with --window "
                "(speculative rollback cannot undo ring-cache writes)"
            )
        if prefix_cache_entries > 0 and cfg.window > 0:
            raise ValueError(
                "--prefix-cache does not compose with --window (a "
                "ring cache's stale rows are live window context, so "
                "a shorter-prefix rewind cannot reuse them)"
            )
        if prefill_chunk < 0:
            raise ValueError("prefill_chunk must be >= 0")
        # prompts longer than this stream through decode_chunk pieces
        # (peak prefill activations O(chunk) instead of O(prompt))
        self.prefill_chunk = prefill_chunk
        if kv_spill_bytes > 0 and prefix_cache_entries <= 0:
            raise ValueError(
                "--kv-spill requires --prefix-cache (the spill tier "
                "catches the prefix cache's evictions)"
            )
        self.prefix_cache = make_prefix_cache(
            prefix_cache_entries, kv_spill_bytes, self.device, lockstep)
        # continuous decode admission: single-row requests join a running
        # chunk loop over a fixed slot pool (serve_slots.py)
        self.slot_engine = None
        if slot_window < 1:
            raise ValueError("slot_window must be >= 1")
        if slots > 0:
            # warmup() pushes a request of WARMUP_PROMPT_LEN prompt ids +
            # (chunk+1) new tokens through the engine; a legal but tiny
            # --max-len must fail here with a clean message
            if WARMUP_PROMPT_LEN + slot_chunk + 1 > max_len:
                raise ValueError(
                    f"--slots requires max_len >= slot_chunk + "
                    f"{WARMUP_PROMPT_LEN + 1} (warmup request needs "
                    f"{WARMUP_PROMPT_LEN} prompt ids + "
                    f"chunk+1={slot_chunk + 1} new tokens; max_len is "
                    f"{max_len})"
                )
            # fused windows need a warmup request that rides one pure-
            # decode cycle (chunk+2 new tokens); a max_len too tight for
            # that clamps the engine to one-round dispatches, as the
            # reference does (its fused program would otherwise compile
            # under a live request)
            slot_window = slot_window_for(max_len, slot_chunk, slot_window)
            from .serve_slots import SlotEngine

            self.slot_engine = SlotEngine(
                cfg, params, max_len, slots=slots, chunk=slot_chunk,
                window=slot_window, prefill_chunk=prefill_chunk,
                prefix_cache=self.prefix_cache, ledger=self.ledger,
                cp_mesh=cp_mesh, cp_min_len=self.cp_min_len,
                mesh=self.mesh, lockstep=lockstep,
            )
        # speculative decoding rides a slot engine of its own
        self.spec_engine = (
            make_spec_engine(self, draft_layers, prefill_chunk)
            if draft_layers > 0 else None
        )
        self._executor = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="inference"
        )
        # request/latency/token metrics in a private registry, the
        # reference's families and buckets
        self._metrics_registry = Registry()
        self._m_requests = Counter(
            "containerpilot_serve_requests",
            "requests served, by endpoint and status code",
            ["endpoint", "code"], registry=self._metrics_registry,
        )
        self._m_latency = Histogram(
            "containerpilot_serve_request_seconds",
            "request wall time, by endpoint",
            ["endpoint"], registry=self._metrics_registry,
            buckets=(.005, .02, .05, .1, .25, .5, 1, 2.5, 5, 10, 30, 60),
        )
        self._m_tokens = Counter(
            "containerpilot_serve_generated_tokens",
            "tokens returned by generate/completions (post-trim)",
            registry=self._metrics_registry,
        )
        ensure_build_info(self._metrics_registry, "replica")
        ensure_goodput_gauges(
            self._metrics_registry, self.ledger, self._decode_counters
        )
        self._loop_probe = LoopLagProbe()
        ensure_loop_lag_gauge(self._metrics_registry, self._loop_probe)
        # replica-side traces under the caller's id (X-CP-Trace, or the
        # mux HEADERS field) or a minted one, kept in a ring for
        # GET /v1/traces
        self._tracer = tracing.TraceRecorder("replica")
        self._server = HTTPServer()
        # cp-mux/1 accept path; mux=False answers the upgrade 404 and a
        # gateway falls back to HTTP/1.1 for this replica
        self._server.mux_enabled = mux
        self._server.route("GET", "/health", self._health)
        self._server.route("GET", "/metrics", self._metrics)
        self._server.route("GET", "/v1/traces", self._traces)
        self._server.route("GET", "/v1/goodput", self._goodput)
        # the standby's promote verb and the weights a launching peer
        # fetches (fleet/standby.py)
        self._server.route(
            "POST", "/v3/standby/promote", self._promote_verb
        )
        # the disaggregated prefill/decode handoff (kvtier/handoff.py)
        # and drain migration, registered outside _instrumented: a
        # draining replica still serves them
        for method, path, handler in (
            ("GET", "/v1/weights", self._weights),
            ("POST", "/v1/prefill", self._prefill_verb),
            ("POST", "/v1/kv", self._kv_export),
            ("POST", "/v1/kv/pull", self._kv_pull),
            ("POST", "/v1/migrate", self._migrate_verb),
        ):
            self._server.route(method, path, handler)
        route = self._instrumented
        self._server.route("GET", "/v1/model",
                           route("model", self._model_info))
        self._server.route("POST", "/v1/generate",
                           route("generate", self._generate))
        self._server.route("POST", "/v1/score", route("score", self._score))
        # text surface: byte-level tokenizer, no external assets
        self.tokenizer = None
        if text:
            from .text import ByteTokenizer

            self.tokenizer = ByteTokenizer(cfg.vocab_size)
            self._server.route("POST", "/v1/completions",
                               route("completions", self._completions))
        self._score_fn = score_logprobs_fn(cfg, self.mesh)
        self._batcher = Batcher(
            params, cfg, max_len, max_batch_rows, self._executor
        )
        self._batcher.run_rows = lambda jobs: self._device_call(
            "generate", jobs)
        self.batch_stats = self._batcher.stats
        self._ops = serving_ops(self)
        if lockstep is not None:
            lockstep.register(self._ops)

    def _device_call(self, name: str, *args):
        """One device call: a lockstep op when serving over ranks (every
        follower runs it too), else the op here."""
        if self.lockstep is not None:
            return self.lockstep.call(name, args)
        return self._ops[name](*args)

    # -- handlers -------------------------------------------------------

    async def _health(self, _req: Request) -> Response:
        if self.draining:
            return Response(
                503, b"draining\n", headers={"Retry-After": "1"}
            )
        if not self.ready:
            return Response(503, b"warming up\n")
        if self.role == "standby":
            # warm but not serving until promoted; its heartbeat carries
            # role=standby so the fleet knows it exists
            return Response(
                503, b"standby\n", headers={"Retry-After": "1"}
            )
        return Response(200, b"ok\n")

    async def _metrics(self, _req: Request) -> Response:
        body, content_type = exposition(self._metrics_registry)
        return Response(200, body, content_type=content_type)

    async def _traces(self, req: Request) -> Response:
        """Per-process trace ring: slowest-N + most-recent-N, JSON."""
        return Response(
            200, self._tracer.snapshot_json(req.query),
            content_type="application/json",
        )

    def _decode_counters(self):
        """(dispatches, tokens_out) of the slot and speculative engines
        summed; zeros without either."""
        dispatches = tokens_out = 0
        for engine in (self.slot_engine, self.spec_engine):
            if engine is not None:
                dispatches += engine.dispatches
                tokens_out += engine.tokens_out
        return dispatches, tokens_out

    async def _goodput(self, _req: Request) -> Response:
        """The device-time ledger, JSON: per-stage seconds (summing to
        uptime), productive fraction, dispatches/token and scheduling
        gaps, all computed on this read path."""
        dispatches, tokens_out = self._decode_counters()
        payload = goodput_payload(
            self.ledger, self._tracer, dispatches, tokens_out,
            role="replica", ready=self.ready, draining=self.draining,
        )
        return Response(
            200, json.dumps(payload).encode(),
            content_type="application/json",
        )

    # -- standby and peer weight transfer (fleet/standby.py) ------------

    def promote(self) -> bool:
        """Standby -> active in one assignment: /health turns 200 and
        generate opens on the next request. False when this replica is
        not a promotable standby (already active, or draining)."""
        if self.role != "standby" or self.draining:
            return False
        self.role = "active"
        log.info("serve: standby promoted to active")
        return True

    async def _promote_verb(self, _req: Request) -> Response:
        """``POST /v3/standby/promote``: the control-plane face of
        ``promote()``; a second promoter finds the role active and
        gets 409."""
        if self.role == "active":
            return Response(409, b"already active\n")
        if self.draining:
            return Response(409, b"draining\n")
        self.promote()
        return Response(
            200, json.dumps({"promoted": True, "ready": self.ready}).encode(),
            content_type="application/json",
        )

    async def _ensure_weights_manifest(self) -> Dict[str, Any]:
        """Build (once, on an executor) and cache the transfer manifest;
        the chunk bytes are re-derived at serve time."""
        if self._weights_manifest_cache is not None:
            return self._weights_manifest_cache
        if self._weights_lock is None:
            self._weights_lock = asyncio.Lock()
        async with self._weights_lock:
            if self._weights_manifest_cache is None:
                from ..fleet.standby import encode_manifest

                # over ranks every leaf is gathered, digested on the
                # front and dropped
                manifest = await asyncio.get_running_loop().run_in_executor(
                    None, self._device_call, "weights.manifest"
                )
                self._weights_manifest_bytes = encode_manifest(manifest)
                self._weights_manifest_cache = manifest
        return self._weights_manifest_cache

    @staticmethod
    def _chunk_start(req: Request):
        """``?chunk=K`` -> K, or a 422 Response."""
        try:
            start = int(req.query.get("chunk", ["0"])[0])
        except (ValueError, IndexError):
            return Response(422, b"chunk must be an integer\n")
        if start < 0:
            return Response(422, b"chunk must be >= 0\n")
        return start

    async def _weights(self, req: Request):
        """``GET /v1/weights[?chunk=K]``: the params as a length-prefixed
        manifest followed by digest-verified chunks from flat chunk index
        K (the resume point after a connection death). Each leaf is
        copied to the host on an executor as the stream reaches it (over
        ranks, gathered whole first: a lockstep op a leaf)."""
        manifest = await self._ensure_weights_manifest()
        start = self._chunk_start(req)
        if isinstance(start, Response):
            return start
        chunk_specs = manifest["chunks"]
        if start > len(chunk_specs):
            return Response(
                422, f"chunk must be in [0, {len(chunk_specs)}]\n".encode()
            )
        head = self._weights_manifest_bytes
        loop = asyncio.get_running_loop()

        async def body():
            yield head
            current = -1
            data = b""
            for spec in chunk_specs[start:]:
                if spec["leaf"] != current:
                    current = spec["leaf"]
                    data = await loop.run_in_executor(
                        None, self._device_call, "weights.leaf", current
                    )
                yield data[spec["offset"]:spec["offset"] + spec["len"]]

        return StreamingResponse(
            body(), content_type="application/octet-stream"
        )

    # -- disaggregated prefill/decode handoff (kvtier/handoff.py) -------

    def _one_row(self, req: Request, what: str):
        """(parsed body, the single token row) of a fleet verb's body;
        ValueError/KeyError/TypeError for a 422."""
        body = json.loads(req.body.decode() or "{}")
        tokens, _plen = _parse_token_rows(
            body, self.cfg.vocab_size, min_row_len=1
        )
        if len(tokens) != 1:
            raise ValueError(f"{what} takes a single token row")
        return body, tokens[0]

    async def _prefill_verb(self, req: Request) -> Response:
        """``POST /v1/prefill {"tokens": [[...]]}``: one prompt through
        the slot engine's admission for its side effect (the completed
        prompt's KV in the prefix cache, its fingerprint in the next
        digest), the one sampled token discarded: the prefill half of a
        handoff."""
        if self.slot_engine is None or self.prefix_cache is None:
            return Response(
                409, b"prefill handoff needs --slots and --prefix-cache\n"
            )
        if self.draining:
            return Response(503, b"draining\n", headers={"Retry-After": "1"})
        try:
            _body, row = self._one_row(req, "prefill")
            if len(row) + 1 > self.max_len:
                raise ValueError(
                    f"prompt_len + 1 exceeds max_len {self.max_len}"
                )
        except (ValueError, KeyError, TypeError) as exc:
            return Response(422, f"{exc}\n".encode())
        await asyncio.wrap_future(self.slot_engine.submit(row, max_new=1))
        key = tuple(row)
        pc = self.prefix_cache
        cached = pc.device_entry(key) is not None or (
            pc.spill is not None and pc.spill.peek(key) is not None
        )
        return Response(
            200,
            json.dumps({
                # False under the reuse floor: never cached, nothing to
                # hand off
                "ok": True, "cached": bool(cached),
                "tokens_prefilled": len(row),
            }).encode(),
            content_type="application/json",
        )

    async def _kv_export(self, req: Request):
        """``POST /v1/kv[?chunk=K] {"tokens": [[...]]}``: this replica's
        prefix-cache entry for exactly that prompt, as a length-prefixed
        manifest followed by digest-verified chunks from flat index K.
        404 when the entry is gone from both tiers. The host copy (over
        ranks, the gather of every rank's part) and serialization run on
        an executor."""
        pc = self.prefix_cache
        if pc is None:
            return Response(409, b"no prefix cache on this replica\n")
        try:
            _body, row = self._one_row(req, "kv export")
        except (ValueError, KeyError, TypeError) as exc:
            return Response(422, f"{exc}\n".encode())
        start = self._chunk_start(req)
        if isinstance(start, Response):
            return start
        key = tuple(row)

        def plan():
            from ..kvtier.handoff import kv_transfer_plan

            host = self._device_call("kv.export", key)
            return None if host is None else kv_transfer_plan(host)

        built = await asyncio.get_running_loop().run_in_executor(None, plan)
        if built is None:
            return Response(404, b"prefix not cached here\n")
        manifest, blobs = built
        chunk_specs = manifest["chunks"]
        if start > len(chunk_specs):
            return Response(
                422, f"chunk must be in [0, {len(chunk_specs)}]\n".encode()
            )
        from ..kvtier.handoff import encode_kv_manifest

        head = encode_kv_manifest(manifest)

        async def stream():
            yield head
            for spec in chunk_specs[start:]:
                yield blobs[spec["leaf"]][
                    spec["offset"]:spec["offset"] + spec["len"]
                ]

        return StreamingResponse(
            stream(), content_type="application/octet-stream"
        )

    async def _kv_pull(self, req: Request) -> Response:
        """``POST /v1/kv/pull {"tokens": [[...]], "from": "host:port"}``:
        fetch that prompt's KV entry from the named peer
        (digest-verified, one redial) and inject it host-side into the
        spill tier; the next request for the prompt readmits it through
        ``reuse_admission``. Any failure answers non-200 and caches
        nothing."""
        pc = self.prefix_cache
        if pc is None or pc.spill is None:
            return Response(
                409, b"kv pull needs --prefix-cache and --kv-spill\n"
            )
        try:
            body, row = self._one_row(req, "kv pull")
            peer = body.get("from", "")
            if not isinstance(peer, str) or ":" not in peer:
                raise ValueError("'from' must be \"host:port\"")
            address, _, port_raw = peer.rpartition(":")
            port = int(port_raw)
            if not address or not 0 < port < 65536:
                raise ValueError("'from' must be \"host:port\"")
        except (ValueError, KeyError, TypeError) as exc:
            return Response(422, f"{exc}\n".encode())
        from ..kvtier.handoff import fetch_kv

        # a drain-driven pull ("migrate": true) gets a trace of its own,
        # findable on this survivor's /v1/traces ring
        trace = (
            self._tracer.start(None, "kv_migrate")
            if body.get("migrate") else None
        )
        t0 = time.monotonic()
        fetched = await fetch_kv(address, port, row)
        if fetched is None:
            if trace is not None:
                trace.add_span("kv_migrate", t0, time.monotonic())
                trace.finish(502)
            return Response(502, b"kv fetch failed\n")
        host_tree, total_bytes = fetched
        # over ranks the whole entry reaches every rank (the op's
        # arguments) and each keeps its part
        adopted = await asyncio.get_running_loop().run_in_executor(
            None, self._device_call, "kv.adopt", tuple(row), host_tree
        )
        if trace is not None:
            trace.add_span("kv_migrate", t0, time.monotonic())
            trace.finish(200 if adopted else 507)
        if not adopted:
            return Response(507, b"kv entry refused (spill budget)\n")
        return Response(
            200,
            json.dumps({
                "ok": True, "bytes": int(total_bytes),
                "ms": round((time.monotonic() - t0) * 1e3, 3),
            }).encode(),
            content_type="application/json",
        )

    async def _migrate_verb(self, req: Request) -> Response:
        """``POST /v1/migrate``: with ``"targets"`` in the body, run an
        evacuation toward them (the operator's entry; a FleetMember's
        drain calls ``migrate_sessions`` directly); without, answer the
        progress report with the landed fp -> target map."""
        try:
            body = json.loads(req.body.decode() or "{}")
            if not isinstance(body, dict):
                raise ValueError("body must be a JSON object")
        except (ValueError, UnicodeDecodeError):
            return Response(422, b"body must be a JSON object\n")
        targets_raw = body.get("targets")
        if targets_raw is None:
            report = dict(self.migration)
            report["landed"] = {
                f"{fp:08x}": tid
                for fp, tid in self._migration_landed.items()
            }
            report["cumulative"] = dict(self._migration_counters)
            return Response(
                200, json.dumps(report).encode(),
                content_type="application/json",
            )
        if self.prefix_cache is None:
            return Response(409, b"migration needs --prefix-cache\n")
        if self.migration["active"]:
            return Response(409, b"migration already running\n")
        from ..kvtier.digest import parse_digest

        try:
            targets = []
            for t in targets_raw:
                _ver, fps = parse_digest(t.get("digest", ""))
                targets.append(
                    (str(t["id"]), str(t["address"]), int(t["port"]), fps)
                )
            window = float(body.get("window_s", 5.0))
        except (KeyError, TypeError, ValueError, AttributeError) as exc:
            return Response(422, f"targets malformed: {exc}\n".encode())
        authority = str(body.get("authority", "")) or (
            f"{self.host}:{self.port}"
        )
        summary = await self.migrate_sessions(
            targets, window_s=window, authority=authority
        )
        return Response(
            200, json.dumps(summary).encode(),
            content_type="application/json",
        )

    def _instrumented(self, endpoint: str, handler):
        """Count, time and trace every API request (adopting the
        caller's X-CP-Trace id when it is splice-safe); the handlers
        count their own post-trim tokens. Without a slot engine the
        ledger's prefill/decode authority is this handler window:
        ``decode`` while any compute request is in flight, flipped at
        the 0 <-> 1 boundaries only."""
        compute_endpoint = endpoint in ("generate", "completions",
                                        "score")

        async def wrapped(req: Request):
            inbound_id = tracing.safe_id(
                req.headers.get("x-cp-trace")
            ) or ""
            if (
                self.draining or self.role == "standby"
            ) and endpoint in ("generate", "completions"):
                # drain refuses NEW decode work only, and so does a
                # standby until promoted; the refusal still echoes the
                # trace id. A draining answer is migration-aware:
                # Retry-After follows the evacuation's progress, and once
                # this request's prefix landed on a survivor the header
                # names it
                self._m_requests.labels(endpoint, "503").inc()
                headers = {"Retry-After": "1"}
                if self.draining:
                    headers["Retry-After"] = self._drain_retry_after()
                    target = self._drain_migrated_to(req)
                    if target:
                        headers["X-CP-Migrated-To"] = target
                if inbound_id:
                    headers[tracing.TRACE_HEADER] = inbound_id
                body = b"draining\n" if self.draining else b"standby\n"
                return Response(503, body, headers=headers)
            trace = self._tracer.start(inbound_id or None, endpoint)
            trace.stream_id = tracing.current_stream_id()
            token = tracing.activate(trace)
            t0 = time.perf_counter()
            self._inflight += 1
            if (
                self.slot_engine is None and compute_endpoint
                and self._inflight == 1
            ):
                self.ledger.enter("decode")
            try:
                # the hook runs inside the inflight window: a request
                # parked in an injected delay must hold off a drain's
                # inflight==0 wait exactly like one inside the handler
                if self.chaos_hook is not None:
                    await self.chaos_hook(endpoint)
                resp = await handler(req)
            except Exception:
                # the HTTP layer answers 500; count and time it first
                trace.finish(500)
                self._m_latency.labels(endpoint).observe(
                    time.perf_counter() - t0
                )
                self._m_requests.labels(endpoint, "500").inc()
                raise
            finally:
                self._inflight -= 1
                if (
                    self.slot_engine is None and compute_endpoint
                    and self._inflight == 0
                ):
                    self.ledger.engine_idle()
                tracing.deactivate(token)
            resp.headers.setdefault(tracing.TRACE_HEADER, trace.trace_id)
            if not isinstance(resp, StreamingResponse):
                trace.finish(resp.status)
                resp.headers.setdefault(
                    tracing.DIGEST_HEADER, trace.digest()
                )
            # else: the stream owns the trace's tail (relay span, digest
            # in the final SSE event)
            self._m_latency.labels(endpoint).observe(
                time.perf_counter() - t0
            )
            self._m_requests.labels(endpoint, str(resp.status)).inc()
            return resp

        return wrapped

    async def _model_info(self, _req: Request) -> Response:
        lockstep = None
        if self.lockstep is not None:
            lockstep = await asyncio.get_running_loop().run_in_executor(
                None, self._lockstep_info)
        body = json.dumps({
            "vocab_size": self.cfg.vocab_size,
            "d_model": self.cfg.d_model,
            "n_heads": self.cfg.n_heads,
            "n_kv_heads": self.cfg.kv_heads,
            "n_layers": self.cfg.n_layers,
            "max_len": self.max_len,
            "checkpoint": self.checkpoint,
            "mesh": self._mesh_info(),
            "text": self.tokenizer is not None,
            "speculative": (
                {"draft_layers": self.draft_cfg.n_layers,
                 "speculate": self.speculate,
                 "engine": self.spec_engine.stats}
                if self.draft_cfg is not None else None
            ),
            "batching": {
                "max_batch_rows": self.max_batch_rows,
                "device_calls": self.batch_stats["calls"],
                "rows": self.batch_stats["rows"],
            },
            "prefix_cache": (
                {"entries": self.prefix_cache.entries,
                 **self.prefix_cache.stats}
                if self.prefix_cache is not None else None
            ),
            "prefix_digest": (
                self.prefix_cache.digest()
                if self.prefix_cache is not None else None
            ),
            "kv_spill": (
                self.prefix_cache.spill.snapshot()
                if self.prefix_cache is not None
                and self.prefix_cache.spill is not None else None
            ),
            "slot_engine": (
                self.slot_engine.stats
                if self.slot_engine is not None else None
            ),
            "stream": self.slot_engine is not None,
            "draining": self.draining,
            "cp": (
                {"seq": int(self.cp_mesh.shape["seq"]),
                 "min_len": self.cp_min_len}
                if self.cp_mesh is not None else None
            ),
            "device": str(self.device),
            "lockstep": lockstep,
        }).encode()
        return Response(200, body, content_type="application/json")

    def _mesh_info(self) -> Optional[Dict[str, int]]:
        """The mesh the params are sharded over (axis -> size), None when
        they are whole, as the reference derives it from the params'
        shardings: a mesh whose ``model`` axis is 1 holds whole params."""
        if self.mesh is None or self.mesh.axis_size("model") == 1:
            return None
        return {str(k): int(v) for k, v in self.mesh.shape.items()}

    def _lockstep_info(self) -> Dict[str, Any]:
        """Serving over ranks: the world, the backend, the slot engine's
        step-program mode and a fresh check of every rank (op count,
        token digest, K1/K2 launches, whether they agree)."""
        engine = self.slot_engine
        return {
            "ranks": self.lockstep.size,
            "backend": self.mesh.backend,
            "staging": self.mesh.staging,
            "step_program": (engine.program.mode
                             if engine is not None else None),
            "staged_bytes": self.mesh.traffic["host_bytes"],
            **self.lockstep.check(),
        }

    def _parse_sampling(
        self, body: Dict[str, Any], tokens: List[List[int]],
        prompt_len: int, default_eos: int = -1,
    ) -> Dict[str, Any]:
        """Validate the sampling/decode knobs (the reference's checks
        and messages). Raises ValueError for a 422."""
        p = {
            "max_new_requested": int(body.get("max_new_tokens", 16)),
            "temperature": float(body.get("temperature", 0.0)),
            "seed": int(body.get("seed", 0)),
            "top_k": int(body.get("top_k", 0)),
            "top_p": float(body.get("top_p", 0.0)),
            "eos_id": int(body.get("eos_id", default_eos)),
            "min_new": int(body.get("min_new_tokens", 0)),
            "presence": float(body.get("presence_penalty", 0.0)),
            "frequency": float(body.get("frequency_penalty", 0.0)),
            "stop": parse_stop_ids(body.get("stop"), self.cfg.vocab_size),
            "logit_bias": parse_logit_bias(
                body.get("logit_bias"), self.cfg.vocab_size
            ),
            "logprobs": bool(body.get("logprobs", False)),
            "beam_width": int(body.get("beam_width", 0)),
            "length_penalty": float(body.get("length_penalty", 0.0)),
        }
        if p["logit_bias"] and p["beam_width"]:
            raise ValueError("logit_bias does not apply to beam search")
        p["n"] = int(body.get("n", 1))
        if not 1 <= p["n"] <= self.max_batch_rows:
            raise ValueError(
                f"n must be in [1, --max-batch-rows {self.max_batch_rows}]"
            )
        if p["n"] > 1:
            if len(tokens) != 1:
                raise ValueError(
                    "n > 1 takes a single prompt row (it IS the row "
                    "multiplier)"
                )
            if p["beam_width"]:
                raise ValueError(
                    "n does not compose with beam search (beams already "
                    "return one best row)"
                )
        if p["beam_width"]:
            if p["temperature"] > 0.0 or p["top_k"] or p["top_p"]:
                raise ValueError(
                    "beam search is deterministic; drop "
                    "temperature/top_k/top_p"
                )
            validate_beam_args(self.cfg, len(tokens), p["beam_width"])
            if p["beam_width"] > self.max_batch_rows:
                # beams tile the KV cache: one request must not exceed
                # the server's device-row budget
                raise ValueError(
                    f"beam_width capped at --max-batch-rows "
                    f"({self.max_batch_rows})"
                )
        if (not 0 <= p["top_k"] <= self.cfg.vocab_size
                or not 0.0 <= p["top_p"] <= 1.0):
            raise ValueError(
                f"top_k must be in [0, vocab {self.cfg.vocab_size}] "
                "and top_p in [0, 1]"
            )
        if p["eos_id"] >= self.cfg.vocab_size:
            raise ValueError(f"eos_id must be < vocab {self.cfg.vocab_size}")
        if not 0 <= p["min_new"] <= max(p["max_new_requested"], 0):
            raise ValueError("min_new_tokens must be in [0, max_new_tokens]")
        if p["min_new"] and p["beam_width"]:
            raise ValueError("min_new_tokens does not apply to beam search")
        if not (abs(p["presence"]) <= 100 and abs(p["frequency"]) <= 100):
            raise ValueError(
                "presence/frequency penalties must be in [-100, 100]"
            )
        if (p["presence"] or p["frequency"]) and p["beam_width"]:
            raise ValueError("penalties do not apply to beam search")
        if prompt_len + p["max_new_requested"] > self.max_len:
            raise ValueError(
                f"prompt_len + max_new_tokens exceeds max_len {self.max_len}"
            )
        if p["max_new_requested"] < 1:
            raise ValueError("max_new_tokens must be >= 1")
        p["max_new"] = p["max_new_requested"]
        return p

    @staticmethod
    def _trim(
        generated: List[List[int]], max_new_requested: int, eos_id: int
    ) -> List[List[int]]:
        generated = [r[:max_new_requested] for r in generated]
        if eos_id >= 0:
            # each row ends at its first eos (inclusive)
            generated = [
                row[: row.index(eos_id) + 1] if eos_id in row else row
                for row in generated
            ]
        return generated

    @staticmethod
    def _trim_stops(
        generated: List[List[int]], stops: List[List[int]]
    ) -> List[List[int]]:
        """Cut each row at the earliest occurrence of any stop sequence,
        excluding the stop itself (the OpenAI convention)."""
        if not stops:
            return generated
        out = []
        for row in generated:
            cut = len(row)
            for stop in stops:
                n = len(stop)
                for i in range(0, min(cut, len(row) - n + 1)):
                    if row[i:i + n] == stop:
                        cut = min(cut, i)
                        break
            out.append(row[:cut])
        return out

    async def _generate(self, req: Request):
        try:
            body = json.loads(req.body.decode() or "{}")
            tokens, prompt_len = _parse_token_rows(
                body, self.cfg.vocab_size, min_row_len=1
            )
            p = self._parse_sampling(body, tokens, prompt_len)
            stream = bool(body.get("stream", False))
            if p["n"] > 1:
                if stream:
                    # the client sent ONE row; blame the actual conflict
                    raise ValueError(
                        "n does not compose with stream (one SSE "
                        "stream carries one row)"
                    )
                # one prompt, n samples; row i draws from (seed, i)
                tokens = [list(tokens[0]) for _ in range(p["n"])]
            if stream:
                if len(tokens) != 1:
                    raise ValueError("stream serves a single row per "
                                     "request")
                return self._stream_response(tokens[0], p)
        except (ValueError, KeyError, TypeError) as exc:
            return Response(422, f"{exc}\n".encode())
        generated = await self._dispatch_generate(tokens, prompt_len, p)
        generated = self._trim(generated, p["max_new_requested"], p["eos_id"])
        generated = self._trim_stops(generated, p["stop"])
        self._m_tokens.inc(sum(len(r) for r in generated))
        payload: Dict[str, Any] = {"tokens": generated}
        if p["logprobs"]:
            payload["logprobs"] = await asyncio.get_running_loop(
            ).run_in_executor(
                self._executor, self._echo_logprobs, tokens, generated
            )
        return Response(
            200, json.dumps(payload).encode(),
            content_type="application/json",
        )

    async def _completions(self, req: Request) -> Response:
        """Text in/out over the byte-level tokenizer: encode the prompt,
        run the same dispatch as /v1/generate, decode the generated ids.
        eos defaults to the tokenizer's EOS ("eos_id": -1 disables it);
        "stop" takes strings, byte-encoded into token stop sequences and
        excluded from the output."""
        try:
            body = json.loads(req.body.decode() or "{}")
            prompt = body.get("prompt")
            if not isinstance(prompt, str) or not prompt:
                raise ValueError("'prompt' must be a non-empty string")
            row = self.tokenizer.encode(prompt)
            if len(row) >= self.max_len:
                raise ValueError(
                    f"prompt encodes to {len(row)} ids; max_len is "
                    f"{self.max_len}"
                )
            stop_raw = parse_stop_strings(body.pop("stop", None))
            if stop_raw is not None:
                body["stop"] = [self.tokenizer.encode(s, bos=False)
                                for s in stop_raw]
            p = self._parse_sampling(
                body, [row], len(row), default_eos=self.tokenizer.EOS
            )
            if p["n"] > 1:
                raise ValueError("n returns token rows; use /v1/generate")
            if bool(body.get("stream", False)):
                return self._completions_stream(row, p)
        except (ValueError, KeyError, TypeError) as exc:
            return Response(422, f"{exc}\n".encode())
        generated = await self._dispatch_generate([row], len(row), p)
        generated = self._trim(generated, p["max_new_requested"], p["eos_id"])
        generated = self._trim_stops(generated, p["stop"])
        self._m_tokens.inc(len(generated[0]))
        return Response(
            200,
            json.dumps({"text": self.tokenizer.decode(generated[0]),
                        "tokens": generated[0]}).encode(),
            content_type="application/json",
        )

    def _completions_stream(
        self, row: List[int], p: Dict[str, Any]
    ) -> StreamingResponse:
        """Text SSE over the same plumbing: each event carries the
        delta's ids and the text they decode to, holding back a partial
        UTF-8 character (text.stream_decoder); the events' text
        concatenates to the non-streamed ``text``."""
        from .text import stream_decoder

        delta_event, tail_events = stream_decoder(self.tokenizer)
        return self._stream_response(row, p, delta_event=delta_event,
                                     tail_events=tail_events)

    def _stream_response(
        self, row: List[int], p: Dict[str, Any], delta_event=None,
        tail_events=None,
    ) -> StreamingResponse:
        """SSE token streaming over the slot engine's window boundaries:
        each emitted delta is one ``data:`` event (shaped by
        ``delta_event``; ``tail_events`` may add events before the last)
        and the last event carries ``done``, the trace id and the span
        digest; the deltas concatenate to the non-streamed row. The
        engine's worker thread hands deltas to the event loop with
        ``call_soon_threadsafe``. A client disconnect sets the request's
        cancel, and the engine frees the slot at the next window
        boundary instead of decoding to the end."""
        if self.slot_engine is None:
            raise ValueError(
                "stream requires --slots (token streaming rides the "
                "slot engine's chunk boundaries)"
            )
        for knob, why in (
            ("logprobs", "echo logprobs need the full row"),
            ("beam_width", "beams have no incremental prefix"),
            ("stop", "stop sequences need whole-row trimming"),
        ):
            if p[knob]:
                raise ValueError(
                    f"stream does not compose with {knob} ({why})"
                )
        if delta_event is None:
            delta_event = lambda d: {"tokens": d}  # noqa: E731
        if tail_events is None:
            tail_events = list
        loop = asyncio.get_running_loop()
        deltas: "asyncio.Queue" = asyncio.Queue()
        finished = object()
        cancel = threading.Event()

        def on_tokens(delta: List[int]) -> None:  # the engine's thread
            loop.call_soon_threadsafe(deltas.put_nowait, delta)

        # the relay outlives the handler's contextvar window, so the
        # stream holds its trace directly
        trace = tracing.current_trace()
        timings: Optional[Dict[str, float]] = (
            {} if trace is not None else None
        )
        fut = self.slot_engine.submit(
            row, p["max_new_requested"],
            temperature=p["temperature"], top_k=p["top_k"],
            top_p=p["top_p"], eos_id=p["eos_id"], seed=p["seed"],
            min_new=p["min_new"], presence_penalty=p["presence"],
            frequency_penalty=p["frequency"], logit_bias=p["logit_bias"],
            on_tokens=on_tokens, cancel=cancel, timings=timings,
        )
        fut.add_done_callback(
            lambda _f: loop.call_soon_threadsafe(deltas.put_nowait, finished)
        )
        sent = [0]
        closed = [False]
        first_delta_at = [0.0]

        def finish() -> None:
            # any end: completion, a disconnect mid-stream (generator
            # finally) or before the generator started (close callback);
            # idempotent
            if closed[0]:
                return
            closed[0] = True
            cancel.set()
            self._m_tokens.inc(sent[0])
            if trace is not None:
                tracing.add_engine_spans(trace, timings)
                if first_delta_at[0]:
                    trace.add_span("stream_relay", first_delta_at[0],
                                   tracing.now(), events=sent[0])
                trace.finish(200)

        def sse(payload: Dict[str, Any]) -> bytes:
            return b"data: " + json.dumps(payload).encode() + b"\n\n"

        async def events():
            try:
                while True:
                    delta = await deltas.get()
                    if delta is finished:
                        break
                    if trace is not None and not first_delta_at[0]:
                        first_delta_at[0] = tracing.now()
                    sent[0] += len(delta)
                    yield sse(delta_event(delta))
                for extra in tail_events():
                    yield sse(extra)
                done: Dict[str, Any] = {"done": True, "count": sent[0]}
                if trace is not None:
                    # the final event is the stream's digest channel
                    finish()
                    done["trace"] = trace.trace_id
                    done["spans"] = trace.digest()
                yield sse(done)
            finally:
                finish()

        return StreamingResponse(events(), close=finish)

    def _echo_logprobs(
        self, prompts: List[List[int]], generated: List[List[int]]
    ) -> List[List[float]]:
        """Per-token logprobs of the TRIMMED generated ids, from one
        teacher-forced pass over prompt + generated (runs on the
        inference thread). Rows pad to the longest with zeros: causal
        attention leaves the real positions unchanged. With
        ``--kv-int8`` the echo is approximate: the scorer reads full
        precision k/v where decode read the quantized cache."""
        rows = [q + g for q, g in zip(prompts, generated)]
        width = max(len(r) for r in rows)
        padded = [r + [0] * (width - len(r)) for r in rows]
        picked = self._device_call("score", padded)
        out: List[List[float]] = []
        for row_lp, prompt, gen in zip(picked, prompts, generated):
            # lp[i] scores token i + 1; generated token j sits at
            # len(prompt) + j
            start = len(prompt) - 1
            out.append([round(float(x), 6)
                        for x in row_lp[start:start + len(gen)]])
        return out

    async def _score(self, req: Request) -> Response:
        """Teacher-forced per-token logprobs of the given sequences (no
        sampling)."""
        try:
            body = json.loads(req.body.decode() or "{}")
            tokens, row_len = _parse_token_rows(
                body, self.cfg.vocab_size, min_row_len=2
            )
            if row_len > self.max_len:
                raise ValueError(f"row length exceeds max_len {self.max_len}")
        except (ValueError, KeyError, TypeError) as exc:
            return Response(422, f"{exc}\n".encode())

        picked = await asyncio.get_running_loop().run_in_executor(
            self._executor, self._device_call, "score", tokens
        )
        return Response(
            200,
            json.dumps({
                "logprobs": [[round(float(x), 6) for x in row]
                             for row in picked],
                "sums": [round(float(row.sum()), 6) for row in picked],
            }).encode(),
            content_type="application/json",
        )

    @staticmethod
    async def _timed_compute(trace, awaitable):
        """One coarse ``compute`` span around a non-slot decode path
        (slot-engine requests get slot_queue_wait/prefill/decode)."""
        if trace is None:
            return await awaitable
        t0 = tracing.now()
        try:
            return await awaitable
        finally:
            trace.add_span("compute", t0, tracing.now())

    async def _engine_generate(self, engine, trace, row, max_new, **kw):
        """One row through a slot engine; its boundary stamps become the
        trace's slot_queue_wait/prefill/decode spans, once, after the
        future resolves."""
        timings: Optional[Dict[str, float]] = (
            {} if trace is not None else None
        )
        fut = engine.submit(row, max_new, timings=timings, **kw)
        out = [await asyncio.wrap_future(fut)]
        if trace is not None:
            tracing.add_engine_spans(trace, timings)
        return out

    async def _dispatch_generate(
        self, tokens: List[List[int]], prompt_len: int, p: Dict[str, Any]
    ) -> List[List[int]]:
        """Route a validated request to its decode strategy (the
        reference's order: beams, the speculative engine, the slot
        engine, prefix hit, chunked prefill, batcher) -> the untrimmed
        generated rows."""
        loop = asyncio.get_running_loop()
        trace = tracing.current_trace()
        timed = self._timed_compute
        single = len(tokens) == 1
        if p["beam_width"]:
            return await timed(trace, loop.run_in_executor(
                self._executor, self._device_call, "beam", tokens,
                p["max_new_requested"], p["beam_width"], p["eos_id"],
                p["length_penalty"],
            ))
        if (
            self.spec_engine is not None
            and p["temperature"] <= 0.0
            and p["min_new"] == 0
            and not p["presence"] and not p["frequency"]
            and not p["logit_bias"]
            and single
        ):
            # greedy single row: draft-and-verify through the speculative
            # engine, whose emission is eos-capped at the exact max_new
            return await self._engine_generate(
                self.spec_engine, trace, tokens[0], p["max_new_requested"],
                eos_id=p["eos_id"], seed=p["seed"],
            )
        if self.slot_engine is not None and single:
            # joins the running chunk loop at the next boundary; output
            # is already pad-trimmed at eos
            return await self._engine_generate(
                self.slot_engine, trace, tokens[0], p["max_new_requested"],
                temperature=p["temperature"], top_k=p["top_k"],
                top_p=p["top_p"], eos_id=p["eos_id"], seed=p["seed"],
                min_new=p["min_new"], presence_penalty=p["presence"],
                frequency_penalty=p["frequency"],
                logit_bias=p["logit_bias"],
            )
        if (
            self.cp_mesh is not None
            and single
            and prompt_len >= self.cp_min_len
        ):
            # long prompt: the prefill, the quadratic part, rings over the
            # seq axis; decode runs the normal loop
            return await timed(trace, loop.run_in_executor(
                self._executor, self._device_call, "cp", tokens, p,
            ))
        if (
            self.prefix_cache is not None
            and single
            and (
                self.prefix_cache.match_len(tokens[0]) >= MIN_REUSE
                or self._batcher.idle()
            )
        ):
            # hit -> reuse; miss -> still seed the cache, but only when
            # nothing is queued for the batcher
            return await timed(trace, loop.run_in_executor(
                self._executor, self._device_call, "prefix", tokens[0],
                p["max_new"], p["temperature"], p["top_k"], p["top_p"],
                p["eos_id"], p["seed"], p["min_new"], p["presence"],
                p["frequency"], p["logit_bias"],
            ))
        if self.prefill_chunk > 0 and single and (
                prompt_len > self.prefill_chunk):
            return await timed(trace, loop.run_in_executor(
                self._executor, self._device_call, "chunked",
                tokens, prompt_len, p["max_new"], p["temperature"],
                p["top_k"], p["top_p"], p["eos_id"], p["seed"],
                p["min_new"], p["presence"], p["frequency"],
                p["logit_bias"],
            ))
        job = GenJob(
            rows=tokens, prompt_len=prompt_len, max_new=p["max_new"],
            temperature=p["temperature"], top_k=p["top_k"],
            top_p=p["top_p"], eos_id=p["eos_id"], seed=p["seed"],
            min_new=p["min_new"], presence=p["presence"],
            frequency=p["frequency"], logit_bias=p["logit_bias"],
            future=loop.create_future(),
        )
        return await timed(trace, self._batcher.submit(job))

    # -- lifecycle ------------------------------------------------------

    def _warm(self) -> None:
        if self.device.type == "cuda":
            # build both kernels now, not under the first live request
            from ..ops import _build
            from .modelcfg import compile_cache_note

            seconds = _build.build_all()
            log.info("serve: CUDA kernels ready in %.1fs (%s)", seconds,
                     _build.build_dir())
            self._compile_cache_note = compile_cache_note(
                _build.build_dir())
        # with a draft, every draft/verify round shape too, before /health
        self._device_call("warm")
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    async def warmup(self) -> None:
        """Build the kernels and run the default-shaped requests once
        before reporting healthy; with a slot engine, one request through
        it (admission, a chunk and, with windows, a fused window: chunk+2
        new tokens leave one token past the admission round) on graphs
        captured when the engine was built; with a draft, every
        speculative round shape and one request through its engine.
        The ledger attributes all of it to ``compile_warmup`` (an
        override the engine's own stamps cannot claim) and opens the
        serving clock in ``idle`` before ``/health`` turns 200."""
        self.ledger.set_override("compile_warmup")
        # chaos seam: an injected slow boot parks HERE, inside the
        # compile_warmup attribution window (the fault the standby pool
        # exists to mask)
        if self.chaos_hook is not None:
            await self.chaos_hook("warmup")
        await asyncio.get_running_loop().run_in_executor(
            self._executor, self._warm
        )
        engine = self.slot_engine
        if engine is not None:
            warm_new = engine.chunk + (2 if engine.window > 1 else 1)
            fut = engine.submit([0] * WARMUP_PROMPT_LEN, max_new=warm_new)
            await asyncio.wrap_future(fut)
        if self.spec_engine is not None:
            spec_new = min(self.speculate + 2,
                           self.max_len - WARMUP_PROMPT_LEN)
            if spec_new >= 1:
                fut = self.spec_engine.submit([0] * WARMUP_PROMPT_LEN,
                                              max_new=spec_new)
                await asyncio.wrap_future(fut)
        self.ledger.clear_override()
        self.ledger.enter("idle")
        self.ready = True
        self.ready_at = time.monotonic()
        log.info("serve: default shapes warm; %s",
                 "standing by" if self.role == "standby"
                 else "accepting traffic")

    async def run(self) -> None:
        await self._server.start_tcp(self.host, self.port)
        self.port = self._server.bound_port or self.port
        self._batcher.start()
        self._loop_probe.start()
        log.info("serve: listening on %s:%d", self.host, self.port)
        await self.warmup()

    def goodput_note(self) -> str:
        """The device-time ledger's heartbeat field value (``gp=``):
        cumulative stage seconds, then dispatches and tokens out."""
        dispatches, tokens_out = self._decode_counters()
        return self.ledger.note(dispatches, tokens_out)

    # -- the fleet member's surface (fleet/member.py, fleet/notes.py) ---

    @property
    def inflight(self) -> int:
        """Requests still being served: handler-held requests plus
        slot-engine rows still decoding or queued (a drain waits for
        zero)."""
        n = self._inflight
        for engine in (self.slot_engine, self.spec_engine):
            if engine is not None:
                stats = engine.stats
                n += stats["active"] + stats["queued"]
        return n

    @property
    def occupancy(self) -> float:
        """Decode capacity in use, the ``occ=`` field: (active + queued
        slot-engine rows) / slots, past 1.0 when over-subscribed; without
        a slot engine, the handler count."""
        if self.slot_engine is not None:
            stats = self.slot_engine.stats
            return (stats["active"] + stats["queued"]) / max(
                1, stats["slots"]
            )
        return float(self._inflight)

    def kv_note(self) -> str:
        """The ``kv=`` field's value: the prefix cache's reuse counters
        ``hits,misses,tokens_reused,spilled,readmitted``; empty without
        a prefix cache."""
        pc = self.prefix_cache
        if pc is None:
            return ""
        s = pc.stats
        return (
            f"{s['hits']},{s['misses']},{s['tokens_reused']},"
            f"{s['spilled']},{s['readmitted']}"
        )

    def compile_cache_note(self) -> str:
        """The ``cc=`` field's value: the kernel build directory and a
        digest of its libraries, so a same-host launch adopts it and
        skips nvcc; empty on the CPU (no kernel built)."""
        return self._compile_cache_note

    def prefix_digest_note(self) -> str:
        """The ``pd=`` field's value: the prefix fingerprint digest;
        empty without a prefix cache."""
        pc = self.prefix_cache
        return "" if pc is None else pc.digest() or ""

    # -- drain migration --------------------------------------------------

    async def migrate_sessions(
        self,
        targets: List[Any],
        window_s: float = 5.0,
        authority: str = "",
    ) -> Dict[str, Any]:
        """Evacuate this replica's cached prefixes to the survivors
        before a drain deregisters it: plan deterministically
        (kvtier.plan_migration), then push each cold entry inside the
        window by POSTing a pull instruction at its target (the target
        fetches from ``authority``, this replica's advertised host:port,
        and adopts through the same ``reuse_admission`` path). A dead
        target or poisoned chunk bumps ``failed``, window expiry bumps
        ``timeout`` for each unpushed entry, and the drain proceeds
        regardless.

        ``targets`` are ``(instance_id, address, port, fingerprint_set)``
        tuples. Returns the migration summary."""
        pc = self.prefix_cache
        m = self.migration
        if pc is None or not targets or m["active"]:
            return dict(m)
        from ..kvtier.handoff import plan_migration, push_kv

        keys = await asyncio.get_running_loop().run_in_executor(
            None, pc.export_keys
        )
        plan = plan_migration(keys, [(t[0], t[3]) for t in targets])
        addr = {t[0]: (t[1], int(t[2])) for t in targets}
        m.update(
            active=True, total=len(plan), done=0, failed=0, timeout=0,
            window_s=float(window_s), started_at=time.monotonic(),
        )
        self._migration_counters["total"] += len(plan)
        deadline = m["started_at"] + max(0.0, float(window_s))
        bytes_moved = 0
        try:
            for entry in plan:
                if time.monotonic() >= deadline:
                    left = m["total"] - m["done"] - m["failed"]
                    m["timeout"] += left
                    self._migration_counters["timeout"] += left
                    log.warning(
                        "serve: migrate window expired with %d entries "
                        "unmoved", left,
                    )
                    break
                if entry["warm"]:
                    # already warm on the survivor: landed with zero
                    # bytes moved, but the pin still repoints
                    m["done"] += 1
                    self._migration_counters["done"] += 1
                    self._record_landing(entry["fp"], entry["target"])
                    continue
                host, port = addr[entry["target"]]
                got = await push_kv(
                    host, port, list(entry["key"]), authority,
                    read_timeout=max(1.0, deadline - time.monotonic()),
                )
                if got is None:
                    m["failed"] += 1
                    self._migration_counters["failed"] += 1
                else:
                    bytes_moved += got
                    m["done"] += 1
                    self._migration_counters["done"] += 1
                    self._record_landing(entry["fp"], entry["target"])
        finally:
            m["active"] = False
        summary = dict(m)
        summary["bytes"] = bytes_moved
        log.info(
            "serve: migration moved %d/%d entries (%d bytes, %d failed, "
            "%d timed out)", m["done"], m["total"], bytes_moved,
            m["failed"], m["timeout"],
        )
        return summary

    def _record_landing(self, fp: int, target: str) -> None:
        landed = self._migration_landed
        landed[fp] = target
        landed.move_to_end(fp)
        while len(landed) > 256:
            landed.popitem(last=False)

    def migrate_note(self) -> str:
        """The ``mg=`` field's value: cumulative migration counters and
        the most recent fp -> target landings; empty until a migration
        has ever run."""
        c = self._migration_counters
        if not c["total"] and not self.migration["active"]:
            return ""
        from ..kvtier.digest import encode_migration_note

        landed = list(self._migration_landed.items())
        landed.reverse()  # most recent first survives truncation
        return encode_migration_note(
            c["done"], c["total"], c["failed"], c["timeout"],
            bool(self.migration["active"]), landed,
        )

    def _drain_retry_after(self) -> str:
        """Retry-After for a drain 503: the observed per-entry pace of
        the migration extrapolated over what is left, capped by the
        remaining window."""
        m = self.migration
        if not m["active"] or m["total"] <= 0:
            return "1"
        elapsed = max(0.0, time.monotonic() - m["started_at"])
        settled = m["done"] + m["failed"]
        if settled <= 0:
            remaining = float(m["window_s"])
        else:
            remaining = elapsed * (m["total"] - settled) / settled
        remaining = min(remaining, max(0.0, float(m["window_s"]) - elapsed))
        return str(max(1, min(30, int(remaining + 0.999))))

    def _drain_migrated_to(self, req: Request) -> str:
        """The survivor this refused request's prefix has landed on, or
        "" (any unparseable body simply gets no header)."""
        if not self._migration_landed:
            return ""
        from ..kvtier.digest import prefix_fingerprint

        try:
            body = json.loads(req.body.decode() or "{}")
            rows = body.get("tokens")
            if (isinstance(rows, list) and rows
                    and isinstance(rows[0], list)):
                row = [int(t) for t in rows[0]]
            elif (self.tokenizer is not None
                  and isinstance(body.get("prompt"), str)):
                row = self.tokenizer.encode(body["prompt"])
            else:
                return ""
            fp = prefix_fingerprint(row)
        except (ValueError, TypeError, AttributeError,
                UnicodeDecodeError):
            return ""
        if fp is None:
            return ""
        return self._migration_landed.get(fp, "")

    def enter_maintenance(self) -> None:
        """Start draining: /health 503, new generate/completions 503 +
        Retry-After, in-flight work finishes; the ledger costs every
        second from here as ``drain``. Idempotent."""
        if not self.draining:
            log.info("serve: entering maintenance (draining)")
            self.ledger.set_override("drain")
        self.draining = True

    def exit_maintenance(self) -> None:
        """Stop draining and accept traffic again. Idempotent."""
        if self.draining:
            log.info("serve: exiting maintenance")
            self.ledger.clear_override()
        self.draining = False

    async def stop(self) -> None:
        self.ledger.freeze()
        self._loop_probe.stop()
        for engine in (self.slot_engine, self.spec_engine):
            if engine is not None:
                await asyncio.get_running_loop().run_in_executor(
                    None, engine.stop
                )
        await self._batcher.stop()
        await self._server.stop()
        self._executor.shutdown(wait=True)
        if self.lockstep is not None:
            # the followers' last op: they leave their loop and exit
            self.lockstep.shutdown()

    async def abort(self) -> None:
        """Test-only (the chaos harness): die like SIGKILL. The listener
        and every live connection drop FIRST (in-flight clients see
        resets, exactly as if the process vanished), and only then are
        the decode threads reaped so the test process doesn't leak them.
        No drain, no deregistration: a FleetMember's catalog record is
        left to decay critical by TTL expiry, the crash signature
        gateways must route around."""
        self.ready = False
        self.ledger.freeze()
        self._loop_probe.stop()
        await self._server.abort()
        await self._batcher.stop()
        for engine in (self.slot_engine, self.spec_engine):
            if engine is not None:
                await asyncio.get_running_loop().run_in_executor(
                    None, engine.stop
                )
        self._executor.shutdown(wait=False)
        if self.lockstep is not None:
            self.lockstep.shutdown()


class ServingFollower:
    """A follower rank of a server over ranks (parallel/serving.py): the
    front's device ops on this rank's blocks, no HTTP surface, no queue.
    Built with the front's arguments, so its slot and speculative
    engines' step programs have the front's shapes and its prefix cache
    (with its spill tier, a rank's budget) the front's keys; ``run``
    follows the front's ops until it shuts down."""

    def __init__(self, cfg: TransformerConfig, params: Any, max_len: int,
                 mesh: Any, lockstep: Any, cp_mesh: Any = None,
                 cp_min_len: int = 0, prefill_chunk: int = 0,
                 slots: int = 0, slot_chunk: int = 8,
                 slot_window: int = 4, draft_layers: int = 0,
                 speculate: int = 4, prefix_cache_entries: int = 0,
                 kv_spill_bytes: int = 0) -> None:
        self.cfg, self.params, self.max_len = cfg, params, max_len
        self.mesh, self.lockstep = mesh, lockstep
        self.device = params["norm_out"].device
        self.prefill_chunk = prefill_chunk
        self.batch_stats = {"calls": 0, "rows": 0}
        self.cp_mesh = cp_mesh
        self.cp_min_len = cp_min_len
        if cp_mesh is not None:
            self.cp_min_len = resolve_cp(cp_mesh, cp_min_len, max_len, cfg,
                                         draft_layers, prefix_cache_entries)
        self._score_fn = score_logprobs_fn(cfg, mesh)
        self.prefix_cache = make_prefix_cache(
            prefix_cache_entries, kv_spill_bytes, self.device, lockstep)
        self.slot_engine = None
        if slots > 0:
            from .serve_slots import SlotEngine

            self.slot_engine = SlotEngine(
                cfg, params, max_len, slots=slots, chunk=slot_chunk,
                window=slot_window_for(max_len, slot_chunk, slot_window),
                prefill_chunk=prefill_chunk, cp_mesh=cp_mesh,
                cp_min_len=self.cp_min_len, prefix_cache=self.prefix_cache,
                mesh=mesh, lockstep=lockstep, worker=False,
            )
        self.draft_params = self.draft_cfg = None
        self.speculate = speculate
        self.spec_engine = (
            make_spec_engine(self, draft_layers, prefill_chunk,
                             worker=False)
            if draft_layers > 0 else None
        )
        lockstep.register(serving_ops(self))

    def run(self) -> int:
        with torch.inference_mode():
            return self.lockstep.follow()


if __name__ == "__main__":
    main()
