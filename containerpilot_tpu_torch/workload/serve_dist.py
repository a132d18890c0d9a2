"""The pod server: one HTTP frontend, a slot-pool decode spanning the
pod's ranks (counterpart of ``containerpilot_tpu/workload/serve_dist.py``).

Every process joins the pod through the supervisor's catalog
(``parallel.distributed.initialize_from_catalog``, the rendezvous the
training capstone uses), holds its blocks of the params on a mesh of
ranks (``--dp`` x ``--sp`` x the model axis) and runs the SAME
continuous-batching slot engine the single-host server runs
(``models/slots.py`` behind ``models/stepprog.py``), in lockstep: a
fixed pool of ``--slots`` rows decodes in ``--stream-chunk``-token
chunk rounds, and between rounds process 0 (the frontend) broadcasts
one round payload (``_payload_zeros``: this round's admission, at most
one request row with its knobs, the per-slot done mask, whether and how
far to decode). Every process replays it (``_SlotMirror``); process 0
alone keeps the HTTP bookkeeping (emitted tokens, retirement, SSE
deltas). Requests JOIN a running decode at the next chunk boundary.

The broadcast is the port's lockstep op channel
(``parallel/serving.py``): the reference's ``OP_ROUND``, ``OP_SCORE``,
``OP_BEAM`` and ``OP_SPEC`` are the registered ops ``round``, ``score``,
``beam`` and ``spec``, each taking the payload dict; its idle
``OP_HEARTBEAT`` is the channel's ``check`` op (``start_checks``, every
quarter of ``--watchdog`` while idle), and ``OP_SHUTDOWN`` is
``Lockstep.shutdown``. Ops run one at a time under the channel's lock,
so a one-shot score, beam or speculative op runs between chunk rounds,
never beside them, and every rank calls every collective in the same
order.

Frontend surface (process 0): ``/health``, ``/metrics``, ``/v1/model``,
``/v1/traces``, ``/v1/goodput``, ``POST /v1/generate`` (token rows;
``n``, ``stop``, ``logprobs``, ``beam_width``, ``stream``), ``POST
/v1/score`` and, behind ``--text``, ``POST /v1/completions``.
Followers have no HTTP surface.

Request sampling keeps the single-host server's key convention (row i of
a request draws from ``fold_in(PRNGKey(seed), i)``), so answers equal a
single-host server's of the same config, in either package.

Failure detection (``--watchdog``): every rank's lockstep watchdog beats
at the end of every op; the idle ``check`` op bounds every rank's cycle,
so a follower that wedges (``--wedge-file`` injects one) or dies stalls
the next op pod-wide and every rank exits 86 (``parallel.watchdog
.EXIT_CODE``) for its supervisor to restart, within the deadline (over
NCCL, before the process group's own 300 s timeout). SIGTERM on process
0 shuts the whole pod down; followers keep the default SIGTERM
disposition.

Intended differences from the reference:

- Pool layout: the reference pins its pool to full replication, because
  GSPMD layouts drift between programs. Here each rank's pool holds its
  kv heads (``cache_kv_heads``), as the slot engine under a mesh does;
  the logits are gathered whole before sampling, so every rank samples
  the same tokens.
- ``--catalog`` takes the reference's Consul address, and also
  ``file:DIR`` (``discovery.factory.new_backend``), so a pod can
  rendezvous on a file catalog without a catalog server.
- The lockstep always has a deadline: ``--watchdog 0`` means the
  channel's default (``serving.DEFAULT_DEADLINE_S``), not none.
- Ranks sharing one card run their collectives over gloo, ranks with a
  card each over NCCL (``distributed._backend_for``); a round whose
  model axis calls collectives runs ``uncaptured``
  (``stepprog.step_program_mode``), as under ``serve --tp``.
- The warm-up invariant: where the reference counts XLA compiles, the
  port counts what it does on first use: a step program's capture, a
  kernel library's build or load, and the first dispatch of a device
  program shape (``_SlotMirror.first_use``, where library plans and
  the allocator's blocks are made). After ``warm_pod`` a request at the
  warmed shapes adds none of them.

    python -m containerpilot_tpu_torch.workload.serve_dist \\
        --process-id 0 --num-processes 2 --catalog file:/shared/cat \\
        --port 8000 --d-model 1024 ...
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import queue
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..models.decode import BIAS_SLOTS_MAX
from ..parallel.watchdog import EXIT_CODE

log = logging.getLogger("containerpilot.serve_dist")

# the lockstep ops of the pod, each taking one _payload_zeros dict
OP_ROUND = "round"  # slot-engine round: optional admission + one chunk
OP_SCORE = "score"  # teacher-forced logprobs over the broadcast row
OP_BEAM = "beam"    # one-shot lockstep beam search
OP_SPEC = "spec"    # one-shot lockstep speculative (draft-and-verify)

WATCHDOG_EXIT = EXIT_CODE

# the warm-up admission's prompt length
WARM_PLEN = 4


def _payload_zeros(max_len: int, slots: int) -> Dict[str, np.ndarray]:
    """The ONE payload structure every op carries (score, beam, spec and
    slot rounds all ship this shape)."""
    return {
        # the single row an op can carry: a score/beam request's tokens,
        # or this round's admission prompt
        "prompt": np.zeros((max_len,), np.int32),
        "plen": np.zeros((), np.int32),
        # admission (admit_slot -1 = none this round); row_idx is the
        # row's index within its request: the key schedule
        # fold_in(PRNGKey(seed), row_idx) is the server convention
        "admit_slot": np.full((), -1, np.int32),
        "row_idx": np.zeros((), np.int32),
        "max_new_req": np.zeros((), np.int32),
        "temperature": np.zeros((), np.float32),
        "top_k": np.zeros((), np.int32),
        "top_p": np.zeros((), np.float32),
        "eos_id": np.full((), -1, np.int32),
        "seed": np.zeros((), np.int32),
        "min_new": np.zeros((), np.int32),
        "presence": np.zeros((), np.float32),
        "frequency": np.zeros((), np.float32),
        "bias_idx": np.full((BIAS_SLOTS_MAX,), -1, np.int32),
        "bias_val": np.zeros((BIAS_SLOTS_MAX,), np.float32),
        # beam operands
        "beam_width": np.zeros((), np.int32),
        "length_penalty": np.zeros((), np.float32),
        # chunk control: run a chunk this round, with this pre-chunk
        # done mask (1 = the slot is dead; evicted slots flip to 1)
        "run_chunk": np.zeros((), np.int32),
        "done": np.ones((slots,), np.int32),
        # fused decode: up to this many chunk-rounds in one dispatch
        # (early exit when every slot is done or out of ``budget``);
        # 1 = one chunk. Only pure-decode rounds are fused.
        "rounds": np.ones((), np.int32),
        "budget": np.zeros((slots,), np.int32),
    }


def _fill_admission(payload, work: Dict[str, Any], row_idx: int,
                    slot: int) -> None:
    """Pack one request row's admission into the round payload."""
    tokens = work["tokens"]
    payload["prompt"][: len(tokens)] = np.asarray(tokens, np.int32)
    payload["plen"] = np.asarray(len(tokens), np.int32)
    payload["admit_slot"] = np.asarray(slot, np.int32)
    payload["row_idx"] = np.asarray(row_idx, np.int32)
    payload["max_new_req"] = np.asarray(work["max_new"], np.int32)
    payload["temperature"] = np.asarray(work["temperature"], np.float32)
    payload["top_k"] = np.asarray(work["top_k"], np.int32)
    payload["top_p"] = np.asarray(work["top_p"], np.float32)
    payload["eos_id"] = np.asarray(work["eos_id"], np.int32)
    payload["seed"] = np.asarray(work["seed"], np.int32)
    payload["min_new"] = np.asarray(work["min_new"], np.int32)
    payload["presence"] = np.asarray(work["presence"], np.float32)
    payload["frequency"] = np.asarray(work["frequency"], np.float32)
    # parse_logit_bias caps at BIAS_SLOTS_MAX; the slice is a bound that
    # can never raise inside the pod loop
    items = sorted((work.get("logit_bias") or {}).items())[:BIAS_SLOTS_MAX]
    for j, (tok_id, bias) in enumerate(items):
        payload["bias_idx"][j] = tok_id
        payload["bias_val"][j] = bias


@dataclass
class _Admission:
    """What the step program reads of an admitted row."""

    seed: int
    row: int
    max_new: int
    temperature: float
    top_k: int
    top_p: float
    eos_id: int
    min_new: int
    presence: float
    frequency: float
    bias_idx: np.ndarray
    bias_val: np.ndarray
    pad_id: int = 0  # the server's pad


class _SlotMirror:
    """The device half of the slot engine, replayed identically on every
    rank: a step program (the pool of ``slots`` cache rows with this
    rank's kv heads, the per-slot sampling state, the window buffers)
    whose every mutation is driven by broadcast round payloads, so the
    ranks hold matching state without exchanging it.

    ``mesh``: the pod's mesh (None: one rank). ``sp`` > 1: prompts at
    least ``cp_min_len`` long ring a head bucket (``cp_head_buckets``)
    over the ``seq`` axis and extend the remainder. ``prefix_entries``
    > 0: every rank keeps an identical prefix cache, changed only by
    broadcast admissions. ``prefill_chunk``: admissions longer than it
    prefill in pieces. ``window``: the fused window's K."""

    def __init__(self, cfg, params, max_len: int, slots: int,
                 chunk: int, mesh=None, sp: int = 1,
                 cp_min_len: int = 0, prefix_entries: int = 0,
                 prefill_chunk: int = 0, window: int = 1) -> None:
        from ..models.stepprog import make_step_program
        from ..parallel.context import cp_head_buckets
        from .modelcfg import score_logprobs_fn
        from .serve_prefix import PrefixCache

        self.cfg = cfg
        self.params = params
        self.max_len = max_len
        self.slots = slots
        self.chunk = chunk
        self.window = max(1, int(window))
        self.mesh = mesh
        self.sp = sp
        self.cp_min_len = cp_min_len
        self.prefill_chunk = prefill_chunk
        self.device = params["norm_out"].device
        self.prefix_cache = (
            PrefixCache(prefix_entries) if prefix_entries > 0 else None
        )
        self.cp_buckets = tuple(
            cp_head_buckets(cp_min_len, max_len, sp) if sp > 1 else ()
        )
        self.program = make_step_program(
            cfg, params, max_len, slots, chunk, rounds=self.window,
            mesh=mesh,
        )
        self.score_fn = score_logprobs_fn(cfg, mesh)
        # the program's done flags as last written (admission writes
        # the row's own; run_chunk retires what the broadcast mask
        # ends). Host bookkeeping only, never a device operand.
        self._done_host = np.ones((slots,), bool)
        # device program shapes dispatched so far; those first seen
        # after ``warm_pod`` (mark_warm) are kept in order
        self.first_use: set = set()
        self.fresh_after_warm: List[Tuple] = []
        self._warm = False

    def use(self, *key) -> None:
        """Record one device program shape's dispatch."""
        if key in self.first_use:
            return
        self.first_use.add(key)
        if self._warm:
            self.fresh_after_warm.append(key)

    def mark_warm(self) -> None:
        self._warm = True

    def _tensor(self, host) -> torch.Tensor:
        return torch.as_tensor(np.asarray(host, np.int64),
                               device=self.device)

    @torch.inference_mode()
    def prefill(self, row: List[int]):
        """The admission prefill policy, in the reference's order: a
        prefix-cache hit, the cp ring for a long prompt, chunked
        prefill, one-shot prefill. Returns (logits [1, vocab], row
        cache)."""
        from ..models.decode import chunked_prefill, prefill
        from ..parallel.context import (
            cp_prefill_with_remainder,
            pick_cp_head,
        )
        from .serve_prefix import MIN_REUSE, plan_reuse, reuse_admission

        plen = len(row)
        pc = self.prefix_cache
        # prompts shorter than MIN_REUSE skip the prefix machinery (never
        # reusable; also keeps warm-up's admission out of the cache)
        use_pc = pc is not None and plen >= MIN_REUSE
        logits = row_cache = None
        if use_pc:
            reuse = plan_reuse(pc, row)[0]
            hit = reuse_admission(pc, row, self.cfg, self.params,
                                  chunk_len=self.prefill_chunk,
                                  mesh=self.mesh)
            if hit is not None:
                logits, row_cache = hit
                self.use("extend", plen - reuse, self.prefill_chunk)
        if row_cache is None:
            cp_head = 0
            if self.sp > 1 and plen >= self.cp_min_len:
                cp_head = pick_cp_head(plen, self.cp_buckets)
            if cp_head > 0:
                self.use("cp", cp_head, plen - cp_head)
                logits, row_cache = cp_prefill_with_remainder(
                    self.params, np.asarray([row], np.int64), self.cfg,
                    self.mesh, self.max_len, head=cp_head,
                    prefill_chunk=self.prefill_chunk,
                )
            elif 0 < self.prefill_chunk < plen:
                self.use("chunked", plen, self.prefill_chunk)
                logits, row_cache = chunked_prefill(
                    self.params, self._tensor([row]), self.cfg,
                    self.max_len, self.prefill_chunk, self.mesh,
                )
            else:
                self.use("prefill", plen)
                logits, row_cache = prefill(
                    self.params, self._tensor([row]), self.cfg,
                    self.max_len, self.mesh,
                )
        if use_pc:
            # the pool copies the row, so the stored entry stays unwritten
            pc.store(tuple(row), row_cache)
        return logits, row_cache

    def admit(self, payload) -> int:
        """Prefill the broadcast prompt into the named slot and write the
        slot's sampling state; returns token 0 (every rank draws the same
        token from the same gathered logits)."""
        slot = int(payload["admit_slot"])
        plen = int(payload["plen"])
        row = [int(t) for t in payload["prompt"][:plen]]
        logits, row_cache = self.prefill(row)
        req = _Admission(
            seed=int(payload["seed"]), row=int(payload["row_idx"]),
            max_new=int(payload["max_new_req"]),
            temperature=float(payload["temperature"]),
            top_k=int(payload["top_k"]), top_p=float(payload["top_p"]),
            eos_id=int(payload["eos_id"]), min_new=int(payload["min_new"]),
            presence=float(payload["presence"]),
            frequency=float(payload["frequency"]),
            bias_idx=np.asarray(payload["bias_idx"], np.int64),
            bias_val=np.asarray(payload["bias_val"], np.float32),
        )
        first = self.program.admit(slot, req, logits, row_cache)
        # the done flag the program wrote (the frontend ends the row on
        # the same condition, so its next mask agrees)
        self._done_host[slot] = first == req.eos_id or req.max_new <= 1
        return first

    # cpcheck: hotpath — the pod's per-round chunk step; the program's
    # one fetch, and a device write only where the mask ends a slot
    def run_chunk(self, done_mask, rounds: int = 1,
                  budget=None) -> np.ndarray:
        """Advance every slot one chunk, or (``rounds`` > 1) up to
        ``rounds`` chunk-rounds in one dispatch with the early exit on
        done/``budget``, under the broadcast done mask; returns the
        [slots, rounds_run * chunk] tokens (the fetch is what
        synchronizes device work, so a wedged computation stalls THIS
        op). Slots the mask newly ends are retired first; a steady round
        writes nothing to the device but the budgets."""
        mask = np.asarray(done_mask, bool)  # cpcheck: disable=CP-HOTSYNC host-side numpy only, no device operand
        for slot in np.flatnonzero(mask & ~self._done_host):
            self.program.retire(int(slot))
        self._done_host = mask.copy()
        fused = rounds > 1 and self.window > 1
        self.use("window" if fused else "chunk")
        if budget is None or not fused:
            budget = np.zeros((self.slots,), np.int64)
        handle = self.program.dispatch(np.asarray(budget, np.int64), fused)  # cpcheck: disable=CP-HOTSYNC host-side numpy only, no device operand
        toks, _valid, _rounds_run = self.program.tokens(handle)
        return toks


def _debug_round(mirror: _SlotMirror, payload, first, toks) -> None:  # cpcheck: disable=CP-HOTREACH debug-only dump behind CONTAINERPILOT_POD_DEBUG; every sync here is the point
    """Dump one round's inputs (CONTAINERPILOT_POD_DEBUG only)."""
    state = mirror.program._state
    print(
        "ROUND admit=%d plen=%d seed=%d row=%d mask=%s first=%s "
        "toks=%s step=%s last=%s"
        % (
            int(payload["admit_slot"]), int(payload["plen"]),
            int(payload["seed"]), int(payload["row_idx"]),
            np.asarray(payload["done"]).tolist(), first,
            None if toks is None else toks.tolist(),
            state["step_idx"].tolist(), state["last"].tolist(),
        ),
        flush=True,
    )


# cpcheck: hotpath — the device ops of one pod round
def _apply_round(mirror: _SlotMirror, payload):
    """The device ops of one round, identical on every rank: optional
    admission, then optionally one chunk (or a fused window). Returns
    (first token or None, [slots, n] tokens or None)."""
    first = toks = None
    if int(payload["admit_slot"]) >= 0:
        first = mirror.admit(payload)
    if int(payload["run_chunk"]):
        toks = mirror.run_chunk(
            payload["done"], rounds=int(payload["rounds"]),
            budget=payload["budget"],
        )
    if os.environ.get("CONTAINERPILOT_POD_DEBUG"):
        _debug_round(mirror, payload, first, toks)
    return first, toks


def shard_params_global(params: Any, mesh, cfg) -> Any:
    """This rank's blocks of identically initialized whole params under
    the tensor-parallel rules (``parallel.sharding.shard_params``)."""
    from ..parallel.sharding import shard_params

    return shard_params(params, mesh, cfg)


def _score_pod(mirror: _SlotMirror, payload) -> np.ndarray:
    """Teacher-forced per-token logprobs of the broadcast row: the
    single-host /v1/score function (``modelcfg.score_logprobs_fn``), run
    in lockstep. Rows pad to a multiple of 16 (capped at max_len), so a
    request's length picks one of a few shapes; causal attention makes
    the pad free, and the result is sliced on the host. Returns [1,
    plen - 1] float32."""
    plen = int(payload["plen"])
    width = min(-(-plen // 16) * 16, mirror.max_len)
    mirror.use("score", width)
    toks = mirror._tensor(payload["prompt"][None, :width])
    out = mirror.score_fn(mirror.params, toks)
    if os.environ.get("CONTAINERPILOT_POD_DEBUG"):
        print("SCORE plen=%d" % plen, flush=True)
    return out.float().cpu().numpy()[:, : plen - 1]


def _beam_pod(mirror: _SlotMirror, payload) -> List[int]:
    """One-shot lockstep beam search over the broadcast row: the
    single-host ``models.beam.beam_search`` on this rank's blocks. It
    beats the watchdog only when it ends, so the deadline must exceed
    the slowest beam."""
    from ..models.beam import beam_search

    plen = int(payload["plen"])
    width = int(payload["beam_width"])
    max_new = int(payload["max_new_req"])
    mirror.use("beam", plen, width, max_new)
    out, _score = beam_search(
        mirror.params, mirror._tensor(payload["prompt"][None, :plen]),
        mirror.cfg, max_new_tokens=max_new, max_len=mirror.max_len,
        beam_width=width, eos_id=int(payload["eos_id"]),
        length_penalty=float(payload["length_penalty"]), mesh=mirror.mesh,
    )
    if os.environ.get("CONTAINERPILOT_POD_DEBUG"):
        print("BEAM plen=%d width=%d" % (plen, width), flush=True)
    return [int(t) for t in out.tolist()]


def _spec_pod(mirror: _SlotMirror, draft, payload) -> List[int]:
    """One-shot lockstep speculative generation (draft-and-verify,
    greedy, output equal to plain greedy decoding) on this rank's
    blocks. Every acceptance decision comes from logits gathered whole,
    so every rank takes the same branches in the same order."""
    from ..models.speculative import speculative_generate

    draft_params, draft_cfg, speculate = draft
    plen = int(payload["plen"])
    mirror.use("spec", plen)
    out, stats = speculative_generate(
        mirror.params, draft_params,
        mirror._tensor(payload["prompt"][None, :plen]), mirror.cfg,
        draft_cfg, max_new_tokens=int(payload["max_new_req"]),
        max_len=mirror.max_len, speculate=speculate,
        eos_id=int(payload["eos_id"]), mesh=mirror.mesh,
    )
    if os.environ.get("CONTAINERPILOT_POD_DEBUG"):
        print("SPEC plen=%d stats=%s" % (plen, stats), flush=True)
    return [int(t) for t in out[0].tolist()]


def pod_ops(mirror: _SlotMirror, lockstep, draft=None) -> Dict[str, Any]:
    """The pod's lockstep ops (name -> handler of the payload), the same
    on every rank; each folds what it yields into the rank's digest."""

    def round_op(payload):
        first, toks = _apply_round(mirror, payload)
        if first is not None:
            lockstep.record_tokens([first])
        if toks is not None:
            lockstep.record_tokens(toks)
        return first, toks

    def score_op(payload):
        out = _score_pod(mirror, payload)
        lockstep.record_tokens(out)
        return out

    def beam_op(payload):
        row = _beam_pod(mirror, payload)
        lockstep.record_tokens(row)
        return row

    def spec_op(payload):
        row = _spec_pod(mirror, draft, payload)
        lockstep.record_tokens(row)
        return row

    return {OP_ROUND: round_op, OP_SCORE: score_op, OP_BEAM: beam_op,
            OP_SPEC: spec_op}


def _hit_stop(emitted: List[int], stops: List[List[int]]) -> bool:
    """Whether any stop sequence occurs anywhere in the emission: the
    frontend's early-eviction check (the stop-exclusive trim happens at
    answer time through ``InferenceServer._trim_stops``)."""
    for stop in stops:
        n = len(stop)
        for i in range(len(emitted) - n + 1):
            if emitted[i:i + n] == stop:
                return True
    return False


class _Row:
    """One decode row of a request (n > 1 fans a request into n)."""

    __slots__ = ("emitted", "finished")

    def __init__(self) -> None:
        self.emitted: List[int] = []
        self.finished = False


class _GenReq:
    """Frontend bookkeeping for one /v1/generate|completions request
    riding the slot pool."""

    def __init__(self, work: Dict[str, Any], done_q) -> None:
        self.work = work
        self.done_q = done_q
        self.rows = [_Row() for _ in range(work["n"])]
        self.stream = bool(work.get("_stream"))
        self.cancel = work.get("_cancel")
        self.answered = False

    def cancelled(self) -> bool:
        return self.cancel is not None and self.cancel.is_set()


class _Frontend:
    """Process 0's HTTP surface: requests land in a queue the pod loop
    drains; the loop owns all device work."""

    def __init__(self, host: str, port: int, max_len: int,
                 vocab: int, pod_info: Optional[Dict[str, Any]] = None,
                 text: bool = False, stream_chunk: int = 8,
                 slots: int = 4, cfg: Any = None,
                 prefix_entries: int = 0,
                 ) -> None:
        from ..telemetry import tracing
        from ..telemetry.goodput import DeviceTimeLedger
        from ..utils.http import HTTPServer, Response
        from ..utils.prom import (
            Counter,
            Histogram,
            Registry,
            ensure_build_info,
            ensure_goodput_gauges,
        )

        self.max_len = max_len
        self.vocab = vocab
        self.slots = slots
        self.cfg = cfg  # model config (beam validation); optional
        self.ready = False
        # /v1/model's prefix_cache block keeps one schema: until the
        # mirror's live cache lands (after warm_pod), a configured cache
        # reports zeroed stats
        self.prefix_entries = prefix_entries
        self.prefix_cache = None
        self.pod_info = pod_info or {}
        self.stream_chunk = max(int(stream_chunk), 1)
        self.requests: "queue.Queue[Tuple[dict, queue.Queue]]" = (
            queue.Queue()
        )
        self._registry = Registry()
        self._m_requests = Counter(
            "containerpilot_pod_requests",
            "pod frontend requests by endpoint and status",
            ["endpoint", "status"], registry=self._registry,
        )
        self._m_latency = Histogram(
            "containerpilot_pod_request_seconds",
            "pod request latency (broadcast + lockstep decode)",
            [], registry=self._registry,
            buckets=(.05, .1, .25, .5, 1, 2.5, 5, 10, 30, 60, 120),
        )
        self._m_tokens = Counter(
            "containerpilot_pod_generated_tokens",
            "tokens returned by the pod frontend (post-trim)",
            registry=self._registry,
        )
        ensure_build_info(self._registry, "pod")
        # the pod's device-time ledger: the round loop is the single
        # writer (admission boundaries only); main() brackets the warm-up
        # as compile_warmup. Followers replay the same ops, so process
        # 0's ledger is the pod's.
        self.ledger = DeviceTimeLedger()
        self.dispatches = 0
        self.tokens_out = 0
        ensure_goodput_gauges(
            self._registry, self.ledger,
            lambda: (self.dispatches, self.tokens_out),
        )
        self._tracing = tracing
        self._tracer = tracing.TraceRecorder("pod")
        self._server = HTTPServer()
        self._server.route("GET", "/health", self._health)
        self._server.route("GET", "/metrics", self._metrics)
        self._server.route("GET", "/v1/traces", self._traces)
        self._server.route("GET", "/v1/goodput", self._goodput)
        self._server.route("GET", "/v1/model", self._model)
        self._server.route(
            "POST", "/v1/generate", self._traced("generate", self._generate)
        )
        self._server.route(
            "POST", "/v1/score", self._traced("score", self._score)
        )
        self.tokenizer = None
        if text:
            from .text import ByteTokenizer

            self.tokenizer = ByteTokenizer(vocab)
            self._server.route(
                "POST", "/v1/completions",
                self._traced("completions", self._completions),
            )
        self._host, self._port = host, port
        self._Response = Response
        self._loop = None
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self._server.bound_port or self._port

    def _traced(self, endpoint: str, handler):
        """Per-request trace around one API handler: adopt the caller's
        X-CP-Trace id (or mint one), echo it on every answer (422s
        included) and give buffered answers the span digest header."""
        tracing = self._tracing

        async def wrapped(req):
            trace = self._tracer.start(
                tracing.safe_id(req.headers.get("x-cp-trace")),
                endpoint,
            )
            token = tracing.activate(trace)
            try:
                resp = await handler(req)
            except Exception:
                trace.finish(500)
                raise
            finally:
                tracing.deactivate(token)
            resp.headers.setdefault(tracing.TRACE_HEADER, trace.trace_id)
            trace.finish(resp.status)
            if not hasattr(resp, "chunks"):  # a buffered Response
                resp.headers.setdefault(
                    tracing.DIGEST_HEADER, trace.digest()
                )
            return resp

        return wrapped

    async def _traces(self, req):
        return self._Response(
            200, self._tracer.snapshot_json(req.query),
            content_type="application/json",
        )

    async def _goodput(self, _req):
        """The pod's device-time ledger, in the single-host replica's
        ``/v1/goodput`` schema."""
        from ..telemetry.goodput import goodput_payload

        payload = goodput_payload(
            self.ledger, self._tracer, self.dispatches,
            self.tokens_out, role="pod", ready=self.ready,
            draining=False,
        )
        return self._Response(
            200, json.dumps(payload).encode(),
            content_type="application/json",
        )

    async def _dispatch(self, endpoint: str, work: Dict[str, Any]):
        """queue -> pod loop -> result, with the latency/500 accounting
        every endpoint shares. Returns (result, None) on success or
        (None, 500 Response) on a pod-side failure."""
        import asyncio

        t0 = time.perf_counter()
        done: "queue.Queue" = queue.Queue()
        self.requests.put((work, done))
        with self._tracing.span("pod_dispatch"):
            result = await asyncio.get_running_loop().run_in_executor(
                None, done.get
            )
        self._m_latency.observe(time.perf_counter() - t0)
        if isinstance(result, Exception):
            self._m_requests.labels(endpoint, "500").inc()
            return None, self._Response(500, f"{result}\n".encode())
        self._m_requests.labels(endpoint, "200").inc()
        return result, None

    async def _health(self, _req):
        if not self.ready:
            return self._Response(503, b"warming\n")
        return self._Response(200, b"ok\n")

    async def _metrics(self, _req):
        from ..utils.prom import exposition

        body, content_type = exposition(self._registry)
        return self._Response(200, body, content_type=content_type)

    async def _model(self, _req):
        self._m_requests.labels("model", "200").inc()
        info = dict(self.pod_info)
        pc = self.prefix_cache
        if pc is not None:
            info["prefix_cache"] = {"entries": pc.entries, **pc.stats}
        elif self.prefix_entries > 0:
            # the boot window: the same keys, zeroed (the pod has no
            # spill tier, so its spill counts stay zero after warm too)
            info["prefix_cache"] = {
                "entries": self.prefix_entries,
                "hits": 0, "misses": 0, "tokens_reused": 0,
                "spilled": 0, "readmitted": 0, "spill_bytes": 0,
            }
        return self._Response(
            200, json.dumps(info).encode(),
            content_type="application/json",
        )

    def _parse_work(self, body, tokens, default_eos: int = -1):
        """Validate the decode knobs shared by /v1/generate and the --text
        surface into a broadcastable work dict. Full validation here: a
        malformed value that failed only inside the pod loop would be
        pod-fatal. Raises ValueError (the 422 family)."""
        max_new = int(body.get("max_new_tokens", 16))
        if max_new < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if len(tokens) + max_new > self.max_len:
            raise ValueError(
                f"prompt + max_new_tokens exceeds max_len "
                f"{self.max_len}"
            )
        temperature = float(body.get("temperature", 0.0))
        top_k = int(body.get("top_k", 0))
        top_p = float(body.get("top_p", 0.0))
        eos_id = int(body.get("eos_id", default_eos))
        seed = int(body.get("seed", 0))
        if not 0 <= top_k <= self.vocab:
            raise ValueError(f"top_k must be in [0, {self.vocab}]")
        if not 0.0 <= top_p <= 1.0:
            raise ValueError("top_p must be in [0, 1]")
        if eos_id >= self.vocab:
            raise ValueError(f"eos_id must be < {self.vocab}")
        if not -(2**31) <= seed < 2**31:
            raise ValueError("seed must fit in int32")
        min_new = int(body.get("min_new_tokens", 0))
        if not 0 <= min_new <= max_new:
            raise ValueError(
                "min_new_tokens must be in [0, max_new_tokens]"
            )
        presence = float(body.get("presence_penalty", 0.0))
        frequency = float(body.get("frequency_penalty", 0.0))
        if not (abs(presence) <= 100 and abs(frequency) <= 100):
            raise ValueError(
                "presence/frequency penalties must be in [-100, 100]"
            )
        from .modelcfg import parse_logit_bias, parse_stop_ids

        bias = parse_logit_bias(body.get("logit_bias"), self.vocab) or {}
        stop = parse_stop_ids(body.get("stop"), self.vocab)
        logprobs = bool(body.get("logprobs", False))
        n = int(body.get("n", 1))
        if not 1 <= n <= self.slots:
            raise ValueError(
                f"n must be in [1, --slots {self.slots}] on the pod "
                "frontend (each sample occupies one slot)"
            )
        beam_width = int(body.get("beam_width", 0))
        length_penalty = float(body.get("length_penalty", 0.0))
        if beam_width:
            if n != 1:
                raise ValueError(
                    "n does not compose with beam search (beams "
                    "already return one best row)"
                )
            if temperature > 0.0 or top_k or top_p:
                raise ValueError(
                    "beam search is deterministic; drop "
                    "temperature/top_k/top_p"
                )
            if min_new:
                raise ValueError(
                    "min_new_tokens does not apply to beam search"
                )
            if presence or frequency:
                raise ValueError("penalties do not apply to beam search")
            if bias:
                raise ValueError("logit_bias does not apply to beam search")
            if self.cfg is not None:
                from ..models.beam import validate_beam_args

                validate_beam_args(self.cfg, 1, beam_width)
            elif not 1 <= beam_width <= self.vocab:
                raise ValueError(
                    f"beam_width must be in [1, vocab {self.vocab}]"
                )
            if beam_width > self.slots:
                # one request must not exceed the pod's device-row
                # budget (--slots, the pool's sizing)
                raise ValueError(
                    f"beam_width capped at --slots ({self.slots}) "
                    "on the pod frontend"
                )
        return {
            "kind": "beam" if beam_width else "gen",
            "tokens": tokens, "max_new": max_new,
            "temperature": temperature,
            "top_k": top_k,
            "top_p": top_p,
            "eos_id": max(eos_id, -1),
            "seed": seed,
            "min_new": min_new,
            "presence": presence,
            "frequency": frequency,
            "logit_bias": bias,
            "stop": stop,
            "logprobs": logprobs,
            "n": n,
            "beam_width": beam_width,
            "length_penalty": length_penalty,
        }

    @staticmethod
    def _check_stream_composes(work) -> None:
        if work["kind"] == "beam":
            raise ValueError(
                "stream does not compose with beam_width (beams "
                "have no incremental prefix)"
            )
        if work["n"] != 1:
            raise ValueError(
                "n does not compose with stream (one SSE stream "
                "carries one row)"
            )
        for knob, why in (
            ("logprobs", "echo logprobs need the full row"),
            ("stop", "stop sequences need whole-row trimming"),
        ):
            if work[knob]:
                raise ValueError(
                    f"stream does not compose with {knob} ({why})"
                )

    def _parse_single_row(self, body, min_len: int = 1):
        rows = body.get("tokens")
        if (
            not isinstance(rows, list) or len(rows) != 1
            or not isinstance(rows[0], list)
            or len(rows[0]) < min_len
        ):
            raise ValueError(
                f"'tokens' must be one row of at least {min_len} "
                "ids (the pod frontend serves single-row requests; "
                "n is the row multiplier)"
            )
        tokens = rows[0]
        if any(
            not isinstance(t, int) or isinstance(t, bool)
            or t < 0 or t >= self.vocab
            for t in tokens
        ):
            raise ValueError(
                f"token ids must be integers in [0, {self.vocab})"
            )
        return tokens

    async def _generate(self, req):
        try:
            body = json.loads(req.body.decode() or "{}")
            work = self._parse_work(body, self._parse_single_row(body))
            if bool(body.get("stream", False)):
                self._check_stream_composes(work)
                return self._stream_request("generate", work)
        except (ValueError, KeyError, TypeError, OverflowError) as exc:
            self._m_requests.labels("generate", "422").inc()
            return self._Response(422, f"{exc}\n".encode())
        result, err = await self._dispatch("generate", work)
        if err is not None:
            return err
        rows = result["tokens"]
        self._m_tokens.inc(sum(len(r) for r in rows))
        payload: Dict[str, Any] = {"tokens": rows}
        if result.get("logprobs") is not None:
            payload["logprobs"] = result["logprobs"]
        return self._Response(
            200, json.dumps(payload).encode(),
            content_type="application/json",
        )

    async def _completions(self, req):
        """Text in/out around the same slot-pool decode: encode the
        prompt through the byte tokenizer, default eos to the
        tokenizer's EOS, decode the generated ids back. ``stop`` takes
        strings here; ``stream`` emits text deltas with UTF-8 partial
        byte holdback (text.stream_decoder)."""
        tok = self.tokenizer
        try:
            body = json.loads(req.body.decode() or "{}")
            prompt = body.get("prompt")
            if not isinstance(prompt, str) or not prompt:
                raise ValueError("'prompt' must be a non-empty string")
            row = tok.encode(prompt)
            if len(row) >= self.max_len:
                raise ValueError(
                    f"prompt encodes to {len(row)} ids; max_len is "
                    f"{self.max_len}"
                )
            from .modelcfg import parse_stop_strings

            stop_raw = parse_stop_strings(body.pop("stop", None))
            if stop_raw is not None:
                body["stop"] = [tok.encode(s, bos=False) for s in stop_raw]
            work = self._parse_work(body, row, default_eos=tok.EOS)
            # the single-host text surface ignores logprobs
            work["logprobs"] = False
            if work["n"] > 1:
                raise ValueError("n returns token rows; use /v1/generate")
            if bool(body.get("stream", False)):
                self._check_stream_composes(work)
                from .text import stream_decoder

                delta_event, tail_events = stream_decoder(tok)
                return self._stream_request(
                    "completions", work, delta_event=delta_event,
                    tail_events=tail_events,
                )
        except (ValueError, KeyError, TypeError, OverflowError) as exc:
            self._m_requests.labels("completions", "422").inc()
            return self._Response(422, f"{exc}\n".encode())
        result, err = await self._dispatch("completions", work)
        if err is not None:
            return err
        row_out = result["tokens"][0]
        self._m_tokens.inc(len(row_out))
        return self._Response(
            200,
            json.dumps({"text": tok.decode(row_out),
                        "tokens": row_out}).encode(),
            content_type="application/json",
        )

    def _stream_request(self, endpoint: str, work,
                        delta_event=None, tail_events=None):
        """SSE over the pod's chunked lockstep rounds: each chunk's delta
        becomes a ``data:`` event as its round lands; concatenated deltas
        equal the non-streamed answer. A client disconnect sets the
        cancel event: the frontend evicts the slot at the next round."""
        import asyncio

        from ..utils.http import StreamingResponse

        if delta_event is None:
            delta_event = lambda d: {"tokens": d}  # noqa: E731
        if tail_events is None:
            tail_events = list  # noqa: E731 - no tail

        cancel = threading.Event()
        work = dict(work, _cancel=cancel, _stream=True)
        done: "queue.Queue" = queue.Queue()
        t0 = time.perf_counter()
        self.requests.put((work, done))
        sent = [0]
        status = ["200"]
        finished = [False]

        def finish() -> None:
            if finished[0]:
                return
            finished[0] = True
            cancel.set()
            self._m_latency.observe(time.perf_counter() - t0)
            self._m_tokens.inc(sent[0])
            self._m_requests.labels(endpoint, status[0]).inc()

        def sse(payload) -> bytes:
            return b"data: " + json.dumps(payload).encode() + b"\n\n"

        async def events():
            loop = asyncio.get_running_loop()
            try:
                while True:
                    item = await loop.run_in_executor(None, done.get)
                    if isinstance(item, Exception):
                        status[0] = "500"
                        yield sse({"error": str(item)})
                        break
                    kind, val = item
                    if kind == "delta":
                        sent[0] += len(val)
                        yield sse(delta_event(val))
                    else:
                        for extra in tail_events():
                            yield sse(extra)
                        yield sse({"done": True, "count": sent[0]})
                        break
            finally:
                finish()

        return StreamingResponse(events(), close=finish)

    async def _score(self, req):
        try:
            body = json.loads(req.body.decode() or "{}")
            tokens = self._parse_single_row(body, min_len=2)
            if len(tokens) > self.max_len:
                raise ValueError(
                    f"row length exceeds max_len {self.max_len}"
                )
        except (ValueError, KeyError, TypeError) as exc:
            self._m_requests.labels("score", "422").inc()
            return self._Response(422, f"{exc}\n".encode())
        result, err = await self._dispatch(
            "score", {"kind": "score", "score": tokens}
        )
        if err is not None:
            return err
        return self._Response(
            200,
            json.dumps(
                {
                    "logprobs": [[round(float(x), 6) for x in row]
                                 for row in result],
                    "sums": [round(float(sum(row)), 6) for row in result],
                }
            ).encode(),
            content_type="application/json",
        )

    def start(self) -> None:
        import asyncio

        started = threading.Event()

        def run() -> None:
            loop = asyncio.new_event_loop()
            asyncio.set_event_loop(loop)
            self._loop = loop
            loop.run_until_complete(
                self._server.start_tcp(self._host, self._port)
            )
            started.set()
            loop.run_forever()

        self._thread = threading.Thread(
            target=run, name="serve-dist-http", daemon=True
        )
        self._thread.start()
        if not started.wait(timeout=30):
            raise RuntimeError("frontend never bound")

    def stop(self) -> None:
        import asyncio

        if self._loop is not None:
            async def shutdown() -> None:
                await self._server.stop()
                asyncio.get_running_loop().stop()

            self._loop.call_soon_threadsafe(
                lambda: asyncio.ensure_future(shutdown())
            )
        if self._thread is not None:
            self._thread.join(timeout=10)


def warm_pod(mirror: _SlotMirror) -> None:
    """Run the pool's whole serve-path program set before traffic: the
    plen-4 admission (prefill, first sample, insert), the chunk, the
    fused window, the width-16 scorer and every cp head bucket. Every
    rank derives the same warm payloads from its own flags (nothing is
    broadcast) and runs the same collectives in the same order, inside
    the startup grace where the pod is freshly rendezvoused. Afterwards
    (``mark_warm``) a request at these shapes adds nothing to
    ``mirror.fresh_after_warm``; new prompt lengths, beam shapes and
    wider score rows still run their first dispatch under traffic, and
    the watchdog deadline must absorb exactly those."""
    warm = _payload_zeros(mirror.max_len, mirror.slots)
    _fill_admission(
        warm,
        {
            "tokens": [0] * WARM_PLEN,
            "max_new": mirror.chunk + 1,
            "temperature": 0.0, "top_k": 0, "top_p": 0.0,
            "eos_id": -1, "seed": 0, "min_new": 0,
            "presence": 0.0, "frequency": 0.0, "logit_bias": {},
        },
        row_idx=0, slot=0,
    )
    warm["run_chunk"] = np.asarray(1, np.int32)
    warm["done"][0] = 0
    _apply_round(mirror, warm)
    if mirror.window > 1:
        # one pure-decode window over the still-admitted warm slot,
        # budget 1: the device loop runs one round and exits
        warm_w = _payload_zeros(mirror.max_len, mirror.slots)
        warm_w["run_chunk"] = np.asarray(1, np.int32)
        warm_w["done"][0] = 0
        warm_w["rounds"] = np.asarray(mirror.window, np.int32)
        warm_w["budget"][0] = 1
        _apply_round(mirror, warm_w)
    warm_score = _payload_zeros(mirror.max_len, mirror.slots)
    warm_score["plen"] = np.asarray(5, np.int32)
    _score_pod(mirror, warm_score)
    # EVERY cp ring shape runs here: ring prefills are the pod's only
    # collectives over the seq axis, and a group's first collective
    # under request-time skew between ranks is what this avoids
    if mirror.cp_buckets:
        from ..parallel.context import cp_prefill_with_remainder

        for head in mirror.cp_buckets:
            mirror.use("cp", head, 0)
            cp_prefill_with_remainder(
                mirror.params, np.zeros((1, head), np.int64), mirror.cfg,
                mirror.mesh, mirror.max_len, head=head,
            )
    if mirror.device.type == "cuda":
        torch.cuda.synchronize(mirror.device)


def _run_frontend_loop(args, frontend: _Frontend, mirror: _SlotMirror,
                       lockstep, stopping, draft=None) -> None:
    """Process 0's round loop: drain HTTP work, drive admissions and
    chunks as lockstep ops, keep the per-request emission bookkeeping,
    answer handlers. While the pod is idle the lockstep's own ``check``
    op (``start_checks``) keeps every rank's watchdog fed."""
    from .serve import InferenceServer

    S = args.slots
    pending: "deque[Tuple[_GenReq, int]]" = deque()
    owners: List[Optional[Tuple[_GenReq, int]]] = [None] * S
    open_reqs: List[_GenReq] = []

    def call(op, payload):
        return lockstep.call(op, (payload,))

    def run_score_round(row: List[int]) -> np.ndarray:
        """One lockstep score op; returns the [1, plen-1] logprobs."""
        p = _payload_zeros(args.max_len, S)
        p["prompt"][: len(row)] = np.asarray(row, np.int32)
        p["plen"] = np.asarray(len(row), np.int32)
        return call(OP_SCORE, p)

    def echo_logprobs(prompt: List[int],
                      rows_out: List[List[int]]) -> List[List[float]]:
        """Per-token logprobs of the TRIMMED generated rows through
        lockstep score ops (the single-host scorer; causal attention
        makes pad-width differences free)."""
        lps: List[List[float]] = []
        start = len(prompt) - 1
        for gen in rows_out:
            if not gen:
                lps.append([])
                continue
            picked = run_score_round(prompt + gen)[0]
            lps.append([
                round(float(x), 6)
                for x in picked[start:start + len(gen)]
            ])
        return lps

    def finish_req(req: _GenReq) -> None:
        req.answered = True
        w = req.work
        if req.stream:
            req.done_q.put(("end", None))
            return
        rows_out = [
            InferenceServer._trim([r.emitted], w["max_new"], w["eos_id"])[0]
            for r in req.rows
        ]
        rows_out = InferenceServer._trim_stops(rows_out, w["stop"])
        result: Dict[str, Any] = {"tokens": rows_out}
        if w["logprobs"]:
            result["logprobs"] = echo_logprobs(w["tokens"], rows_out)
        req.done_q.put(result)

    def row_append(req: _GenReq, row: _Row, toks) -> None:
        from ..models.slots import append_chunk

        w = req.work
        before = len(row.emitted)
        ended = append_chunk(row.emitted, toks, w["max_new"], w["eos_id"])
        frontend.tokens_out += len(row.emitted) - before
        if w["stop"] and not ended and _hit_stop(row.emitted, w["stop"]):
            # the answer-time trim cuts before the stop: stop paying
            # for tokens it would discard
            ended = True
        if req.stream and len(row.emitted) > before:
            req.done_q.put(("delta", list(row.emitted[before:])))
        if ended:
            row.finished = True

    def run_one_shot(work, done_q, op, fill_extra) -> None:
        """The shared answer path of one-shot lockstep ops (beam, spec):
        fill the row payload, run the op, trim, echo logprobs if asked,
        answer; failing pod-fatally like every collective path."""
        p = _payload_zeros(args.max_len, S)
        tokens = work["tokens"]
        p["prompt"][: len(tokens)] = np.asarray(tokens, np.int32)
        p["plen"] = np.asarray(len(tokens), np.int32)
        p["max_new_req"] = np.asarray(work["max_new"], np.int32)
        p["eos_id"] = np.asarray(work["eos_id"], np.int32)
        fill_extra(p)
        # a one-shot op is a whole generation in one lockstep op:
        # attributed to decode
        frontend.ledger.enter("decode")
        frontend.dispatches += 1
        try:
            row = call(op, p)
            rows_out = InferenceServer._trim(
                [row], work["max_new"], work["eos_id"]
            )
            rows_out = InferenceServer._trim_stops(rows_out, work["stop"])
            frontend.tokens_out += sum(len(r) for r in rows_out)
            result: Dict[str, Any] = {"tokens": rows_out}
            if work["logprobs"]:
                result["logprobs"] = echo_logprobs(work["tokens"], rows_out)
        except Exception as exc:  # noqa: BLE001 - pod-fatal
            done_q.put(exc)
            fail_open(exc)
            raise
        if not any(owners) and not pending:
            # a one-shot answered between chunk rounds must not mark a
            # busy pool idle
            frontend.ledger.engine_idle()
        done_q.put(result)

    def classify(work, done_q) -> None:
        kind = work.get("kind", "gen")
        if kind == "score":
            try:
                out = run_score_round(work["score"])
            except Exception as exc:  # noqa: BLE001 - pod-fatal
                done_q.put(exc)
                fail_open(exc)
                raise
            done_q.put(out.tolist())
            return
        if kind == "beam":
            def fill_beam(p) -> None:
                p["beam_width"] = np.asarray(work["beam_width"], np.int32)
                p["length_penalty"] = np.asarray(
                    work["length_penalty"], np.float32
                )

            run_one_shot(work, done_q, OP_BEAM, fill_beam)
            return
        if (
            draft is not None
            and not work.get("_stream")
            and not any(owners) and not pending
            and work["n"] == 1
            and work["temperature"] <= 0.0
            and work["min_new"] == 0
            and not work["presence"] and not work["frequency"]
            and not work["logit_bias"]
        ):
            # a greedy single request against an IDLE pool: draft and
            # verify (the same output, fewer target passes); under
            # concurrency the slot pool wins, and a one-shot op would
            # stall co-batched streams
            run_one_shot(work, done_q, OP_SPEC, lambda p: None)
            return
        req = _GenReq(work, done_q)
        open_reqs.append(req)
        for i in range(work["n"]):
            pending.append((req, i))

    def fail_open(exc: Exception) -> None:
        """A collective-path failure is pod-fatal: every waiting handler
        gets an answer before the raise, or its executor thread blocks
        forever."""
        for req in open_reqs:
            if not req.answered:
                req.answered = True
                req.done_q.put(exc)
        while True:
            try:
                _w, dq = frontend.requests.get_nowait()
            except queue.Empty:
                break
            dq.put(exc)

    def do_shutdown(leftover=None) -> None:
        """``leftover``: a (work, done_q) item already dequeued when
        SIGTERM landed: answered explicitly, or its handler blocks."""
        lockstep.shutdown()
        err = RuntimeError("pod is shutting down")
        if leftover is not None:
            leftover[1].put(err)
        fail_open(err)

    while True:
        if stopping.is_set():
            do_shutdown()
            return
        if not any(owners) and not pending:
            # fully idle: block for work (the lockstep's check op keeps
            # the followers' watchdogs fed meanwhile)
            frontend.ledger.engine_idle()
            got = None
            while got is None and not stopping.is_set():
                try:
                    got = frontend.requests.get(timeout=0.25)
                except queue.Empty:
                    pass
            if stopping.is_set():
                do_shutdown(leftover=got)
                return
            classify(*got)
            continue
        # busy: drain whatever queued without blocking (scores and beams
        # run as their own lockstep ops between chunk rounds)
        while True:
            try:
                classify(*frontend.requests.get_nowait())
            except queue.Empty:
                break
        # sweep cancelled streams: their rows finish now, their slots
        # drop out of the next mask
        for req in open_reqs:
            if req.cancelled() and not req.answered:
                for r in req.rows:
                    r.finished = True
                finish_req(req)
        open_reqs[:] = [r for r in open_reqs if not r.answered]
        for i, o in enumerate(owners):
            if o is not None and o[0].rows[o[1]].finished:
                owners[i] = None
        # admission: at most one row a round (the payload carries one
        # prompt)
        payload = _payload_zeros(args.max_len, S)
        admit: Optional[Tuple[_GenReq, int, int]] = None
        free = [i for i, o in enumerate(owners) if o is None]
        while pending and free and admit is None:
            req, ridx = pending.popleft()
            if req.answered or req.cancelled():
                continue
            slot = free[0]
            _fill_admission(payload, req.work, ridx, slot)
            owners[slot] = (req, ridx)
            admit = (req, ridx, slot)
        mask = np.ones(S, np.int32)
        for i, o in enumerate(owners):
            if o is not None and not o[0].rows[o[1]].finished:
                mask[i] = 0
        run_chunk = int((mask == 0).any())
        if admit is None and not run_chunk:
            continue  # e.g. everything was just cancelled
        payload["run_chunk"] = np.asarray(run_chunk, np.int32)
        payload["done"] = mask
        # fuse K chunk-rounds into one dispatch on pure-decode rounds: an
        # admission, queued work, a pending row or a stop watch keeps
        # chunk granularity; budget = each row's remaining max_new
        rounds = 1
        budget = np.zeros(S, np.int32)
        if (
            mirror.window > 1 and run_chunk and admit is None
            and not pending
            and frontend.requests.empty()
            and not any(o is not None and o[0].work["stop"] for o in owners)
        ):
            rounds = mirror.window
            for i, o in enumerate(owners):
                if o is not None and not mask[i]:
                    req_o, ridx_o = o
                    budget[i] = max(
                        req_o.work["max_new"]
                        - len(req_o.rows[ridx_o].emitted), 0,
                    )
        payload["rounds"] = np.asarray(rounds, np.int32)
        payload["budget"] = budget
        # ledger stamps at admission boundaries only
        if admit is not None:
            frontend.ledger.enter("prefill")
        try:
            first, toks = call(OP_ROUND, payload)
        except Exception as exc:  # noqa: BLE001 - pod-fatal
            fail_open(exc)
            raise
        frontend.dispatches += 1
        if admit is not None:
            frontend.ledger.enter("decode")
            req, ridx, _slot = admit
            row_append(req, req.rows[ridx], [first])
        if toks is not None:
            for i, o in enumerate(owners):
                if o is None or mask[i]:
                    continue
                req, ridx = o
                row = req.rows[ridx]
                if not row.finished:
                    row_append(req, row, toks[i])
        for i, o in enumerate(owners):
            if o is not None and o[0].rows[o[1]].finished:
                owners[i] = None
        for req in open_reqs:
            if not req.answered and all(r.finished for r in req.rows):
                finish_req(req)
        open_reqs[:] = [r for r in open_reqs if not r.answered]


def _wedge_on_follower(lockstep, wedge_file: str) -> None:
    """Fault injection (``--wedge-file``): every op handler of a follower
    first looks for the file; a follower that finds it consumes it
    (wedging ONCE, so a restarted pod comes back healthy) and stops
    making progress without exiting, which is what a stuck decode looks
    like to the rest of the pod."""
    def wedging(handler):
        def run(*args):
            if os.path.exists(wedge_file):
                try:
                    os.remove(wedge_file)
                except OSError:
                    pass
                print("follower: injected wedge", flush=True)
                while True:
                    time.sleep(3600)
            return handler(*args)
        return run

    lockstep.register({name: wedging(handler)
                       for name, handler in lockstep.handlers.items()})


def build_arg_parser() -> argparse.ArgumentParser:
    from ..parallel.serving import DEFAULT_DEADLINE_S
    from .serve_cli import add_d_ff_arg

    parser = argparse.ArgumentParser(
        description="multi-process pod inference server"
    )
    parser.add_argument("--process-id", type=int, required=True)
    parser.add_argument("--num-processes", type=int, required=True)
    parser.add_argument("--catalog", required=True,
                        help="the rendezvous catalog: a Consul address "
                        "(host:port) or file:DIR")
    parser.add_argument("--coordinator-port", type=int, default=0)
    parser.add_argument("--advertise-address", default="")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default; a card a rank, or ranks "
                        "sharing one) or cpu")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--max-len", type=int, default=512)
    parser.add_argument("--d-model", type=int, default=256)
    parser.add_argument("--n-layers", type=int, default=2)
    parser.add_argument("--n-heads", type=int, default=4)
    parser.add_argument("--n-kv-heads", type=int, default=0)
    add_d_ff_arg(parser)
    parser.add_argument("--vocab", type=int, default=1024)
    parser.add_argument("--checkpoint-dir", default="",
                        help="shared-storage checkpoint the whole pod "
                        "restores in lockstep (each rank keeps its "
                        "blocks)")
    parser.add_argument("--use-ema", action="store_true")
    parser.add_argument("--slots", type=int, default=4,
                        help="slot-pool size: how many requests decode "
                        "concurrently in lockstep (also the n / "
                        "beam_width budget); KV memory scales with it")
    parser.add_argument("--stream-chunk", type=int, default=8,
                        help="tokens per lockstep chunk round: the "
                        "admission latency, the SSE delta granularity "
                        "and the watchdog's progress quantum")
    parser.add_argument("--slot-window", type=int, default=4,
                        help="chunk-rounds fused into one device "
                        "dispatch on pure-decode rounds (early exit on "
                        "done/budget); admissions, queued work and "
                        "stop-sequence watches keep chunk granularity. "
                        "1 = off")
    parser.add_argument("--draft-layers", type=int, default=0,
                        help="self-speculative decoding: greedy single "
                        "requests against an idle pool draft with the "
                        "model's first N layers and verify in chunks; "
                        "the same output (0 = off)")
    parser.add_argument("--speculate", type=int, default=4,
                        help="draft tokens per speculative round")
    parser.add_argument("--kv-int8", action="store_true",
                        help="serve with the int8 KV cache")
    parser.add_argument("--prefill-chunk", type=int, default=0,
                        help="admissions longer than N prefill in "
                        "fixed-size pieces; 0 = one-shot admission "
                        "prefill; prompts taking the --sp ring skip this")
    parser.add_argument("--prefix-cache", type=int, default=0,
                        help="prefix KV reuse on the pod: every process "
                        "keeps an identical LRU of the last N admitted "
                        "prompts' KV rows. 0 = off; rejects --sp and "
                        "--window")
    parser.add_argument("--window", type=int, default=0,
                        help="sliding-window attention over per-slot "
                        "ring caches (0 = full attention)")
    parser.add_argument("--moe-experts", type=int, default=0,
                        help="switch-MoE experts; must match the "
                        "checkpoint being served and divide by the "
                        "model axis")
    parser.add_argument("--int8", action="store_true",
                        help="weight-only int8 (the whole tree quantized, "
                        "then cut into each rank's blocks)")
    parser.add_argument("--lora-dir", default="",
                        help="merge a trained LoRA adapter checkpoint "
                        "into the base weights at load, before any "
                        "--int8")
    parser.add_argument("--lora-rank", type=int, default=0,
                        help="rank of the adapter in --lora-dir")
    parser.add_argument("--text", action="store_true",
                        help="byte-tokenizer /v1/completions on the "
                        "frontend (vocab must be >= 259)")
    parser.add_argument("--sp", type=int, default=1,
                        help="context-parallel admission: a seq axis of "
                        "this many ranks rings long-prompt prefills; "
                        "decode stays on the slot pool. Not with "
                        "--window or --draft-layers")
    parser.add_argument("--cp-min-len", type=int, default=0,
                        help="minimum prompt length that rings over the "
                        "seq axis; 0 derives it from the axis size")
    parser.add_argument("--dp", type=int, default=1,
                        help="data-parallel axis size: the rank count "
                        "factors as (dp, sp, ranks/(dp*sp)); the model "
                        "shards over the last")
    parser.add_argument("--watchdog", type=float, default=0.0,
                        help="decode-progress deadline in seconds: every "
                        "process exits %d when an op stalls past it "
                        "(0 = the lockstep's default, %.0f s). Size it "
                        "above one chunk round plus the slowest one-shot "
                        "op (a beam, a score, a first dispatch)"
                        % (WATCHDOG_EXIT, DEFAULT_DEADLINE_S))
    parser.add_argument("--startup-grace", type=float, default=300.0,
                        help="first-deadline grace covering rendezvous, "
                        "load and warm-up")
    parser.add_argument("--wedge-file", default="",
                        help="fault injection (tests): when this file "
                        "exists, a follower consumes it and wedges "
                        "(stops making progress without exiting)")
    return parser


def _refuse(args, n_global: int) -> Tuple[int, int]:
    """Every startup refusal of the reference, with its messages,
    before the rendezvous (every process fails the same way, none is
    stranded in a first collective). Returns (cp_min_len, model axis)."""
    from .modelcfg import validate_lora_flags

    if args.slots < 1 or args.stream_chunk < 1:
        raise SystemExit("--slots and --stream-chunk must be >= 1")
    if args.window < 0:
        raise SystemExit("--window must be >= 0")
    if args.dp < 1 or args.sp < 1:
        raise SystemExit("--dp and --sp must be >= 1")
    if args.sp > 1 and args.window > 0:
        raise SystemExit(
            "--sp does not compose with --window (ring attention "
            "rejects sliding windows)"
        )
    if args.sp > 1 and args.draft_layers > 0:
        raise SystemExit(
            "--sp does not compose with --draft-layers (speculative "
            "prefill is chunk-driven)"
        )
    if args.prefix_cache < 0:
        raise SystemExit("--prefix-cache must be >= 0")
    if args.prefill_chunk < 0:
        raise SystemExit("--prefill-chunk must be >= 0")
    if args.prefix_cache > 0 and args.sp > 1:
        raise SystemExit(
            "--prefix-cache does not compose with --sp (cached "
            "prefixes bypass the ring)"
        )
    if args.prefix_cache > 0 and args.window > 0:
        raise SystemExit(
            "--prefix-cache does not compose with --window (a ring "
            "cache's stale rows are live window context)"
        )
    cp_min_len = args.cp_min_len
    if args.sp <= 1 and cp_min_len:
        raise SystemExit("--cp-min-len requires --sp > 1")
    if args.sp > 1:
        from ..parallel.context import resolve_cp_min_len

        try:
            cp_min_len = resolve_cp_min_len(
                cp_min_len, args.sp, args.max_len, flag="sp"
            )
        except ValueError as exc:
            raise SystemExit(str(exc)) from None
    if args.window > 0 and args.draft_layers > 0:
        raise SystemExit(
            "--draft-layers does not compose with --window "
            "(speculative rollback cannot undo ring-cache writes)"
        )
    if 4 + args.stream_chunk + 1 > args.max_len:
        raise SystemExit(
            f"--max-len {args.max_len} too small for the warmup "
            f"request (needs >= {4 + args.stream_chunk + 1})"
        )
    if args.text:
        from .text import ByteTokenizer

        if args.vocab < ByteTokenizer.N_IDS:
            raise SystemExit(
                f"--text needs vocab >= {ByteTokenizer.N_IDS}, got "
                f"{args.vocab}"
            )
    if n_global % (args.dp * args.sp):
        raise SystemExit(
            f"--dp {args.dp} x --sp {args.sp} must divide the "
            f"{n_global} global devices"
        )
    n_model = n_global // (args.dp * args.sp)
    if args.n_heads % n_model:
        raise SystemExit(
            f"model axis {n_model} must divide n_heads {args.n_heads}"
        )
    if args.moe_experts > 1 and args.moe_experts % n_model:
        raise SystemExit(
            f"model axis {n_model} must divide moe_experts "
            f"({args.moe_experts})"
        )
    # the port's own flag (the reference derives d_ff from d_model)
    if args.d_ff % n_model:
        raise SystemExit(
            f"model axis {n_model} must divide --d-ff {args.d_ff}"
        )
    if args.draft_layers > 0:
        if args.speculate < 1:
            raise SystemExit("--speculate must be >= 1")
        if not 0 < args.draft_layers < args.n_layers:
            raise SystemExit(
                f"--draft-layers must be in (0, {args.n_layers})"
            )
    validate_lora_flags(args.lora_dir, args.lora_rank)
    return cp_min_len, n_model


def _rank_stats(mirror: _SlotMirror, lockstep, mesh, base) -> str:
    """One rank's figures since warm-up, as the line it logs at exit:
    ops, the token digest and K1/K2 launches (the lockstep's own
    counters), captures, kernel builds and loads, program shapes first
    dispatched after warm-up, and the bytes its collectives staged
    through the host after warm-up."""
    from ..ops import _build, flash, quant

    return json.dumps({
        "rank": lockstep.rank, "ops": lockstep.ops,
        "tokens": lockstep.tokens, "digest": lockstep.digest(),
        "k1_launches": flash.LAUNCHES, "k2_launches": quant.LAUNCHES,
        "step_program": mirror.program.mode,
        "captures_after_warm": mirror.program.graphs - base["graphs"],
        "builds_after_warm": _build.BUILDS - base["builds"],
        "loads_after_warm": len(_build._libs) - base["loads"],
        "fresh_after_warm": [list(k) for k in mirror.fresh_after_warm],
        "staged_bytes": mesh.traffic["host_bytes"] - base["staged"],
    })


def main(argv=None) -> int:
    import signal as signal_mod

    from ..discovery import new_backend
    from ..models.speculative import layer_prefix_draft, warm_speculative
    from ..ops import _build
    from ..parallel.distributed import (
        DEFAULT_COORDINATOR_PORT,
        initialize_from_catalog,
    )
    from ..parallel.mesh import MeshPlan, make_mesh, rank_device
    from ..parallel.serving import DEFAULT_DEADLINE_S, Lockstep
    from ..parallel.watchdog import StepWatchdog
    from .serve_cli import load_model

    args = build_arg_parser().parse_args(argv)
    t0 = time.perf_counter()
    # armed BEFORE the rendezvous (the trainer's pattern): a peer that
    # died between registration and its first collective wedges this
    # rank as silently as a mid-serve death; the grace covers loading
    dog = None
    if args.watchdog > 0:
        dog = StepWatchdog(args.watchdog, exit_code=WATCHDOG_EXIT).start(
            grace_s=max(args.startup_grace, args.watchdog))
    n_global = args.num_processes
    cp_min_len, n_model = _refuse(args, n_global)
    device = rank_device(args.process_id, args.device)
    initialize_from_catalog(
        new_backend(args.catalog), args.process_id, args.num_processes,
        coordinator_port=args.coordinator_port or DEFAULT_COORDINATOR_PORT,
        advertise_address=args.advertise_address, device=device,
    )
    mesh = make_mesh(MeshPlan(data=args.dp, model=n_model, seq=args.sp),
                     device=device)
    deadline = args.watchdog or DEFAULT_DEADLINE_S
    lockstep = Lockstep(deadline).start(
        grace_s=max(args.startup_grace, deadline))
    if dog is not None:
        dog.stop()  # the lockstep's watchdog takes over
    front = args.process_id == 0
    joined_s = time.perf_counter() - t0
    print(f"pod rank {args.process_id} of {mesh.size}: mesh {mesh.shape} "
          f"on {device.type}, collectives over {mesh.backend}"
          + (", staged through host buffers" if mesh.staging else ""),
          flush=True)

    def say(line: str) -> None:
        if front:
            print(f"pod {line}", flush=True)

    cfg, params, checkpoint = load_model(args, mesh, device, say=say)
    if args.checkpoint_dir and checkpoint is None:
        raise SystemExit(f"no checkpoint in {args.checkpoint_dir}")

    draft = None
    if args.draft_layers > 0:
        draft_params, draft_cfg = layer_prefix_draft(
            params, cfg, args.draft_layers
        )
        draft = (draft_params, draft_cfg, args.speculate)

    frontend = None
    if front:
        frontend = _Frontend(
            args.host, args.port, args.max_len, cfg.vocab_size,
            text=args.text, stream_chunk=args.stream_chunk,
            slots=args.slots, cfg=cfg,
            prefix_entries=args.prefix_cache,
            pod_info={
                "vocab_size": cfg.vocab_size,
                "d_model": cfg.d_model,
                "n_heads": cfg.n_heads,
                "n_kv_heads": cfg.kv_heads,
                "n_layers": cfg.n_layers,
                "max_len": args.max_len,
                "text": args.text,
                "stream": True,
                "kv_int8": args.kv_int8,
                "window": args.window or None,
                "prefix_cache": (
                    {"entries": args.prefix_cache}
                    if args.prefix_cache > 0 else None
                ),
                "prefill_chunk": args.prefill_chunk or None,
                "moe_experts": cfg.moe_experts,
                "int8": args.int8,
                "lora": (
                    {"rank": args.lora_rank} if args.lora_dir else None
                ),
                "speculative": (
                    {
                        "draft_layers": args.draft_layers,
                        "speculate": args.speculate,
                    }
                    if draft is not None else None
                ),
                "slot_engine": {
                    "slots": args.slots,
                    "chunk": args.stream_chunk,
                    "window": max(1, args.slot_window),
                },
                "pod": {
                    "num_processes": args.num_processes,
                    "devices": n_global,
                    "mesh": {
                        "data": args.dp, "seq": args.sp,
                        "model": n_model,
                    },
                    "watchdog_s": args.watchdog or None,
                },
                "cp": (
                    {"seq": args.sp, "min_len": cp_min_len}
                    if args.sp > 1 else None
                ),
            },
        )
        frontend.start()
        print(f"pod frontend on {args.host}:{frontend.port} "
              f"({n_global} global devices, data={args.dp} "
              f"model={n_model}, slots={args.slots})", flush=True)
        # everything until ready flips is compile_warmup, stamped
        # before /health can answer 200
        frontend.ledger.set_override("compile_warmup")

    loaded_s = time.perf_counter() - t0
    if device.type == "cuda":
        # every kernel built and loaded now, never under traffic
        seconds = _build.build_all()
        for name in _build.sources():
            _build.load(name)
        print(f"pod rank {args.process_id}: CUDA kernels ready in "
              f"{seconds:.1f}s", flush=True)
    mirror = _SlotMirror(
        cfg, params, args.max_len, args.slots, args.stream_chunk,
        mesh=mesh, sp=args.sp, cp_min_len=cp_min_len,
        prefix_entries=args.prefix_cache,
        prefill_chunk=args.prefill_chunk,
        window=max(1, args.slot_window),
    )
    lockstep.register(pod_ops(mirror, lockstep, draft))
    if not front and args.wedge_file:
        _wedge_on_follower(lockstep, args.wedge_file)
    warm_pod(mirror)
    if draft is not None:
        draft_params, draft_cfg, spec_k = draft
        warm_speculative(params, draft_params, cfg, draft_cfg, spec_k,
                         args.max_len, mesh=mesh)
        mirror.use("spec", WARM_PLEN)
    mirror.mark_warm()
    lockstep.beat()  # start-up done: the deadline from here on
    base = {"graphs": mirror.program.graphs, "builds": _build.BUILDS,
            "loads": len(_build._libs),
            "staged": mesh.traffic["host_bytes"]}
    ready_s = time.perf_counter() - t0
    print(f"pod rank {args.process_id}: joined in {joined_s:.2f}s, loaded "
          f"in {loaded_s - joined_s:.2f}s, warm in {ready_s - loaded_s:.2f}s"
          f" (step program: {mirror.program.mode})", flush=True)

    if front:
        frontend.prefix_cache = mirror.prefix_cache
        frontend.ledger.clear_override()
        frontend.ledger.enter("idle")
        frontend.ready = True
        print("pod warm; accepting traffic", flush=True)
        # SIGTERM on the frontend shuts the whole pod down; a follower
        # keeps the default disposition
        stopping = threading.Event()
        signal_mod.signal(signal_mod.SIGTERM, lambda s, f: stopping.set())
        lockstep.start_checks()
        _run_frontend_loop(args, frontend, mirror, lockstep, stopping,
                           draft=draft)
    else:
        lockstep.follow()
    print(f"pod rank stats {_rank_stats(mirror, lockstep, mesh, base)}",
          flush=True)
    if frontend is not None:
        frontend.stop()
        print("pod frontend stopped", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
