"""The slot engine: continuous decode admission for serving (counterpart
of ``containerpilot_tpu/workload/serve_slots.py``).

``Batcher`` (serve_batcher.py) coalesces requests that ARRIVE together;
this engine lets requests JOIN a running decode. A fixed pool of S slots
decodes in fixed-size chunks (models/slots.py); between dispatches the
engine harvests finished rows and admits queued requests into free
slots, so a short request lands mid-flight next to a long one instead
of waiting for a whole batch generation.

The engine drives a step program (models/stepprog.py): on the card each
chunk is one replay of a CUDA graph captured at construction, and with
``window`` K > 1 a window is up to K replays with the early exit on the
device, so the host pays one dispatch per K rounds on steady decode. The
host re-enters at chunk granularity when a decision is pending (queued
admissions, a cancel, stop), and dispatches window N+1 before fetching
window N's tokens when none is (the one-window lookahead).

Per-request output equals a solo ``generate`` with the same arguments:
each slot samples from its own generator re-seeded as ``generate`` seeds
row 0, and a fused window runs the same step body as K sequential
chunks. With ``cp_mesh`` an admission whose prompt is at least
``cp_min_len`` long rings its prefill over the mesh's ``seq`` axis
(``parallel.context.cp_prefill_with_remainder``, the maximal head) before
it joins the pool. Not ported: the synthetic prefill floor.

Serving over ranks (``mesh``, ``lockstep``: parallel/serving.py), the
params are each rank's blocks and every device verb of the engine
(admit, dispatch, tokens, retire, reset) goes through the lockstep: the
front's engine broadcasts the verb and its host arguments before it
runs it, and each follower's engine (``worker=False``, no thread, no
queue) runs the same verb on its shard. Every decision (which request,
which slot, fused or not, the budgets) is the front's and travels with
the verb.

The device-time ledger (``ledger``, telemetry/goodput.py) is stamped
where the reference stamps it, on the worker thread at request
boundaries only: ``prefill`` when an admission starts, ``decode`` when
its first token is sampled, ``idle`` when the engine finds no live slot
(after the fetch that resolved the last window). Nothing is stamped
inside a window or a graph replay.

One engine per server process; it owns a worker thread and the step
program's device buffers. ``submit`` is thread-safe and returns a
concurrent.futures.Future resolving to the generated ids (pad-trimmed
after eos, capped at the request's max_new_tokens).
"""
from __future__ import annotations

import logging
import queue
import threading
import time
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Callable, List, Optional

import numpy as np
import torch

from ..models.decode import BIAS_SLOTS_MAX, normalize_logit_bias
from ..models.slots import append_chunk
from ..models.stepprog import make_step_program
from ..models.transformer import TransformerConfig
from ..parallel.context import cp_prefill_with_remainder, resolve_cp_min_len
from .serve_prefix import MIN_REUSE as PREFIX_MIN_REUSE
from .serve_prefix import prefill_row

log = logging.getLogger("containerpilot.serve.slots")


@dataclass
class _Request:
    tokens: List[int]
    max_new: int
    temperature: float
    top_k: int
    top_p: float
    eos_id: int
    pad_id: int
    seed: int
    min_new: int = 0
    presence: float = 0.0
    frequency: float = 0.0
    # [BIAS_SLOTS_MAX] logit_bias row (idx -1 = unused), always at the
    # engine's one static width
    bias_idx: Optional[object] = None
    bias_val: Optional[object] = None
    # streaming: called from the worker thread with each newly emitted
    # delta (eos/max_new-capped: concatenation equals the final result)
    on_tokens: Optional[Callable] = None
    # cooperative cancel: the worker frees the slot at the next chunk
    # boundary instead of decoding to the end
    cancel: Optional[threading.Event] = None
    # tracing: a caller-owned dict stamped at request boundaries only
    # (enqueued/admitted/prefill_done/done on time.monotonic, plus rounds)
    timings: Optional[dict] = None
    future: Future = field(default_factory=Future)


# what a follower's engine needs of a request to replay its admission
_DEVICE_FIELDS = ("tokens", "max_new", "temperature", "top_k", "top_p",
                  "eos_id", "pad_id", "seed", "min_new", "presence",
                  "frequency", "bias_idx", "bias_val")
# the engine's device verbs, each ``SlotEngine._do_<verb>``
VERBS = ("admit", "dispatch", "tokens", "retire", "reset")


@dataclass
class _Slot:
    req: _Request
    emitted: List[int] = field(default_factory=list)
    finished: bool = False  # eos seen or max_new reached
    rounds: int = 0  # decode rounds this row rode


class SlotEngine:
    def __init__(
        self,
        cfg: TransformerConfig,
        params,
        max_len: int,
        slots: int = 8,
        chunk: int = 8,
        window: int = 4,
        cp_mesh=None,
        prefill_chunk: int = 0,
        prefix_cache=None,
        ledger=None,
        program=None,
        cp_min_len: int = 0,
        mesh=None,
        lockstep=None,
        worker: bool = True,
    ) -> None:
        if slots < 1 or chunk < 1:
            raise ValueError("slots and chunk must be >= 1")
        if window < 1:
            raise ValueError("window must be >= 1")
        # context-parallel admission: prompts at least cp_min_len long
        # ring their prefill over cp_mesh's seq axis, the maximal head
        if cp_mesh is not None and cfg.window > 0:
            raise ValueError(
                "cp does not compose with sliding windows (ring "
                "attention rejects them)"
            )
        self.cp_mesh = cp_mesh
        self.cp_min_len = cp_min_len
        if cp_mesh is not None:
            if cp_mesh.shape.get("seq", 1) <= 1:
                raise ValueError(
                    "--cp mesh needs a seq axis > 1 (MeshPlan(seq=...))"
                )
            # the ONE threshold policy (derive/clamp/never-engages),
            # whoever constructs the engine
            self.cp_min_len = resolve_cp_min_len(
                cp_min_len, cp_mesh.shape.get("seq", 1), max_len
            )
        # the mesh the params are blocks of (the cp mesh serves both)
        self.mesh = mesh if mesh is not None else cp_mesh
        if prefill_chunk < 0:
            raise ValueError("prefill_chunk must be >= 0")
        # chunked admission: prompts longer than prefill_chunk prefill in
        # pieces (models/decode.chunked_prefill)
        self.prefill_chunk = prefill_chunk
        # prefix KV reuse: admissions with a cached prefix copy, rewind
        # and extend instead of a full prefill, and every admission's
        # prompt cache is stored; entries stay standalone because
        # reuse_admission extends a copy and insert_row copies the row
        # into the pool
        self.prefix_cache = prefix_cache
        if prefix_cache is not None and cp_mesh is not None:
            raise ValueError(
                "prefix cache does not compose with cp (cached "
                "prefixes bypass the ring)"
            )
        if prefix_cache is not None and cfg.window > 0:
            raise ValueError(
                "prefix cache does not compose with sliding "
                "windows (a ring cache's stale rows are live "
                "window context)"
            )
        # sliding windows compose: each slot's ring is row-local and
        # admission copies the prefilled row wholesale (insert_row), so
        # a reused slot carries no context of its previous occupant;
        # chunked admission caps its pieces at the ring
        # (chunked_prefill)
        # device-time ledger: the engine is the authority on prefill/
        # decode/idle, stamped at request boundaries only (None costs one
        # attribute load there)
        self.ledger = ledger
        # dispatch accounting (the dispatches/token series): one bump per
        # device dispatch (an admission counts one), one add per token
        self.dispatches = 0
        self.tokens_out = 0
        self.cfg = cfg
        self.params = params
        self.max_len = max_len
        self.device = params["norm_out"].device
        # the step program (models/stepprog.py): the pool, the per-slot
        # sampling state and, on a card, the captured round graph. None
        # builds the default for the params (plain or quantized); an
        # explicit program (e.g. speculative) brings its own slots and
        # chunk, which win
        if program is None:
            program = make_step_program(
                cfg, params, max_len, slots, chunk, rounds=window,
                mesh=self.mesh,
            )
        self.program = program
        # dispatched windows whose tokens are not fetched yet, oldest
        # first (the lookahead keeps at most two)
        self._handles: "deque" = deque()
        self.lockstep = lockstep
        if lockstep is not None:
            lockstep.register({f"slot.{verb}": getattr(self, f"_do_{verb}")
                               for verb in VERBS})
        self.slots = program.slots
        self.chunk = program.chunk
        self.window = program.rounds
        self._active: List[Optional[_Slot]] = [None] * self.slots
        # wall and host-only seconds of recent decode-only rounds
        self._round_times: "deque[float]" = deque(maxlen=1024)
        self._round_host_times: "deque[float]" = deque(maxlen=1024)
        self._queue: "queue.Queue[Optional[_Request]]" = queue.Queue()
        self._submit_lock = threading.Lock()
        self._stopped = threading.Event()
        self._thread = None
        if worker:
            self._thread = threading.Thread(
                target=self._run, name="slot-engine", daemon=True
            )
            self._thread.start()

    # ------------------------------------------------------------- API

    def submit(
        self,
        tokens: List[int],
        max_new: int,
        temperature: float = 0.0,
        top_k: int = 0,
        top_p: float = 0.0,
        eos_id: int = -1,
        pad_id: int = 0,
        seed: int = 0,
        min_new: int = 0,
        presence_penalty: float = 0.0,
        frequency_penalty: float = 0.0,
        logit_bias=None,
        on_tokens: Optional[Callable] = None,
        cancel: Optional[threading.Event] = None,
        timings: Optional[dict] = None,
    ) -> Future:
        """Queue one sequence; resolves to its generated ids.
        ``logit_bias`` is a {token_id: bias} dict, validated here so a
        bad request fails the submit, not the pool."""
        if max_new < 1:
            raise ValueError("max_new must be >= 1")
        if not 0 <= min_new <= max_new:
            raise ValueError("min_new must be in [0, max_new]")
        if not tokens or len(tokens) >= self.max_len:
            raise ValueError(
                f"prompt must be 1..{self.max_len - 1} tokens"
            )
        if len(tokens) + max_new > self.max_len:
            raise ValueError(
                f"prompt {len(tokens)} + max_new {max_new} exceeds "
                f"max_len {self.max_len}"
            )
        rows_idx, rows_val = normalize_logit_bias(
            self.cfg, 1, logit_bias or None, slots=BIAS_SLOTS_MAX
        )
        req = _Request(
            tokens=list(tokens), max_new=int(max_new),
            temperature=float(temperature), top_k=int(top_k),
            top_p=float(top_p), eos_id=int(eos_id), pad_id=int(pad_id),
            seed=int(seed), min_new=int(min_new),
            presence=float(presence_penalty),
            frequency=float(frequency_penalty),
            bias_idx=rows_idx[0], bias_val=rows_val[0],
            on_tokens=on_tokens, cancel=cancel, timings=timings,
        )
        if timings is not None:
            timings["enqueued"] = time.monotonic()
        # atomic with stop()'s drain
        with self._submit_lock:
            if self._stopped.is_set():
                raise RuntimeError("engine is stopped")
            self._queue.put(req)
        return req.future

    def stop(self) -> None:
        with self._submit_lock:
            self._stopped.set()
        self._queue.put(None)  # wake the worker
        if self._thread is not None:
            self._thread.join(timeout=30)
        for slot in self._active:
            if slot is not None and not slot.req.future.done():
                slot.req.future.cancel()
        while True:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                break
            if req is not None and not req.future.done():
                req.future.cancel()

    @property
    def stats(self) -> dict:
        return {
            "slots": self.slots,
            "chunk": self.chunk,
            # decode rounds fused per host dispatch
            "window": self.window,
            "active": sum(s is not None for s in self._active),
            "queued": self._queue.qsize(),
            "dispatches": self.dispatches,
            "tokens_out": self.tokens_out,
        }

    def round_times_ms(self) -> List[float]:
        """Wall time of recent decode-only rounds (ms): dispatch + token
        fetch + host bookkeeping, admission rounds excluded."""
        return [t * 1e3 for t in list(self._round_times)]

    def round_host_ms(self) -> List[float]:
        """Host-only time of the same rounds (ms): round wall time minus
        the time inside the step program's dispatch and token fetch."""
        return [t * 1e3 for t in list(self._round_host_times)]

    # ----------------------------------------------------------- worker

    def _prefill(self, req: _Request):
        """The serving paths' admission policy (``prefill_row``), or the
        cp ring for a long prompt under ``cp_mesh``. Prompts shorter
        than MIN_REUSE can never be reused, so they skip the prefix
        machinery (this also keeps warmup's request out of it); the
        stored row cache is never written again, because the pool copies
        it. Returns (logits [1, vocab], row_cache)."""
        if self.cp_mesh is not None and len(req.tokens) >= self.cp_min_len:
            return cp_prefill_with_remainder(
                self.params, np.asarray([req.tokens], np.int64), self.cfg,
                self.cp_mesh, self.max_len, prefill_chunk=self.prefill_chunk,
            )
        pc = self.prefix_cache
        if len(req.tokens) < PREFIX_MIN_REUSE:
            pc = None
        if pc is not None:
            pc.readmit_seconds = 0.0
        out = prefill_row(pc, req.tokens, self.cfg, self.params,
                          self.max_len, self.prefill_chunk, self.mesh)
        if pc is not None and pc.readmit_seconds > 0.0:
            # a spilled base copied back to the device: the trace's
            # ``kv`` stage and the ledger's kv_readmit, carved out of
            # the prefill window
            if req.timings is not None:
                req.timings["kv"] = pc.readmit_seconds
            if self.ledger is not None:
                self.ledger.carve("kv_readmit", pc.readmit_seconds)
        return out

    def _admit(self, slot_id: int, req: _Request) -> None:
        """Prefill the prompt (engine policy) and hand the result to the
        step program, which samples token 0 and writes the slot."""
        if req.timings is not None:
            req.timings["admitted"] = time.monotonic()
        if self.ledger is not None:
            self.ledger.enter("prefill")
        first_host = self._device("admit", slot_id, req)
        state = _Slot(req=req, emitted=[first_host])
        if first_host == req.eos_id or req.max_new <= 1:
            state.finished = True
        self._active[slot_id] = state
        self.dispatches += 1
        self.tokens_out += 1
        if req.timings is not None:
            req.timings["prefill_done"] = time.monotonic()
        if self.ledger is not None:
            self.ledger.enter("decode")
        self._notify(req, [first_host])

    def _harvest(self, slot_id: int) -> None:
        state = self._active[slot_id]
        req = state.req
        out = state.emitted[: req.max_new]
        if req.eos_id >= 0 and req.eos_id in out:
            # keep the eos, pad-trim what follows
            out = out[: out.index(req.eos_id) + 1]
        if req.timings is not None:
            req.timings["done"] = time.monotonic()
            req.timings["rounds"] = state.rounds
        self._active[slot_id] = None
        self._device("retire", slot_id)
        if not req.future.done():
            req.future.set_result(out)

    @staticmethod
    def _notify(req: _Request, delta: List[int]) -> None:
        """Deliver a streamed delta; a raising callback must never
        escape into _run (it would kill the worker thread)."""
        if req.on_tokens is None:
            return
        try:
            req.on_tokens(list(delta))
        except Exception:  # noqa: BLE001
            log.exception("on_tokens callback failed; dropping delta")

    def _sweep_cancelled(self) -> None:
        """Free slots whose requests were cancelled, at this window
        boundary; the future resolves with the partial emission."""
        for i, s in enumerate(self._active):
            if (
                s is not None
                and s.req.cancel is not None
                and s.req.cancel.is_set()
            ):
                if s.req.timings is not None:
                    s.req.timings["done"] = time.monotonic()
                    s.req.timings["rounds"] = s.rounds
                self._active[i] = None
                self._device("retire", i)
                if not s.req.future.done():
                    s.req.future.set_result(list(s.emitted))
                log.info(
                    "slot %d freed mid-generation (%d/%d tokens): "
                    "request cancelled", i, len(s.emitted), s.req.max_new,
                )

    def _fail_and_rebuild(self, exc: Exception) -> None:
        """Fail every in-flight request once, and bring the program's
        buffers back to the empty state."""
        log.exception("slot dispatch failed")
        for i, s in enumerate(self._active):
            if s is not None and not s.req.future.done():
                s.req.future.set_exception(exc)
            self._active[i] = None
        self._device("reset")

    # -- device verbs ---------------------------------------------------
    # The only calls that touch the device. Under a lockstep each goes to
    # the followers first with its host arguments (a request travels as
    # its _DEVICE_FIELDS), and their engines run the same _do_<verb>.

    def _device(self, verb: str, *args):
        if self.lockstep is None:
            return getattr(self, f"_do_{verb}")(*args)
        wire = tuple(
            {f: getattr(a, f) for f in _DEVICE_FIELDS}
            if isinstance(a, _Request) else a for a in args)
        return self.lockstep.call(f"slot.{verb}", wire)

    def _do_admit(self, slot_id: int, req) -> int:
        """Prefill the prompt (engine policy) and hand the result to the
        step program, which samples token 0 and writes the slot."""
        if isinstance(req, dict):
            req = _Request(**req)
        logits, row_cache = self._prefill(req)
        return self.program.admit(slot_id, req, logits, row_cache)

    def _do_dispatch(self, budgets, fused: bool):
        handle = self.program.dispatch(budgets, fused)
        self._handles.append(handle)
        return handle

    def _do_tokens(self):
        """The oldest dispatched window's tokens (the loop fetches in
        dispatch order)."""
        toks, valid, rounds_run = self.program.tokens(self._handles.popleft())
        if self.lockstep is not None:
            self.lockstep.record_tokens(toks)
        return toks, valid, rounds_run

    def _do_retire(self, slot_id: int) -> None:
        self.program.retire(slot_id)

    def _do_reset(self) -> None:
        self._handles.clear()
        self.program.reset()

    def _cancel_pending(self) -> bool:
        return any(
            s is not None
            and s.req.cancel is not None
            and s.req.cancel.is_set()
            for s in self._active
        )

    def _budgets(self, in_flight: int = 0) -> np.ndarray:
        """Per-slot remaining max_new allowance, the window's early-exit
        gate (it never masks emission). ``in_flight``: tokens a
        dispatched window not yet fetched emits for every slot it keeps
        live. A lookahead window's budgets take them off, so the step
        program does not replay rounds nobody needs: if that window
        stops early, every slot is done or out of budget and needs no
        more tokens, so the smaller budget is still an upper bound for
        each slot that does."""
        budgets = np.zeros((self.slots,), np.int64)
        for i, s in enumerate(self._active):
            if s is not None:
                budgets[i] = max(s.req.max_new - len(s.emitted) - in_flight,
                                 0)
        return budgets

    def _run(self) -> None:
        with torch.inference_mode():
            self._loop()

    def _loop(self) -> None:
        # one-window lookahead: the handle of a window already dispatched
        # for the next cycle (None = serial)
        pending = None
        program = self.program
        while not self._stopped.is_set():
            t0 = time.perf_counter()
            device_s = 0.0  # time inside the program's calls this cycle
            admitted = False
            if pending is None:
                self._sweep_cancelled()
                free = [
                    i for i, s in enumerate(self._active) if s is None
                ]
                any_active = any(s is not None for s in self._active)
                if not any_active and self.ledger is not None:
                    # fully idle: flips to ``idle`` only out of prefill/
                    # decode (engine_idle), so it cannot cut the server's
                    # boot/warmup stages short
                    self.ledger.engine_idle()
                # block for work only when fully idle; otherwise drain
                # whatever is queued into free slots and keep decoding
                try:
                    block = not any_active
                    while free:
                        req = self._queue.get(block=block, timeout=None)
                        if req is None:  # stop sentinel
                            return
                        block = False
                        t0 = time.perf_counter()  # exclude idle wait
                        admitted = True
                        if req.cancel is not None and req.cancel.is_set():
                            req.future.cancel()  # left before admission
                            continue
                        try:
                            self._admit(free.pop(0), req)
                        except Exception as exc:  # noqa: BLE001
                            if not req.future.done():
                                req.future.set_exception(exc)
                except queue.Empty:
                    pass
                # harvest admissions that finished at token 0
                for i, s in enumerate(self._active):
                    if s is not None and s.finished:
                        self._harvest(i)
                if not any(s is not None for s in self._active):
                    continue
                # fuse K rounds only when no host decision can be
                # pending: a fresh admission or a queued request keeps
                # the single-chunk dispatch
                fused = (
                    not admitted
                    and self._queue.empty()
                    and not self._cancel_pending()
                )
                tj = time.perf_counter()
                try:
                    handle = self._device("dispatch", self._budgets(), fused)
                except Exception as exc:  # noqa: BLE001
                    self._fail_and_rebuild(exc)
                    continue
                device_s += time.perf_counter() - tj
                self.dispatches += program.dispatch_cost
            else:
                handle, pending = pending, None
            # one-window lookahead: with no decision pending, dispatch
            # window N+1 before fetching window N's tokens, so the fetch
            # and the bookkeeping below overlap N+1's device work; not
            # when window N already covers every slot's budget, and not
            # for a program whose next dispatch depends on this one's
            # tokens (speculative acceptance)
            ahead = (self._budgets(handle.rounds * self.chunk)
                     if program.supports_lookahead else None)
            if (
                ahead is not None
                and ahead.any()
                and self._queue.empty()
                and not self._cancel_pending()
            ):
                tj = time.perf_counter()
                try:
                    pending = self._device("dispatch", ahead, True)
                except Exception as exc:  # noqa: BLE001
                    self._fail_and_rebuild(exc)
                    pending = None
                    continue
                device_s += time.perf_counter() - tj
                self.dispatches += program.dispatch_cost
            tj = time.perf_counter()
            try:
                toks_host, valid, rounds_run = self._device("tokens")
            except Exception as exc:  # noqa: BLE001
                self._fail_and_rebuild(exc)
                pending = None
                continue
            device_s += time.perf_counter() - tj
            for i, state in enumerate(self._active):
                if state is None:
                    continue
                state.rounds += rounds_run
                req = state.req
                before = len(state.emitted)
                ended = append_chunk(
                    state.emitted, toks_host[i][: valid[i]],
                    req.max_new, req.eos_id,
                )
                if len(state.emitted) > before:
                    self.tokens_out += len(state.emitted) - before
                    self._notify(req, state.emitted[before:])
                if ended:
                    self._harvest(i)
            if not admitted:
                wall = time.perf_counter() - t0
                self._round_times.append(wall)
                self._round_host_times.append(max(wall - device_s, 0.0))
