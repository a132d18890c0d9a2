"""The step program: the slot engine's device side (counterpart of
``containerpilot_tpu/models/stepprog.py``).

A step program owns the device state of a fixed pool of S slots (the
pool cache, with a window's ring and the int8 cache's scales, the
per-slot sampling state, the window buffers) with static shapes per
``(config, S, chunk, K)``, and exposes the reference's verbs:

- ``admit(slot, req, logits, row_cache)``: sample token 0 from the
  engine's prefill (the draw from the slot's key, ``row_key(req.seed,
  req.row)``), copy the row into the pool and write the slot's state;
  returns token 0 as a host int;
- ``dispatch(budgets, fused)``: advance every slot one chunk, or up to
  K chunk-rounds with the early exit (``fused=True``); never waits on
  the device, returns a handle;
- ``tokens(handle)``: the one deliberate host sync of a window ->
  ``(toks [S, W], valid [S], rounds_run)``;
- ``retire(slot)`` and ``reset()`` (back to the empty state after a
  failed dispatch).

On a CUDA device the program captures ONE CUDA graph at construction,
before the server reports healthy and never under traffic: a chunk-
round of the shared step body (``slots.gated_round``). A chunk is one
replay with the round forced; a window is up to K replays enqueued back
to back with no host sync in between, each starting from the
device-side live flag, so rounds after the early exit change nothing
(the host leaves out the rounds no budget can use). The budgets
go in through a pinned staging buffer in stream order; the tokens and
rounds_run come out through a non_blocking copy into the dispatch's own
pinned buffers, enqueued right after its replays, with an event that
``tokens`` waits on. A lookahead dispatch can therefore overwrite the
graph's static token buffer without racing the previous window's copy.
There is no fallback: on CUDA the program captures or raises. On the
CPU it runs the same round eagerly.

On a mesh (``mesh=``, serving over ranks, parallel/serving.py) with a
live ``model`` axis the round calls the tensor-parallel collectives.
Where they are staged through host buffers (gloo for ranks that share a
card, ``mesh.staging``) a graph cannot capture them, and NCCL
collectives inside a captured round are not ported, so the program runs
its round uncaptured on the card: the choice is made from the mesh at
construction (``step_program_mode``), never from a failed capture, and
the server prints it and reports it in ``/v1/model``. A mesh whose round
makes no collective (``model`` 1: context parallelism alone rings only
the prefill) captures as on one card.

The graph reads every position from the pool's device ``pos`` (RoPE,
the write slot, the ring mask), never from a host value, so one capture
serves every admission at every position.

The slots' sampling keys are one of the graph's static buffers
(``state["keys"]``, [S, 2] threefry words): a replay draws each slot's
step from ``fold_in(key, step_idx)`` in the draw kernel, as the eager
step does, and admission writes a slot's key in place. No generator
state is registered with the graph.

Kernel launch counters (``ops.quant.LAUNCHES``, ``ops.flash.LAUNCHES``,
``ops.draw.LAUNCHES``) count Python calls, and a replay makes none: the program records each
counter's increase during capture, takes it back (a capture executes
nothing) and adds it again on every replay, so the counters mean
launches executed.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List

import numpy as np
import torch

from ..ops import draw, flash, quant
from .slots import (
    admit_slot_state,
    begin_window,
    clear_slot_state,
    first_sample,
    gated_round,
    init_slot_state,
    insert_row,
    retire_slot,
    seed_slot,
    slot_cache,
    window_buffers,
)
from .transformer import Params, TransformerConfig

_COUNTERS = ((quant, "LAUNCHES"), (flash, "LAUNCHES"), (draw, "LAUNCHES"))

# dispatches whose tokens may be outstanding at once: the engine's
# one-window lookahead needs two
_HANDLES = 3


def _counts() -> List[int]:
    return [getattr(mod, name) for mod, name in _COUNTERS]


def step_program_mode(device, mesh=None) -> str:
    """How a step program runs its round: ``"graph"`` (one CUDA graph
    captured at construction, replayed), ``"eager"`` (the CPU), or
    ``"uncaptured"`` (a card whose round calls collectives: host-staged
    under gloo, which a graph cannot capture; NCCL's, whose capture is
    not ported)."""
    if torch.device(device).type != "cuda":
        return "eager"
    if mesh is not None and mesh.axis_size("model") > 1:
        return "uncaptured"
    return "graph"


class _Handle:
    """One dispatch's host side: its budgets staging buffer, its token
    and rounds_run buffers (pinned on CUDA) and the event after the
    copies."""

    def __init__(self, slots: int, width: int, device: torch.device):
        pin = device.type == "cuda"
        self.budget = torch.zeros((slots,), dtype=torch.int64,
                                  pin_memory=pin)
        self.toks = torch.zeros((slots, width), dtype=torch.int64,
                                pin_memory=pin)
        self.run = torch.zeros((), dtype=torch.int64, pin_memory=pin)
        self.event = torch.cuda.Event() if pin else None
        self.window = False
        # round replays enqueued (a window: at most K)
        self.rounds = 0


class PlainStepProgram:
    """The plain transformer's step program: the slot pool plus the
    per-slot sampling state, advanced one chunk (``fused=False``) or up
    to ``rounds`` chunk-rounds (``fused=True``) per dispatch."""

    supports_lookahead = True
    dispatch_cost = 1

    @torch.inference_mode()
    def __init__(
        self,
        cfg: TransformerConfig,
        params: Params,
        max_len: int,
        slots: int,
        chunk: int,
        rounds: int = 1,
        mesh=None,
    ) -> None:
        if slots < 1 or chunk < 1 or rounds < 1:
            raise ValueError("slots, chunk and rounds must be >= 1")
        self.cfg = cfg
        self.params = params
        self.mesh = mesh
        self.max_len = max_len
        self.slots = slots
        self.chunk = chunk
        self.rounds = rounds
        self.device = params["norm_out"].device
        self._pool = slot_cache(cfg, slots, max_len, device=self.device,
                                mesh=mesh)
        self._state = init_slot_state(cfg, slots, device=self.device)
        self._win = window_buffers(slots, chunk, rounds, self.device)
        self._free = [
            _Handle(slots, rounds * chunk, self.device)
            for _ in range(_HANDLES)
        ]
        self._all_handles = list(self._free)
        self._graph = None
        # launches one replay executes, per counter (_COUNTERS order)
        self.replay_launches = [0] * len(_COUNTERS)
        # launches added by replays since construction, per counter
        self.replayed_launches = [0] * len(_COUNTERS)
        # CUDA graphs captured (one, at construction, on a card), when
        # (time.monotonic()) and in how many seconds (warm-up, capture
        # and first replay)
        self.graphs = 0
        self.captured_at = None
        self.capture_seconds = 0.0
        self.mode = step_program_mode(self.device, mesh)
        if self.mode == "graph":
            self._capture()

    # ---------------------------------------------------------- device

    def _round(self) -> None:
        gated_round(self.params, self._pool, self._state, self.cfg,
                    self.chunk, self._win, self.mesh)

    def _capture(self) -> None:
        """Warm the round eagerly on the capture stream (kernel builds,
        K2's split-k workspace, cuBLAS workspaces and the sort's scratch
        are made there, outside the graph's pool), capture one round,
        replay it once to upload it, then bring the buffers back to the
        empty state. Raises on any failure: nothing falls back."""
        t0 = time.perf_counter()
        stream = torch.cuda.Stream(self.device)
        stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(stream):
            begin_window(self._state, self._win, force=False)
            self._round()
        torch.cuda.current_stream(self.device).wait_stream(stream)
        torch.cuda.synchronize(self.device)
        graph = torch.cuda.CUDAGraph()
        before = _counts()
        with torch.cuda.graph(graph, stream=stream,
                              capture_error_mode="thread_local"):
            self._round()
        after = _counts()
        self.replay_launches = [a - b for a, b in zip(after, before)]
        for (mod, name), n in zip(_COUNTERS, self.replay_launches):
            setattr(mod, name, getattr(mod, name) - n)  # nothing ran
        self._graph = graph
        self._run_round()  # the first replay uploads the graph
        torch.cuda.synchronize(self.device)
        self.reset()
        self.graphs += 1
        self.captured_at = time.monotonic()
        self.capture_seconds = time.perf_counter() - t0

    def _run_round(self) -> None:
        if self._graph is None:
            self._round()
            return
        self._graph.replay()
        for i, ((mod, name), n) in enumerate(
                zip(_COUNTERS, self.replay_launches)):
            setattr(mod, name, getattr(mod, name) + n)
            self.replayed_launches[i] += n

    # ------------------------------------------------------------ verbs

    @torch.inference_mode()
    def reset(self) -> None:
        """The empty state, in place (a captured graph holds these
        buffers): pool zeroed, every slot done, every handle free."""
        if self.device.type == "cuda":
            # a failed dispatch may leave copies in flight on the handles
            torch.cuda.synchronize(self.device)
        for leaf in self._pool.values():
            leaf.zero_()
        clear_slot_state(self._state)
        self._win["budget"].zero_()
        begin_window(self._state, self._win, force=False)
        self._free = list(self._all_handles)

    @torch.inference_mode()
    def admit(self, slot: int, req: Any, logits: torch.Tensor,
              row_cache: Dict[str, Any]) -> int:
        """Sample token 0 from ``logits`` [1, vocab] with the slot's key
        written for ``req.seed`` and row ``req.row``, copy the prefilled
        row into the pool and write the slot's state; returns token 0."""
        key = seed_slot(self._state, slot, req.seed, req.row)
        first = first_sample(
            logits, key, req.temperature, req.top_k, req.top_p,
            eos_id=req.eos_id, min_new=req.min_new,
            bias_idx=req.bias_idx, bias_val=req.bias_val,
        )
        first_host = int(first)
        insert_row(self._pool, row_cache, slot)
        admit_slot_state(
            self._state, slot, self.cfg, last=first,
            temperature=req.temperature, top_k=req.top_k,
            top_p=req.top_p, eos_id=req.eos_id, pad_id=req.pad_id,
            min_new=req.min_new, presence=req.presence,
            frequency=req.frequency, bias_idx=req.bias_idx,
            bias_val=req.bias_val,
            done=first_host == req.eos_id or req.max_new <= 1,
        )
        return first_host

    @torch.inference_mode()
    def retire(self, slot: int) -> None:
        retire_slot(self._state, slot)

    # cpcheck: hotpath — the fused window dispatch: the chunk or window
    # is enqueued with zero host syncs (the budgets upload is async)
    @torch.inference_mode()
    def dispatch(self, budgets, fused: bool) -> _Handle:
        """Enqueue one chunk, or (``fused`` and K > 1) a window of up to K
        rounds; no host sync. ``budgets`` [S] ints: each slot's
        remaining max_new allowance, the early-exit gate.

        A window replays only the rounds a budget can still use,
        ceil(max(budgets) / chunk) of the K: a later round fails the
        exit test for every slot (``run * chunk >= budget``), so leaving
        it out changes no token and no state. An exit on eos (every
        slot done) is taken on the device: the rounds after it replay
        and change nothing."""
        if not self._free:
            raise RuntimeError(
                "step program: every dispatch handle is in use (fetch "
                "tokens before dispatching again)"
            )
        h = self._free.pop()
        budgets = np.asarray(budgets, np.int64)  # cpcheck: disable=CP-HOTSYNC host-side numpy only, no device operand
        h.window = fused and self.rounds > 1
        h.rounds = 1
        if h.window:
            most = int(budgets.max(initial=0))
            h.rounds = min(self.rounds, -(-most // self.chunk))
        h.budget.copy_(torch.from_numpy(budgets))
        self._win["budget"].copy_(h.budget, non_blocking=True)
        begin_window(self._state, self._win, force=not h.window)
        for _ in range(h.rounds):
            self._run_round()
        h.toks.copy_(self._win["toks"], non_blocking=True)
        h.run.copy_(self._win["run"], non_blocking=True)
        if h.event is not None:
            h.event.record()
        return h

    # cpcheck: hotpath — the one deliberate sync per window
    def tokens(self, handle: _Handle):
        """Wait for the handle's copies (the one deliberate sync of a
        window) -> (toks [S, rounds_run * chunk], valid [S],
        rounds_run)."""
        if handle.event is not None:
            handle.event.synchronize()  # cpcheck: disable=CP-HOTSYNC the per-window token fetch
        rounds_run = int(handle.run) if handle.window else 1
        width = rounds_run * self.chunk
        toks = handle.toks.numpy()[:, :width].copy()  # cpcheck: disable=CP-HOTSYNC the per-window token fetch (a pinned host read after the event)
        self._free.append(handle)
        valid = np.full((self.slots,), width, np.int64)
        return toks, valid, rounds_run


def make_step_program(
    cfg: TransformerConfig,
    params: Params,
    max_len: int,
    slots: int,
    chunk: int,
    rounds: int = 1,
    mesh=None,
):
    """The default step program for a params dict: quantized params get
    the quantized program, everything else the plain one."""
    from .quantized import QuantizedStepProgram, is_quantized

    kind = (
        QuantizedStepProgram if is_quantized(params)
        else PlainStepProgram
    )
    return kind(cfg, params, max_len, slots, chunk, rounds=rounds, mesh=mesh)
