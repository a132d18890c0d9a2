"""The serving lockstep: ranks that replay the front's device calls.

The reference serves ``--tp N --cp M`` from one process that drives
every device of its mesh, and XLA inserts the collectives. Here a mesh
is a ``torch.distributed`` world with one process a rank
(parallel/mesh.py), and every collective of the model must be called by
every rank in the same order. This module is the port's own
counterpart of that single program, as ``collectives.py`` is of the
collectives XLA inserts:

- rank 0, the FRONT, runs the HTTP server and the ``InferenceServer``.
  Before each device call (a Batcher batch, ``run_chunked``,
  ``run_cp``, ``/v1/score``, a slot admission, dispatch, token fetch or
  retire, the warmup), ``Lockstep.call`` broadcasts one op descriptor
  (its name and host arguments) over a gloo group of the world, then
  runs the op itself;
- every other rank, a FOLLOWER, has no HTTP surface: ``follow`` receives
  each descriptor and runs the same registered handler on its shard, so
  every collective inside meets its peers. A request the front refuses
  never becomes an op.

The op channel is host-side (gloo over the whole world, whatever backend
carries the model's collectives), and ops run one at a time under one
lock on the front, so the slot engine's thread and the inference thread
interleave the same way on every rank.

Failure is never served around. Every rank's ``StepWatchdog`` is armed
from ``start`` (its first deadline covers loading and warmup) and beats
at the end of every op; while the front is idle, a ``check`` op every
quarter of the deadline (``start_checks``) proves every follower alive
and answering, and feeds their own watchdogs. A follower that exits
breaks the channel: the front exits ``EXIT_CODE``. A follower that
wedges leaves the front inside a collective past its deadline: the
watchdog exits it, after every thread's stack is written to stderr. A
front that dies or wedges does the same to its followers. ``shutdown``
is an op of its own.

Every op that yields tokens or scores folds them into a per-rank digest
(``record_tokens``); ``check`` gathers every rank's digest, op count and
kernel launch counts, and the front reports whether the ranks agree
(``/v1/model``'s ``lockstep``). State that each rank keeps of its own
but that the op order must keep equal, such as a prefix cache's keys in
LRU order, joins the check through ``watch``: a digest of it is
gathered with the rest and must agree too.
"""
from __future__ import annotations

import datetime
import faulthandler
import hashlib
import logging
import os
import sys
import threading
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch.distributed as dist

from .watchdog import EXIT_CODE, StepWatchdog

log = logging.getLogger("containerpilot.serving")

DEFAULT_DEADLINE_S = 600.0


class Lockstep:
    """One rank's side of the lockstep over the world (every rank
    constructs it at the same point: it makes a process group)."""

    def __init__(self, deadline_s: float = DEFAULT_DEADLINE_S) -> None:
        if deadline_s <= 0:
            raise ValueError("deadline_s must be > 0")
        self.rank = dist.get_rank()
        self.size = dist.get_world_size()
        self.front = self.rank == 0
        self.deadline_s = deadline_s
        # the op channel: host-side whatever carries the model
        self.group = dist.new_group(
            list(range(self.size)), backend="gloo",
            timeout=datetime.timedelta(seconds=max(4 * deadline_s, 300.0)))
        self.handlers: Dict[str, Callable] = {"check": self._check}
        # name -> digest of rank-local state that must agree (``watch``)
        self.watched: Dict[str, Callable[[], str]] = {}
        self.ops = 0
        self.tokens = 0
        self._digest = hashlib.blake2b(digest_size=8)
        self._lock = threading.Lock()
        self._last = time.monotonic()
        self._dog = StepWatchdog(deadline_s)
        self._stopped = threading.Event()
        self._pinger: Optional[threading.Thread] = None
        self.last_check: Optional[Dict[str, Any]] = None

    def register(self, handlers: Dict[str, Callable]) -> None:
        """Add op handlers (name -> callable of the op's arguments); the
        front and every follower register the same names."""
        self.handlers.update(handlers)

    def watch(self, name: str, digest: Callable[[], str]) -> None:
        """Hold rank-local state to agreement: ``digest()`` (a string,
        equal on every rank while the state is) joins every ``check``
        under ``name``."""
        self.watched[name] = digest

    # -- the front ------------------------------------------------------

    def start(self, grace_s: Optional[float] = None) -> "Lockstep":
        """Arm the watchdog; ``grace_s`` widens the first deadline (for
        loading and warmup)."""
        self._dog.start(grace_s=grace_s)
        self._stacks_before(grace_s or self.deadline_s)
        return self

    def start_checks(self) -> None:
        """On the front, once the server is built: the idle-time check."""
        self._pinger = threading.Thread(target=self._ping_loop,
                                        name="lockstep-check", daemon=True)
        self._pinger.start()

    def beat(self) -> None:
        """Feed this rank's watchdog, which from here keeps the deadline
        instead of the startup grace (a rank calls it when its loading
        and warm-up are done; every op beats as it ends)."""
        self._dog.beat()
        self._stacks_before(self.deadline_s)

    def _stacks_before(self, deadline_s: float) -> None:
        """Every thread's stack to stderr shortly before the watchdog
        would fire (re-armed at each beat): where a wedge stands."""
        faulthandler.dump_traceback_later(0.9 * deadline_s, exit=False)

    def call(self, name: str, args: tuple = ()) -> Any:
        """On the front: broadcast ``(name, args)`` and run the handler.
        The handler's own exception reaches the caller (every follower
        raised the same one from the same inputs); a broken channel
        ends the process."""
        if not self.front:
            raise RuntimeError("only the front issues lockstep ops")
        with self._lock:
            if self._stopped.is_set():
                raise RuntimeError("lockstep is shut down")
            self._send((name, args))
            try:
                return self.handlers[name](*args)
            finally:
                self.ops += 1
                self._last = time.monotonic()
                self.beat()

    def check(self) -> Dict[str, Any]:
        """Every rank's op count, token digest and kernel launches, and
        whether they agree (a ``check`` op)."""
        return self.call("check")

    def shutdown(self) -> None:
        """Tell the followers to exit; no op after this."""
        if not self.front:
            return
        with self._lock:
            if self._stopped.is_set():
                return
            self._send(("shutdown", ()))
            self._stopped.set()
        self._dog.stop()
        faulthandler.cancel_dump_traceback_later()
        if self._pinger is not None:
            self._pinger.join(timeout=5)

    def _send(self, op) -> None:
        try:
            dist.broadcast_object_list([op], src=0, group=self.group)
        except Exception as exc:  # noqa: BLE001 — a dead follower
            self._fatal(f"op channel failed sending {op[0]!r}: {exc}")

    def _ping_loop(self) -> None:
        every = self.deadline_s / 4
        while not self._stopped.wait(min(every / 4, 1.0)):
            if time.monotonic() - self._last < every:
                continue
            try:
                self.check()
            except Exception as exc:  # noqa: BLE001 — a follower is gone
                if self._stopped.is_set():
                    return
                self._fatal(f"check failed: {exc}")

    # -- a follower -----------------------------------------------------

    def follow(self) -> int:
        """Run the front's ops until ``shutdown``; returns 0."""
        while True:
            box = [None]
            try:
                dist.broadcast_object_list(box, src=0, group=self.group)
            except Exception as exc:  # noqa: BLE001 — the front is gone
                self._fatal(f"op channel failed: {exc}")
            name, args = box[0]
            if name == "shutdown":
                self._dog.stop()
                faulthandler.cancel_dump_traceback_later()
                return 0
            try:
                self.handlers[name](*args)
            except Exception:  # noqa: BLE001 — the front saw the same
                log.exception("rank %d: op %s raised", self.rank, name)
            self.ops += 1
            self.beat()

    # -- both -----------------------------------------------------------

    def record_tokens(self, values) -> None:
        """Fold an op's tokens (or scores) into this rank's digest."""
        arr = np.ascontiguousarray(np.asarray(values))
        self._digest.update(arr.tobytes())
        self.tokens += int(arr.size)

    def digest(self) -> str:
        """This rank's token digest so far (hex)."""
        return self._digest.hexdigest()

    def _check(self) -> Dict[str, Any]:
        from ..ops import flash, quant

        mine = {"rank": self.rank, "ops": self.ops, "tokens": self.tokens,
                "digest": self.digest(),
                "k1_launches": flash.LAUNCHES, "k2_launches": quant.LAUNCHES,
                **{name: fn() for name, fn in self.watched.items()}}
        ranks = [None] * self.size
        dist.all_gather_object(ranks, mine, group=self.group)
        keys = ("digest", "ops", *self.watched)
        agree = all(r[k] == ranks[0][k] for r in ranks for k in keys)
        out = {"ranks": ranks, "agree": agree}
        if self.front:
            if not agree:
                log.error("lockstep: the ranks disagree: %s", ranks)
            self.last_check = out
        return out

    def _fatal(self, why: str) -> None:
        log.error("lockstep rank %d: %s; exiting %d", self.rank, why,
                  EXIT_CODE)
        for stream in (sys.stderr, sys.stdout):
            try:
                stream.flush()
            except Exception:  # noqa: BLE001 — best-effort flush
                pass
        os._exit(EXIT_CODE)
