"""loopcheck: event-loop health sentinels (the port's own copy of
``containerpilot_tpu/analysis/loopcheck.py``): ``LoopLagProbe`` and
``TaskWatchdog``.

The replica's event loop is cooperative, so ONE blocking call (a sync
sleep, a file read, a device sync on the wrong thread) stalls every
multiplexed stream and health check it serves at once. The probe is a
monotonic heartbeat scheduled with ``call_later`` that measures how late
the loop actually ran it versus when it asked to run (scheduling delay).
Samples land in a fixed-size ring; ``max_ms``/``p99_ms`` are exposed as
the ``cp_loop_lag_ms{stat}`` gauge on the replica's ``/metrics``.
Overhead: one timer callback per ``interval_s`` (default 50ms).

``TaskWatchdog`` wraps a loop's task factory: every task created on the
instrumented loop gets a done-callback, and a task that finished with an
exception nobody retrieved within ``grace_s`` is recorded (ring) and
logged with its name. ``CancelledError`` is never a leak. The grace
window exists because a handled failure is retrieved by its awaiter on
the very next wakeup; only orphans are still unretrieved after it. The
chaos harness runs both for every scenario and gates on them.
"""
from __future__ import annotations

import asyncio
import logging
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Tuple

log = logging.getLogger("containerpilot.loopcheck")

#: heartbeat cadence: 20/s is fine-grained enough to catch a 100ms
#: stall while costing one trivial callback per 50ms
DEFAULT_INTERVAL_S = 0.05
#: lag samples retained (~51s of history at the default cadence)
RING_SIZE = 1024
#: how long an unretrieved task exception may wait for its awaiter
#: before the watchdog calls it leaked
DEFAULT_GRACE_S = 0.05


class LoopLagProbe:
    """Event-loop scheduling-delay probe: a self-rescheduling
    ``call_later`` heartbeat that records, per beat, how late the
    loop ran it (ms) into a fixed-size ring.

    The measured quantity is exactly what a request experiences: a
    callback due at T that runs at T+lag means every I/O wakeup,
    timer, and stream write due in that window also waited ``lag``.
    A clean loop reports ~0; a blocking call on the loop reports its
    own duration.
    """

    def __init__(
        self,
        interval_s: float = DEFAULT_INTERVAL_S,
        ring: int = RING_SIZE,
    ) -> None:
        if interval_s <= 0:
            raise ValueError("interval_s must be > 0")
        self.interval_s = interval_s
        self._ring: Deque[float] = deque(maxlen=ring)
        self._handle: Optional[asyncio.TimerHandle] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._due = 0.0
        self.beats = 0
        self.running = False

    # -- lifecycle ------------------------------------------------------

    def start(
        self, loop: Optional[asyncio.AbstractEventLoop] = None
    ) -> "LoopLagProbe":
        """Begin heartbeating on ``loop`` (default: the current
        loop). Idempotent while running."""
        if self.running:
            return self
        self._loop = loop or asyncio.get_event_loop()
        self.running = True
        self._due = time.monotonic() + self.interval_s
        self._handle = self._loop.call_later(self.interval_s, self._beat)
        return self

    def stop(self) -> None:
        """Stop heartbeating; the ring keeps its samples."""
        self.running = False
        if self._handle is not None:
            self._handle.cancel()
            self._handle = None

    def _beat(self) -> None:
        now = time.monotonic()
        # the loop ran this callback (now - due) late; clamp the
        # sub-ms early-fire jitter some platforms exhibit to zero
        self._ring.append(max(0.0, (now - self._due) * 1e3))
        self.beats += 1
        if self.running and self._loop is not None:
            self._due = now + self.interval_s
            self._handle = self._loop.call_later(
                self.interval_s, self._beat
            )

    # -- readings -------------------------------------------------------

    def max_ms(self) -> float:
        return max(self._ring) if self._ring else 0.0

    def p99_ms(self) -> float:
        if not self._ring:
            return 0.0
        ordered = sorted(self._ring)
        return ordered[min(len(ordered) - 1, int(0.99 * len(ordered)))]

    def snapshot(self) -> Dict[str, Any]:
        """JSON-able summary (the chaos report's ``loop`` blob)."""
        return {
            "lag_max_ms": round(self.max_ms(), 2),
            "lag_p99_ms": round(self.p99_ms(), 2),
            "heartbeats": self.beats,
            "interval_ms": self.interval_s * 1e3,
        }


class TaskWatchdog:
    """Task-factory wrapper recording leaked-task exceptions.

    Installed on a loop, every task it creates gets a done-callback.
    A task that finishes with an exception is re-checked one grace
    window later: if no awaiter retrieved the exception by then (the
    fire-and-forget case — an awaited task's exception is retrieved
    on the awaiter's next wakeup, well inside the window), the
    exception is recorded in a fixed-size ring and logged with the
    task's name. Retrieving it here also takes ownership, so the
    interpreter's own destructor-time "exception was never retrieved"
    complaint (which fires at GC, far from the scene) is replaced by
    an immediate, attributed record.
    """

    def __init__(
        self, ring: int = 64, grace_s: float = DEFAULT_GRACE_S
    ) -> None:
        #: (task name, exception repr) per leaked exception
        self.exceptions: Deque[Tuple[str, str]] = deque(maxlen=ring)
        self.tasks_created = 0
        self.grace_s = grace_s
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._prev_factory: Any = None
        self.installed = False

    def install(
        self, loop: Optional[asyncio.AbstractEventLoop] = None
    ) -> "TaskWatchdog":
        if self.installed:
            return self
        self._loop = loop or asyncio.get_event_loop()
        self._prev_factory = self._loop.get_task_factory()
        self._loop.set_task_factory(self._factory)
        self.installed = True
        return self

    def uninstall(self) -> None:
        if not self.installed or self._loop is None:
            return
        self._loop.set_task_factory(self._prev_factory)
        self._prev_factory = None
        self.installed = False

    def _factory(self, loop, coro, **kwargs):
        if self._prev_factory is not None:
            task = self._prev_factory(loop, coro, **kwargs)
        else:
            task = asyncio.Task(coro, loop=loop, **kwargs)
        self.tasks_created += 1
        task.add_done_callback(self._on_done)
        return task

    def _on_done(self, task: "asyncio.Task") -> None:
        if task.cancelled():
            return
        # cheap pre-filter without retrieving: Future.exception()
        # would mark the exception retrieved and hide a real leak
        if getattr(task, "_exception", True) is None:  # noqa: SLF001
            return
        # defer the verdict one grace window: a legitimate awaiter
        # (await / gather / wait+result()) retrieves on its next
        # wakeup, which the loop schedules before this timer fires
        if self._loop is not None:
            self._loop.call_later(self.grace_s, self._check, task)

    def _check(self, task: "asyncio.Task") -> None:
        # _log_traceback flips False the moment anyone retrieves the
        # exception; still True after the grace window == leaked.
        # (CPython implementation detail; on others the getattr
        # default records every task exception, which errs loud.)
        if not getattr(task, "_log_traceback", True):
            return
        exc = task.exception()  # retrieve: we own it now
        if exc is None or isinstance(exc, asyncio.CancelledError):
            return
        self.exceptions.append((task.get_name(), repr(exc)))
        log.error(
            "leaked task %r died unobserved: %r", task.get_name(), exc,
            exc_info=exc,
        )

    def snapshot(self) -> List[Dict[str, str]]:
        """JSON-able list of recorded leaks."""
        return [
            {"task": name, "exception": exc}
            for name, exc in self.exceptions
        ]
