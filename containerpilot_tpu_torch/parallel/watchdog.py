"""Step-deadline watchdog: in-process failure detection for
distributed training (counterpart of
``containerpilot_tpu/parallel/watchdog.py``, pure Python, the same exit
code and deadline arithmetic).

When a peer host dies mid-step, the survivors block inside a
collective — no exception, no exit, nothing for the supervisor to
restart. A multi-host trainer therefore self-monitors: beat() every
completed step; if no beat lands within the deadline the watchdog
hard-exits the process (``os._exit`` — a wedged collective cannot be
unwound by Python exception handling, and atexit/finally handlers may
themselves block). The supervisor then sees a dead child, applies the
restart budget, and the reincarnated pod re-rendezvouses through the
catalog and resumes from the latest checkpoint — turning a silent hang
into the crash/restart/resume path the rest of the stack already
handles (SURVEY.md §5 failure detection; the reference's analog is
health-check TTL expiry driving catalog criticality).
"""
from __future__ import annotations

import logging
import os
import sys
import threading
import time

log = logging.getLogger("containerpilot.watchdog")

EXIT_CODE = 86  # distinguishable from a crash (1) or a signal (>128)


class StepWatchdog:
    """Exit the process if ``beat()`` stops arriving.

    >>> dog = StepWatchdog(timeout_s=60).start()
    >>> for batch in data:
    ...     state = train_step(state, batch)
    ...     dog.beat()
    >>> dog.stop()

    The deadline should comfortably exceed the slowest legitimate step
    (including any compile the step might trigger): a false positive
    costs a restart-budget slot.

    ``start(grace_s=...)`` widens the deadline for the FIRST beat only:
    arm the watchdog before rendezvous/restore/first-compile and the
    whole startup window is covered (a peer that died between catalog
    rendezvous and its first collective wedges the survivor's restore
    barrier or first all-reduce just as silently as a mid-run death),
    while steady-state steps still get the tight deadline.
    """

    def __init__(self, timeout_s: float, exit_code: int = EXIT_CODE) -> None:
        if timeout_s <= 0:
            raise ValueError("timeout_s must be > 0")
        self.timeout_s = timeout_s
        self.exit_code = exit_code
        self._deadline_s = timeout_s
        self._last = time.monotonic()
        self._stopped = threading.Event()
        self._thread: threading.Thread = None

    def beat(self) -> None:
        self._last = time.monotonic()
        self._deadline_s = self.timeout_s

    def start(self, grace_s: float = None) -> "StepWatchdog":
        self._last = time.monotonic()  # the clock starts now
        if grace_s is not None:
            if grace_s < self.timeout_s:
                raise ValueError("grace_s must be >= timeout_s")
            self._deadline_s = grace_s
        self._thread = threading.Thread(
            target=self._watch, name="step-watchdog", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stopped.set()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def _watch(self) -> None:
        # poll at a fraction of the deadline: detection latency is at
        # most timeout + poll, and a sleeping thread costs nothing
        poll = min(self.timeout_s / 4, 1.0)
        while not self._stopped.wait(poll):
            overdue = time.monotonic() - self._last
            if overdue > self._deadline_s:
                log.error(
                    "watchdog: no step in %.1fs (deadline %.1fs); "
                    "exiting %d for the supervisor to restart",
                    overdue, self._deadline_s, self.exit_code,
                )
                # best effort: get the log line out before dying
                for stream in (sys.stderr, sys.stdout):
                    try:
                        stream.flush()
                    except Exception:  # noqa: BLE001 — best-effort flush on the road to os._exit
                        pass
                os._exit(self.exit_code)
