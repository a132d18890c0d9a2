"""loopcheck: the event-loop lag probe (the port's own copy of
``containerpilot_tpu/analysis/loopcheck.py``'s ``LoopLagProbe``).

The replica's event loop is cooperative, so ONE blocking call (a sync
sleep, a file read, a device sync on the wrong thread) stalls every
multiplexed stream and health check it serves at once. The probe is a
monotonic heartbeat scheduled with ``call_later`` that measures how late
the loop actually ran it versus when it asked to run (scheduling delay).
Samples land in a fixed-size ring; ``max_ms``/``p99_ms`` are exposed as
the ``cp_loop_lag_ms{stat}`` gauge on the replica's ``/metrics``.
Overhead: one timer callback per ``interval_s`` (default 50ms).
"""
from __future__ import annotations

import asyncio
import time
from collections import deque
from typing import Any, Deque, Dict, Optional

#: heartbeat cadence: 20/s is fine-grained enough to catch a 100ms
#: stall while costing one trivial callback per 50ms
DEFAULT_INTERVAL_S = 0.05
#: lag samples retained (~51s of history at the default cadence)
RING_SIZE = 1024


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
