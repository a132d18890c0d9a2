"""Timers that inject TIMER_EXPIRED events (the port's own copy of
``containerpilot_tpu/events/timer.py``).

Capability parity with the reference's timer helpers
(reference: events/timer.go):

- ``event_timeout``: one-shot — after ``delay`` seconds emit
  ``{TIMER_EXPIRED, name}`` once (reference: events/timer.go:12-34).
- ``event_timer``: ticker — emit ``{TIMER_EXPIRED, name}`` every
  ``interval`` seconds until cancelled (reference: events/timer.go:40-68).

Timers emit either onto the global bus or directly into one actor's
private mailbox — the reference's job-private timers write to the job's
own channel (reference: jobs/jobs.go:147-158), so the sink here is any
object with ``publish`` (EventBus) or ``receive`` (Subscriber mailbox),
or a bare callable.

Both are asyncio tasks; cancelling the returned task stops them.
Emitting after the generation tears down is harmless — the reference
handles the analogous send-on-closed-channel race with a recover()
(events/timer.go:26-30,49-54); here a cancelled task simply stops.
"""
from __future__ import annotations

import asyncio
from typing import Any, Callable, Optional

from ..utils.tasks import spawn
from .events import Event, EventCode

EmitFn = Callable[[Event], None]


def _as_emit(sink: Any) -> EmitFn:
    # publish/receive take priority over bare callability so that
    # bus-like objects which also happen to be callable route through
    # their documented interface
    if hasattr(sink, "publish"):
        return sink.publish
    if hasattr(sink, "receive"):
        return sink.receive
    if callable(sink):
        return sink
    raise TypeError(f"not a timer sink: {sink!r}")


def _emit_safe(emit: EmitFn, event: Event, name: str) -> None:
    # one bad emit must not kill the cadence — the reference guards the
    # analogous send-on-closed-channel with recover()
    # (reference: events/timer.go:26-30,49-54)
    try:
        emit(event)
    except Exception:  # noqa: BLE001
        import logging

        logging.getLogger("containerpilot.events").exception(
            "timer %s: emit failed", name
        )


def event_timeout(sink: Any, delay: float, name: str) -> "asyncio.Task[None]":
    """One-shot timer: emit {TIMER_EXPIRED, name} after delay seconds."""
    emit = _as_emit(sink)

    async def _fire() -> None:
        try:
            await asyncio.sleep(delay)
            _emit_safe(emit, Event(EventCode.TIMER_EXPIRED, name), name)
        except asyncio.CancelledError:
            pass

    return spawn(_fire(), name=f"timeout:{name}")


def event_timer(
    sink: Any, interval: float, name: str, *, immediate: bool = False
) -> "asyncio.Task[None]":
    """Ticker: emit {TIMER_EXPIRED, name} every interval seconds.

    ``immediate=True`` fires once right away before settling into the
    interval cadence (used by watches so the first poll isn't delayed).
    """
    emit = _as_emit(sink)

    async def _tick() -> None:
        try:
            if immediate:
                _emit_safe(emit, Event(EventCode.TIMER_EXPIRED, name), name)
            while True:
                await asyncio.sleep(interval)
                _emit_safe(emit, Event(EventCode.TIMER_EXPIRED, name), name)
        except asyncio.CancelledError:
            pass

    return spawn(_tick(), name=f"timer:{name}")


def cancel_timer(task: Optional["asyncio.Task[None]"]) -> None:
    if task is not None and not task.done():
        task.cancel()
