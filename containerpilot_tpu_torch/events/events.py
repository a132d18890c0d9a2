"""Event codes and the Event value type (the port's own copy of
``containerpilot_tpu/events/events.py``).

Capability parity with the reference supervisor's event enum
(reference: events/events.go:10-54): sixteen event codes plus the
sentinel, value-semantics Event{code, source} pairs, and the well-known
global events used to kick off and tear down an actor generation.

Events are immutable value objects: two events with the same code and
source compare equal, which is what the job state machine's dispatch
switch relies on.
"""
from __future__ import annotations

import enum
from typing import NamedTuple


class EventCode(enum.Enum):
    """All event codes a supervisor actor can publish or receive."""

    NONE = "none"
    EXIT_SUCCESS = "exitSuccess"
    EXIT_FAILED = "exitFailed"
    STOPPING = "stopping"
    STOPPED = "stopped"
    STATUS_HEALTHY = "statusHealthy"
    STATUS_UNHEALTHY = "statusUnhealthy"
    STATUS_CHANGED = "statusChanged"
    TIMER_EXPIRED = "timerExpired"
    ENTER_MAINTENANCE = "enterMaintenance"
    EXIT_MAINTENANCE = "exitMaintenance"
    ERROR = "error"
    QUIT = "quit"
    METRIC = "metric"
    STARTUP = "startup"
    SHUTDOWN = "shutdown"
    SIGNAL = "signal"

    def __str__(self) -> str:  # pragma: no cover - trivial
        return self.value


_CODE_BY_NAME = {c.value: c for c in EventCode}
# Accept the enum's symbolic names too (e.g. "EXIT_SUCCESS").
_CODE_BY_NAME.update({c.name: c for c in EventCode})
# Config-facing aliases (reference: events/events.go:52-84 — FromString
# maps "healthy"/"unhealthy"/"changed" onto the status codes).
_CODE_BY_NAME.update(
    {
        "healthy": EventCode.STATUS_HEALTHY,
        "unhealthy": EventCode.STATUS_UNHEALTHY,
        "changed": EventCode.STATUS_CHANGED,
    }
)


def code_from_string(name: str) -> EventCode:
    """Parse an event-code string (config files use the camelCase form).

    Reference behavior: unknown names are an error
    (reference: events/events.go:52-58).
    """
    try:
        return _CODE_BY_NAME[name]
    except KeyError:
        raise ValueError(f"invalid event code: {name!r}") from None


class Event(NamedTuple):
    """An immutable (code, source) pair flowing through the bus."""

    code: EventCode
    source: str

    def __str__(self) -> str:  # pragma: no cover - trivial
        return f"{self.code.value}:{self.source}"


# Well-known events (reference: events/events.go:41-50).
GLOBAL_STARTUP = Event(EventCode.STARTUP, "global")
GLOBAL_SHUTDOWN = Event(EventCode.SHUTDOWN, "global")
NON_EVENT = Event(EventCode.NONE, "")
QUIT_BY_CLOSE = Event(EventCode.QUIT, "closed")
# Test hook: lets unit tests stop actor loops without a global shutdown
# (reference: events/events.go:48).
QUIT_BY_TEST = Event(EventCode.QUIT, "test")
GLOBAL_ENTER_MAINTENANCE = Event(EventCode.ENTER_MAINTENANCE, "global")
GLOBAL_EXIT_MAINTENANCE = Event(EventCode.EXIT_MAINTENANCE, "global")
