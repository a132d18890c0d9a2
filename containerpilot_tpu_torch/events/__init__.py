"""Event system: codes, bus, mailboxes, timers (the port's own copy of
``containerpilot_tpu/events/``). A fleet member subscribes to the bus so
the control plane's maintenance verbs drain and resume its replica."""
from .events import (
    Event,
    EventCode,
    GLOBAL_ENTER_MAINTENANCE,
    GLOBAL_EXIT_MAINTENANCE,
    GLOBAL_SHUTDOWN,
    GLOBAL_STARTUP,
    NON_EVENT,
    QUIT_BY_CLOSE,
    QUIT_BY_TEST,
    code_from_string,
)
from .bus import DEBUG_RING_SIZE, EventBus
from .subscriber import MAILBOX_CAPACITY, EventHandler, Publisher, Subscriber
from .timer import cancel_timer, event_timeout, event_timer

__all__ = [
    "Event",
    "EventCode",
    "EventBus",
    "EventHandler",
    "Publisher",
    "Subscriber",
    "GLOBAL_STARTUP",
    "GLOBAL_SHUTDOWN",
    "GLOBAL_ENTER_MAINTENANCE",
    "GLOBAL_EXIT_MAINTENANCE",
    "NON_EVENT",
    "QUIT_BY_CLOSE",
    "QUIT_BY_TEST",
    "code_from_string",
    "event_timeout",
    "event_timer",
    "cancel_timer",
    "DEBUG_RING_SIZE",
    "MAILBOX_CAPACITY",
]
