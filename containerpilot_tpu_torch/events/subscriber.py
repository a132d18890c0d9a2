"""Actor mailbox plumbing: Subscriber and Publisher mixins (the port's
own copy of ``containerpilot_tpu/events/subscriber.py``; a dropped event
is counted on the subscriber instead of in Prometheus).

Capability parity with the reference's subscriber/publisher structs
(reference: events/subscriber.go, events/publisher.go). Every supervisor
actor (job, watch, metric collector, control server) embeds these:

- ``Subscriber``: a bounded mailbox (``rx``) the bus fans events into,
  plus subscribe/unsubscribe bookkeeping.
- ``Publisher``: register/unregister against the bus's actor-lifetime
  count plus a publish passthrough.

The mailbox is bounded at 1000 events, matching the reference's
per-actor channel capacity (reference: jobs/jobs.go:23).
"""
from __future__ import annotations

import asyncio
import logging
from typing import Optional

from .bus import EventBus
from .events import Event

log = logging.getLogger("containerpilot.events")

MAILBOX_CAPACITY = 1000

class Publisher:
    """Gives an actor a handle to publish onto the bus and be counted
    in the bus generation's lifetime."""

    def __init__(self) -> None:
        self.bus: Optional[EventBus] = None

    def register(self, bus: EventBus) -> None:
        self.bus = bus
        bus.register(self)

    def unregister(self) -> None:
        if self.bus is not None:
            self.bus.unregister(self)

    def publish(self, event: Event) -> None:
        if self.bus is not None:
            self.bus.publish(event)


class Subscriber(Publisher):
    """An actor with a bounded mailbox the bus delivers into."""

    def __init__(self) -> None:
        super().__init__()
        self.rx: asyncio.Queue[Event] = asyncio.Queue(maxsize=MAILBOX_CAPACITY)
        self._subscribed = False
        #: events dropped on a full mailbox (the reference counts them
        #: in Prometheus; the port keeps the count here)
        self.dropped = 0

    def subscribe(self, bus: EventBus) -> None:
        self.bus = bus
        bus.subscribe(self)
        self._subscribed = True

    def unsubscribe(self) -> None:
        if self.bus is not None and self._subscribed:
            self.bus.unsubscribe(self)
            self._subscribed = False

    def receive(self, event: Event) -> None:
        """Called by the bus, synchronously, during publish fan-out."""
        try:
            self.rx.put_nowait(event)
        except asyncio.QueueFull:
            # The reference would block the whole bus here; dropping with
            # a loud error + a counter is the safer failure mode for a
            # supervisor (``self.dropped``).
            log.error(
                "mailbox full (%d): dropping %s for %r",
                MAILBOX_CAPACITY,
                event,
                self,
            )
            self.dropped += 1

    async def next_event(self) -> Event:
        return await self.rx.get()


class EventHandler(Subscriber):
    """Convenience base for actors that both subscribe and publish
    (every domain actor in practice)."""
