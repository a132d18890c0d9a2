"""The in-process event bus: synchronous fan-out pub/sub (the port's own
copy of ``containerpilot_tpu/events/bus.py``, without its optional
Prometheus event counter: the port writes its own exposition and a
replica's bus publishes a handful of maintenance events).

Capability parity with the reference supervisor's bus
(reference: events/bus.go). Semantics preserved:

- ``publish`` fans an event out to every subscriber synchronously,
  under a lock, in subscription order (reference: events/bus.go:125-140).
- Actors ``register`` before starting their loop and ``unregister`` when
  done; the app's lifetime is ``await bus.wait()``, which completes when
  the registered-actor count drops to zero and returns the reload flag
  (reference: events/bus.go:97-122,150-170).
- A small ring buffer of recent events supports event-sequence
  assertions in tests (reference: events/bus.go:34-54,75).
- ``shutdown`` publishes GLOBAL_SHUTDOWN; ``set_reload_flag`` marks the
  next ``wait`` return as a reload rather than a stop.

Design note (TPU-host idiom): the supervisor runs a single asyncio event
loop — the analogue of the reference pinning itself to one OS thread so
it never contends with the supervised JAX workload for host cores.
Fan-out delivers into per-actor ``asyncio.Queue`` mailboxes, which are
NOT thread-safe off the loop, so ``publish`` from a foreign thread is
routed onto the bus's home loop via ``call_soon_threadsafe`` (the home
loop is remembered the first time subscribe/register/publish runs on a
loop thread). In-tree publishers are all loop-resident; the routing
exists for embedding scenarios.
"""
from __future__ import annotations

import asyncio
import logging
import threading
from collections import deque
from typing import TYPE_CHECKING, Deque, List, Optional

from .events import GLOBAL_SHUTDOWN, Event

if TYPE_CHECKING:  # pragma: no cover
    from .subscriber import Subscriber

log = logging.getLogger("containerpilot.events")

# Ring-buffer size for DebugEvents-style assertions
# (reference: events/bus.go:75).
DEBUG_RING_SIZE = 10

class EventBus:
    """Synchronous fan-out pub/sub with actor-lifetime tracking."""

    def __init__(self, ring_size: int = DEBUG_RING_SIZE) -> None:
        self._lock = threading.RLock()
        # Serializes fan-out WITHOUT coupling it to the state lock:
        # delivery-only, reentrant (a subscriber may publish from its
        # receive callback on the same thread), taken by no other code
        # path — so it cannot participate in a lock-order cycle with
        # application locks. It matters only on the direct off-loop
        # publish path (no home loop yet, or the loop already closed):
        # two foreign threads publishing concurrently must not
        # interleave unsynchronized mailbox puts.
        self._fanout_lock = threading.RLock()
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._subscribers: List["Subscriber"] = []
        self._registered: int = 0
        self._done = asyncio.Event()
        self._done.set()  # nothing registered yet
        self._reload_flag = False
        self._shutdown = False
        self._ring: Deque[Event] = deque(maxlen=ring_size)

    # -- subscription ---------------------------------------------------

    def _remember_home_loop(self) -> None:
        """Record the loop whose thread this call runs on, if any."""
        if self._loop is None:
            try:
                self._loop = asyncio.get_running_loop()
            except RuntimeError:
                pass

    def subscribe(self, subscriber: "Subscriber") -> None:
        with self._lock:
            self._remember_home_loop()
            self._subscribers.append(subscriber)

    def unsubscribe(self, subscriber: "Subscriber") -> None:
        with self._lock:
            try:
                self._subscribers.remove(subscriber)
            except ValueError:
                pass

    # -- actor lifetime (the WaitGroup analogue) ------------------------

    def register(self, _actor: object = None) -> None:
        """Count an actor into this bus generation's lifetime."""
        with self._lock:
            self._remember_home_loop()
            self._registered += 1
            self._done.clear()

    def unregister(self, _actor: object = None) -> None:
        with self._lock:
            self._registered -= 1
            if self._registered <= 0:
                self._registered = 0
                self._done.set()

    async def wait(self) -> bool:
        """Block until every registered actor has unregistered.

        Returns True when the generation ended because of a reload
        request, False for a plain shutdown
        (reference: events/bus.go:164-170 + core/app.go:146).
        """
        await self._done.wait()
        with self._lock:
            return self._reload_flag

    # -- publishing -----------------------------------------------------

    def publish(self, event: Event) -> None:
        """Fan the event out to all subscribers, synchronously, in order.

        A subscriber with a full mailbox gets the event dropped with an
        error log and a bump of the subscriber's ``dropped`` count
        rather than wedging the entire bus (the reference blocks in that
        case, which is a documented deadlock hazard —
        reference: events/bus.go:125-140, jobs/jobs.go:23).

        Calls from a thread other than the bus's home loop thread are
        re-routed onto the home loop: mailbox delivery touches
        ``asyncio.Queue`` internals that are not thread-safe off-loop.
        """
        home = self._loop
        if home is not None and not home.is_closed():
            try:
                running = asyncio.get_running_loop()
            except RuntimeError:
                running = None
            if running is not home:
                home.call_soon_threadsafe(self._publish_on_loop, event)
                return
        self._publish_on_loop(event)

    def _publish_on_loop(self, event: Event) -> None:
        # Bookkeeping under the STATE lock, fan-out outside it:
        # delivering into subscriber mailboxes while holding the lock
        # that register/unregister/wait also take is the reference's
        # classic deadlock shape (a subscriber callback that touches
        # the bus re-enters it) — cpcheck's CP-LOCKPUB exists to keep
        # it out of this codebase, starting here. The snapshot keeps
        # subscription order; the delivery-only _fanout_lock keeps
        # concurrent direct publishes (off-loop fallback path) from
        # interleaving mailbox puts, as the old state lock did.
        with self._fanout_lock:
            with self._lock:
                self._remember_home_loop()
                log.debug("event: %s", event)
                self._ring.append(event)
                subscribers = list(self._subscribers)
            for sub in subscribers:
                sub.receive(event)  # cpcheck: disable=CP-LOCKPUB delivery-only reentrant lock, taken by no other code path

    def shutdown(self) -> None:
        """Broadcast GLOBAL_SHUTDOWN (reference: events/bus.go:156-160)."""
        with self._lock:
            self._shutdown = True
        self.publish(GLOBAL_SHUTDOWN)

    # -- reload flag ----------------------------------------------------

    def set_reload_flag(self) -> None:
        with self._lock:
            self._reload_flag = True

    def get_reload_flag(self) -> bool:
        with self._lock:
            return self._reload_flag

    # -- test/debug support ---------------------------------------------

    def debug_events(self) -> List[Event]:
        """Most-recent events, oldest first (reference: events/bus.go:34-54)."""
        with self._lock:
            return list(self._ring)
