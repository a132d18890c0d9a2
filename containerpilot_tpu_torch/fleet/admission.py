"""Gateway admission control: the fleet's defense against its own users
(the port's own copy of ``containerpilot_tpu/fleet/admission.py``).

The gateway routes well when demand fits capacity; this module decides
what happens when it doesn't. Following the ML-fleet-goodput framing
(PAPERS.md: requests meeting TTFT/TPOT SLOs per chip-second are the
only work that counts), overload is handled by shedding *early and
honestly* instead of queueing until a replica wedges and everything
times out:

- **Bounded dispatch + queue.** At most ``capacity`` requests are in
  flight to replicas (the gateway updates capacity as the healthy set
  changes: ``replicas * per_replica_inflight``); excess work waits in
  a bounded FIFO per priority class. A full queue fast-fails new
  arrivals — a 429 in a millisecond beats a 504 in thirty seconds.
- **Per-request deadlines.** A queued request that can no longer meet
  its TTFT budget is answered 504 the moment the budget expires,
  WITHOUT ever dispatching upstream: decode capacity is never spent
  on an answer the client has already written off.
- **Priority classes.** ``interactive`` (default) outranks ``batch``
  (header-selected): granted first when a slot frees, and batch is
  shed at the queue's high-water mark while interactive still queues
  — exactly the work to sacrifice first in a burst.
- **Per-session token buckets.** One chatty tenant session cannot
  monopolize the queue; over-rate sessions get 429 + the bucket's
  actual refill time.
- **Honest Retry-After.** Every shed carries a Retry-After derived
  from the *observed* queue drain rate (an EWMA-free completion-stamp
  window), so clients that honor it re-arrive roughly when capacity
  exists instead of in a synchronized storm one constant second later.

The controller is asyncio-single-threaded (no locks to publish under)
and holds no HTTP types: the gateway maps its exceptions onto
429/504 responses and mirrors its counters into prometheus.
"""
from __future__ import annotations

import asyncio
import math
import time
from collections import OrderedDict, deque
from typing import Deque, Dict, Optional, Tuple

PRIORITY_INTERACTIVE = 0
PRIORITY_BATCH = 1
PRIORITY_NAMES = {PRIORITY_INTERACTIVE: "interactive",
                  PRIORITY_BATCH: "batch"}

#: completion stamps kept for the drain-rate window
_RATE_WINDOW = 64
#: sessions tracked before the least-recently-seen bucket is evicted
_MAX_SESSIONS = 4096


def delta_seconds(seconds: float) -> int:
    """The ONE Retry-After shaping policy: ceil to integer HTTP
    delta-seconds, floored at 1 (a zero tells clients to hammer),
    capped at 60 (a stall never quotes an hour)."""
    return max(1, min(60, math.ceil(seconds)))


class AdmissionError(Exception):
    """Base: every admission rejection carries an honest retry hint
    and a stable machine label (``label``) — metric buckets must not
    depend on the human-facing reason wording."""

    def __init__(
        self, reason: str, retry_after_s: float, label: str
    ) -> None:
        super().__init__(reason)
        self.reason = reason
        self.retry_after_s = retry_after_s
        self.label = label


class ShedError(AdmissionError):
    """Load shed (HTTP 429): the queue is past its high-water mark
    (batch, label ``high_water``) or completely full (any priority,
    label ``queue_full``)."""


class SessionLimited(AdmissionError):
    """Per-session token bucket exhausted (HTTP 429, label
    ``session``)."""

    def __init__(self, reason: str, retry_after_s: float) -> None:
        super().__init__(reason, retry_after_s, "session")


class DeadlineExpired(Exception):
    """A queued request outlived its TTFT budget (HTTP 504); it was
    never dispatched upstream."""

    def __init__(self, waited_s: float) -> None:
        super().__init__(f"deadline expired after {waited_s:.3f}s queued")
        self.waited_s = waited_s


class Ticket:
    """One admitted request's claim on a dispatch slot. The holder
    must call ``AdmissionController.release(ticket)`` exactly once."""

    __slots__ = ("priority", "enqueued_at", "granted_at", "queued")

    def __init__(self, priority: int, enqueued_at: float) -> None:
        self.priority = priority
        self.enqueued_at = enqueued_at
        self.granted_at = enqueued_at
        self.queued = False


class _Waiter:
    __slots__ = ("ticket", "future", "handle")

    def __init__(
        self,
        ticket: Ticket,
        future: "asyncio.Future[None]",
        handle: Optional[asyncio.TimerHandle],
    ) -> None:
        self.ticket = ticket
        self.future = future
        self.handle = handle


class TokenBucket:
    """Classic token bucket; ``take()`` returns None on admit or the
    seconds until a token exists."""

    __slots__ = ("rate", "burst", "tokens", "stamp")

    def __init__(self, rate: float, burst: float, now: float) -> None:
        self.rate = rate
        self.burst = burst
        self.tokens = burst
        self.stamp = now

    def take(self, now: float) -> Optional[float]:
        self.tokens = min(
            self.burst, self.tokens + (now - self.stamp) * self.rate
        )
        self.stamp = now
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return None
        return (1.0 - self.tokens) / self.rate


class AdmissionController:
    def __init__(
        self,
        *,
        max_queue_depth: int = 256,
        high_water: Optional[int] = None,
        deadline_s: Optional[float] = None,
        per_replica_inflight: int = 64,
        session_rate: float = 0.0,
        session_burst: Optional[float] = None,
    ) -> None:
        if max_queue_depth < 1:
            raise ValueError("max_queue_depth must be >= 1")
        if per_replica_inflight < 1:
            raise ValueError("per_replica_inflight must be >= 1")
        self.max_queue_depth = max_queue_depth
        # default high-water: half the queue — batch sheds while the
        # interactive half of the buffer is still open (clamped so a
        # depth-1 queue still constructs)
        self.high_water = (
            high_water
            if high_water is not None
            else max(1, max_queue_depth // 2)
        )
        if not 0 < self.high_water <= max_queue_depth:
            raise ValueError("high_water must be in (0, max_queue_depth]")
        self.deadline_s = deadline_s
        self.per_replica_inflight = per_replica_inflight
        self.session_rate = session_rate
        self.session_burst = (
            session_burst
            if session_burst is not None
            else max(1.0, 2.0 * session_rate)
        )
        # capacity is pushed by the gateway as the healthy set moves;
        # start permissive so requests racing the first poll queue
        # instead of shedding
        self.capacity = per_replica_inflight
        self.inflight = 0
        self._queues: Tuple[Deque[_Waiter], Deque[_Waiter]] = (
            deque(), deque(),
        )
        self._buckets: "OrderedDict[str, TokenBucket]" = OrderedDict()
        self._completions: Deque[float] = deque(maxlen=_RATE_WINDOW)
        # plain counters, mirrored into prometheus by the gateway and
        # into /fleet verbatim
        self.admitted = 0
        self.queued_total = 0
        self.shed_overload = 0
        self.shed_session = 0
        self.expired = 0
        self.completed = 0

    # -- observability --------------------------------------------------

    @property
    def depth(self) -> int:
        return sum(len(q) for q in self._queues)

    def stats(self) -> Dict[str, object]:
        return {
            "capacity": self.capacity,
            "inflight": self.inflight,
            "depth": self.depth,
            "max_queue_depth": self.max_queue_depth,
            "high_water": self.high_water,
            "deadline_s": self.deadline_s,
            "admitted": self.admitted,
            "queued_total": self.queued_total,
            "shed_overload": self.shed_overload,
            "shed_session": self.shed_session,
            "deadline_expired": self.expired,
            "drain_rate_rps": round(self.drain_rate(), 3),
        }

    # -- drain rate + Retry-After ---------------------------------------

    def drain_rate(self) -> float:
        """Observed completions per second over the recent window. The
        optimistic prior (capacity per second) applies until real
        completions exist — an idle gateway must not tell its first
        shed victim to come back in a minute."""
        stamps = self._completions
        if len(stamps) >= 2:
            span = stamps[-1] - stamps[0]
            if span > 1e-6:
                observed = (len(stamps) - 1) / span
                idle = time.monotonic() - stamps[-1]
                if idle > 2.0 * max(1.0 / observed, 0.1):
                    if self.inflight > 0 or self.depth > 0:
                        # work is pending but completions STOPPED:
                        # the fleet is stalling — the estimate must
                        # decay DOWN, so a wedged fleet quotes long
                        # honest Retry-Afters, not capacity-optimism
                        observed = observed / (1.0 + idle)
                    else:
                        # quiet because there's no demand: the stale
                        # window is ancient history, quote the
                        # optimistic prior
                        observed = max(float(self.capacity), observed)
                return max(observed, 0.1)
        return max(float(self.capacity), 1.0)

    def retry_after_s(self) -> int:
        """Seconds until the CURRENT backlog (queue + in-flight, plus
        the caller's own request) should have drained, at the
        observed completion rate, shaped by ``delta_seconds``."""
        backlog = self.depth + self.inflight + 1
        return delta_seconds(backlog / self.drain_rate())

    # -- admission ------------------------------------------------------

    def set_capacity(self, replicas: int) -> None:
        """Called by the gateway after each catalog poll; growth
        grants queued waiters immediately."""
        self.capacity = max(1, replicas) * self.per_replica_inflight
        self._pump()

    def check_session(self, session: Optional[str]) -> None:
        """Per-session token bucket; raises SessionLimited over rate.
        Disabled when ``session_rate`` is 0."""
        if self.session_rate <= 0.0 or not session:
            return
        now = time.monotonic()
        bucket = self._buckets.get(session)
        if bucket is None:
            bucket = TokenBucket(self.session_rate, self.session_burst, now)
            self._buckets[session] = bucket
            while len(self._buckets) > _MAX_SESSIONS:
                self._buckets.popitem(last=False)
        else:
            self._buckets.move_to_end(session)
        wait = bucket.take(now)
        if wait is not None:
            self.shed_session += 1
            # same shaping as every other refusal: a tiny rate must
            # not quote an hour-scale Retry-After
            raise SessionLimited(
                f"session {session!r} over rate",
                float(delta_seconds(wait)),
            )

    async def admit(
        self,
        priority: int = PRIORITY_INTERACTIVE,
        session: Optional[str] = None,
        deadline_s: Optional[float] = None,
    ) -> Ticket:
        """Admit one request: grant a dispatch slot now, queue for one,
        or reject. Raises SessionLimited/ShedError (→ 429) and
        DeadlineExpired (→ 504, never dispatched)."""
        if priority not in PRIORITY_NAMES:
            raise ValueError(f"unknown priority {priority!r}")
        self.check_session(session)
        now = time.monotonic()
        ticket = Ticket(priority, now)
        # serve the queue before ourselves: a fast-path grant past
        # waiting requests would invert arrival order under churn
        self._pump()
        if self.inflight < self.capacity and self.depth == 0:
            self.inflight += 1
            self.admitted += 1
            ticket.granted_at = now
            return ticket
        depth = self.depth
        if depth >= self.max_queue_depth:
            self.shed_overload += 1
            raise ShedError(
                "queue full", self.retry_after_s(), "queue_full"
            )
        if depth >= self.high_water and priority >= PRIORITY_BATCH:
            self.shed_overload += 1
            raise ShedError(
                "queue past high-water; batch shed",
                self.retry_after_s(), "high_water",
            )
        loop = asyncio.get_event_loop()
        future: "asyncio.Future[None]" = loop.create_future()
        budget = deadline_s if deadline_s is not None else self.deadline_s
        waiter = _Waiter(ticket, future, None)
        if budget is not None:
            waiter.handle = loop.call_later(
                budget, self._expire, waiter
            )
        ticket.queued = True
        self.queued_total += 1
        self._queues[priority].append(waiter)
        try:
            await future
        except asyncio.CancelledError:
            if future.done() and not future.cancelled() and (
                future.exception() is None
            ):
                # granted in the same tick the awaiting task was
                # cancelled: the grant bumped inflight, and no one
                # will ever release this ticket — take the slot back
                self.inflight -= 1
                self._pump()
            else:
                # still queued: leave no ghost behind
                self._discard(waiter)
            raise
        ticket.granted_at = time.monotonic()
        return ticket

    def release(self, ticket: Ticket, completed: bool = True) -> None:
        """Return ``ticket``'s slot. ``completed`` feeds the drain-rate
        window (a request that failed upstream is not evidence the
        queue drains)."""
        self.inflight -= 1
        if completed:
            self.completed += 1
            self._completions.append(time.monotonic())
        self._pump()

    # -- internals ------------------------------------------------------

    def _expire(self, waiter: _Waiter) -> None:
        if waiter.future.done():
            return
        self._discard(waiter)
        self.expired += 1
        waiter.future.set_exception(
            DeadlineExpired(time.monotonic() - waiter.ticket.enqueued_at)
        )

    def _discard(self, waiter: _Waiter) -> None:
        if waiter.handle is not None:
            waiter.handle.cancel()
            waiter.handle = None
        for q in self._queues:
            try:
                q.remove(waiter)
                return
            except ValueError:
                continue

    def _pump(self) -> None:
        """Grant queued waiters while capacity exists, interactive
        first; FIFO within a class."""
        while self.inflight < self.capacity:
            waiter = None
            for q in self._queues:
                while q:
                    candidate = q.popleft()
                    if not candidate.future.done():
                        waiter = candidate
                        break
                if waiter is not None:
                    break
            if waiter is None:
                return
            if waiter.handle is not None:
                waiter.handle.cancel()
                waiter.handle = None
            self.inflight += 1
            self.admitted += 1
            waiter.future.set_result(None)


def parse_priority(raw: str) -> int:
    """Map the ``X-Priority`` header onto a class; anything not
    explicitly ``batch`` is interactive (fail-open for end users)."""
    return (
        PRIORITY_BATCH
        if raw.strip().lower() == "batch"
        else PRIORITY_INTERACTIVE
    )
