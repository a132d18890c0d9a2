"""ServiceDefinition: how one job talks to the discovery catalog (the
port's own copy of ``containerpilot_tpu/discovery/service.py``).

Capability parity with the reference (reference: discovery/service.go):
lazy registration on first heartbeat, TTL refresh writes, initial-status
registration, deregistration on stop, and maintenance = deregister.

Catalog I/O runs on a small shared thread pool, never on the
supervisor's event loop: the reference runs each actor in its own
goroutine so a slow Consul call only stalls that actor — here a
blocking HTTP call on the single asyncio loop would stall *every*
actor's timers and the control socket. Per-service operations execute
in strict submission (FIFO) order through a private drain queue, so a
heartbeat submitted before a deregister can never re-register the
service afterwards, regardless of pool scheduling. Heartbeats dedup
against a non-empty queue (a hung catalog can't build a backlog);
``deregister`` always enqueues and returns a future that async callers
(job cleanup) await so the stopped event still orders after
deregistration.
"""
from __future__ import annotations

import logging
import threading
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, Deque, Optional, Tuple

from .backend import Backend, DiscoveryError, ServiceRegistration

log = logging.getLogger("containerpilot.discovery")

HEALTH_PASSING = "passing"
HEALTH_WARNING = "warning"
HEALTH_CRITICAL = "critical"

# shared across all services; catalog calls are tiny and infrequent
_EXECUTOR = ThreadPoolExecutor(max_workers=2, thread_name_prefix="discovery")


class ServiceDefinition:
    """A job's live registration state against a Backend."""

    def __init__(self, registration: ServiceRegistration, backend: Backend) -> None:
        self.registration = registration
        self.backend = backend
        self.was_registered = False
        self._lock = threading.Lock()
        self._pending: Deque[Tuple[Callable[[], None], Future]] = deque()
        self._draining = False

    @property
    def id(self) -> str:
        return self.registration.id

    @property
    def name(self) -> str:
        return self.registration.name

    @property
    def initial_status(self) -> str:
        return self.registration.initial_status

    # -- FIFO off-loop execution ------------------------------------------

    def _enqueue(
        self, fn: Callable[[], None], *, dedup: bool
    ) -> Optional[Future]:
        """Queue a catalog op; per-service ops run in submission order.

        ``dedup=True`` skips the submit when ops are already queued or
        running (heartbeats must not pile up behind a hung catalog).
        """
        with self._lock:
            if dedup and (self._pending or self._draining):
                log.debug("%s: catalog op in flight, skipping", self.id)
                return None
            future: Future = Future()
            self._pending.append((fn, future))
            if not self._draining:
                self._draining = True
                _EXECUTOR.submit(self._drain)
        return future

    def _drain(self) -> None:
        while True:
            with self._lock:
                if not self._pending:
                    self._draining = False
                    return
                fn, future = self._pending.popleft()
            try:
                fn()
                future.set_result(None)
            except Exception as exc:  # noqa: BLE001 - surfaced via future
                log.warning("%s: catalog op failed: %s", self.id, exc)
                future.set_exception(exc)

    # -- operations --------------------------------------------------------

    def send_heartbeat(self, output: str = "ok") -> Optional[Future]:
        """Lazy-register then refresh the TTL check
        (reference: discovery/service.go:41-51). ``output`` rides the
        check record (consul's check Output field; the file catalog's
        ``notes``) — fleet members put slot occupancy there."""

        def work() -> None:
            self._register_sync(HEALTH_PASSING)
            try:
                self.backend.update_ttl(
                    f"service:{self.id}", output, "pass"
                )
            except DiscoveryError as exc:
                log.warning("service update TTL failed: %s", exc)
                # self-heal from catalog state loss (restarted agent,
                # wiped store): assume our registration is gone and
                # lazily re-register on the next heartbeat. The
                # reference warns forever and never recovers.
                self.was_registered = False

        return self._enqueue(work, dedup=True)

    def register_with_initial_status(self) -> Optional[Future]:
        """Register once with the configured initial status
        (reference: discovery/service.go:54-76)."""
        if self.was_registered:
            return None
        status = {
            "passing": HEALTH_PASSING,
            "warning": HEALTH_WARNING,
            "critical": HEALTH_CRITICAL,
        }.get(self.initial_status, "")

        def work() -> None:
            log.info(
                "registering service %s with initial status %r",
                self.name,
                status,
            )
            self._register_sync(status)

        return self._enqueue(work, dedup=True)

    def _register_sync(self, status: str) -> None:
        if self.was_registered:
            return
        try:
            self.backend.service_register(self.registration, status)
        except DiscoveryError as exc:
            log.warning("service registration failed: %s", exc)
            return
        log.info("service registered: %s", self.name)
        self.was_registered = True

    def deregister(self) -> Optional[Future]:
        """Remove from the catalog (reference: discovery/service.go:28-33).

        Deviation from the reference: ``was_registered`` resets so the
        next heartbeat lazily re-registers — the reference leaves the
        flag set, so a service exiting maintenance mode keeps writing
        TTL updates against a check it deleted and never reappears in
        the catalog until a config reload.
        """

        def work() -> None:
            self.was_registered = False
            log.debug("deregistering: %s", self.id)
            try:
                self.backend.service_deregister(self.id)
            except DiscoveryError as exc:
                log.info("deregistering failed: %s", exc)

        # never dedup-skipped: cleanup must always deregister
        return self._enqueue(work, dedup=False)

    def mark_for_maintenance(self) -> None:
        """Maintenance mode = drop out of the catalog
        (reference: discovery/service.go:36-38)."""
        self.deregister()
