"""FleetMember: one serving replica's registration + drain lifecycle
(the port's own copy of ``containerpilot_tpu/fleet/member.py``, over the
port's ``discovery`` backends and ``events`` bus).

The supervisor registers *jobs* in discovery (discovery/service.py);
the serving half used to run as a lone replica nothing registered,
watched, or drained. A FleetMember closes that gap for an in-process
``InferenceServer``:

- **Registration + heartbeats.** The replica is advertised under a
  service name with a TTL check (the exact ServiceRegistration /
  ServiceDefinition machinery jobs use, FIFO catalog queue included).
  Heartbeats fire only while the replica is genuinely serveable
  (``server.ready`` and not draining), so a wedged or warming replica
  goes catalog-critical by TTL expiry exactly like a wedged job.
  Because catalog ops drain through the discovery FIFO's long-lived
  thread, an HTTP backend (consul) serves every TTL refresh over ONE
  persistent keep-alive connection instead of dialing each beat.
- **Drain = migrate, then deregister.** ``drain()`` flips the server
  into maintenance (health 503, new generate/completions rejected with
  503 + Retry-After), then — before the catalog record vanishes —
  evacuates the replica's cached KV prefixes to the digest-coldest
  healthy survivors over the handoff wire in reverse
  (``server.migrate_sessions``, bounded by ``migrate_window``),
  heartbeating ``mg=`` progress so the gateway repoints sticky pins as
  each session lands. Only then does it deregister and wait for
  in-flight requests — including running slot-engine rows — to finish.
  Migration failure of any kind (no survivors, dead targets, window
  expiry) falls back to today's behavior: deregister and let the
  survivors re-prefill. ``resume()`` undoes maintenance; the next
  heartbeat lazily re-registers.
- **Control plane.** ``attach_bus(bus)`` subscribes to the event
  bus's maintenance events, so the supervisor's
  ``POST /v3/maintenance/enable|disable`` drains/resumes the replica
  the same way it deregisters jobs.

The ``server`` only needs the drain surface (``ready``, ``draining``,
``enter_maintenance``/``exit_maintenance``, ``inflight``, ``port``) —
anything duck-typing it (tests, future pod frontends) can join a
fleet.
"""
from __future__ import annotations

import asyncio
import logging
import time
import uuid
from typing import Any, Iterable, Optional

from ..discovery import Backend, ServiceDefinition, ServiceRegistration
from ..events import (
    EventBus,
    EventHandler,
    GLOBAL_ENTER_MAINTENANCE,
    GLOBAL_EXIT_MAINTENANCE,
    GLOBAL_SHUTDOWN,
    QUIT_BY_TEST,
)
from ..utils.tasks import spawn
from . import notes

log = logging.getLogger("containerpilot.fleet")


class FleetMember(EventHandler):
    def __init__(
        self,
        server: Any,
        backend: Backend,
        service_name: str = "inference",
        *,
        ttl: int = 10,
        heartbeat_interval: float = 0.0,
        address: str = "127.0.0.1",
        instance_id: str = "",
        tags: Iterable[str] = (),
        advertise_port: Optional[int] = None,
        migrate_window: float = 5.0,
    ) -> None:
        super().__init__()
        if ttl < 1:
            raise ValueError("ttl must be >= 1 second")
        if migrate_window < 0:
            raise ValueError("migrate_window must be >= 0 seconds")
        self.server = server
        self.backend = backend
        self.service_name = service_name
        self.ttl = ttl
        # default cadence: two beats per TTL window, like the
        # reference's heartbeat guidance — one missed beat never
        # flips a healthy replica critical
        self.heartbeat_interval = heartbeat_interval or ttl / 2.0
        self.instance_id = (
            instance_id or f"{service_name}-{uuid.uuid4().hex[:8]}"
        )
        # advertise a different port than the server's bind (NAT'd
        # deployments; the chaos harness's transport proxies)
        self.advertise_port = advertise_port
        #: seconds a drain spends evacuating KV to survivors before
        #: deregistering; 0 disables migration (today's drain)
        self.migrate_window = float(migrate_window)
        # True only while drain() is inside its migrate window: the
        # ONE draining state that still heartbeats (carrying mg=
        # progress) — after deregister the flag is down again, so a
        # drained replica can never lazily re-register itself
        self._evacuating = False
        self.service = ServiceDefinition(
            ServiceRegistration(
                id=self.instance_id,
                name=service_name,
                port=int(
                    advertise_port
                    or getattr(server, "port", 0) or 0
                ),
                ttl=ttl,
                tags=list(tags),
                address=address,
            ),
            backend,
        )
        self._beat_task: Optional["asyncio.Task[None]"] = None
        self._bus_task: Optional["asyncio.Task[None]"] = None

    # -- lifecycle ------------------------------------------------------

    async def start(self) -> None:
        """Start heartbeating. Call after ``server.run()`` so a
        port-0 bind has resolved to the real port."""
        self.service.registration.port = int(
            self.advertise_port
            or getattr(self.server, "port", 0) or 0
        )
        self._beat_task = spawn(
            self._beat_loop(), name=f"fleet-member:{self.instance_id}"
        )

    async def stop(self, deregister: bool = True) -> None:
        for task in (self._beat_task, self._bus_task):
            if task is not None and not task.done():
                task.cancel()
                try:
                    await task
                except asyncio.CancelledError:
                    pass
        self._beat_task = self._bus_task = None
        if deregister:
            await self._deregister()

    async def _beat_loop(self) -> None:
        while True:
            try:
                self._beat_once()
            except Exception as exc:
                # a flaky catalog must not kill the heartbeat task: a
                # dead loop silently TTL-expires a HEALTHY replica out
                # of every gateway's routing set within one window
                log.warning(
                    "%s: heartbeat failed: %s", self.instance_id, exc
                )
            await asyncio.sleep(self.heartbeat_interval)

    def _beat_once(self) -> None:
        if (
            getattr(self.server, "draining", False)
            and not self._evacuating
        ):
            return  # drained replicas stay out of the catalog
        if getattr(self.server, "ready", False):
            # lazy-register + TTL refresh; enqueued FIFO off-loop.
            # The beat carries the replica's whole advertisement as
            # the check output — occupancy, role, compile cache,
            # KV-reuse counters, prefix digest, device-time ledger,
            # migration progress — assembled field-by-field from the
            # note-wire registry (``fleet/notes.py``), which owns
            # every field name and its producer/parser pair. The
            # registry duck-types the server surface the way this
            # method always did: an accessor a server doesn't grow
            # simply omits its field, costing zero note bytes.
            self.service.send_heartbeat(
                output=notes.member_note(self.server)
            )
        # not ready (warming, or wedged enough that ready regressed):
        # no beat — an existing record's TTL expiry flips it critical

    async def _deregister(self) -> None:
        future = self.service.deregister()
        if future is not None:
            try:
                await asyncio.wrap_future(future)
            except Exception as exc:  # catalog gone is not fatal here
                log.warning(
                    "%s: deregister failed: %s", self.instance_id, exc
                )

    # -- drain ----------------------------------------------------------

    async def drain(
        self, wait: bool = True, timeout: float = 30.0
    ) -> bool:
        """Maintenance: stop accepting, MIGRATE cached KV to the
        survivors, then stop advertising and finish in-flight.
        Returns True once the replica is idle (always True for
        ``wait=False``; False only on timeout).

        The ordering is the tentpole: migrate -> deregister ->
        in-flight completion. During the bounded migrate window the
        catalog record stays alive and heartbeats ``mg=`` progress,
        so the gateway repoints each landed session's pin BEFORE the
        record vanishes; any migration failure degrades to exactly
        the old drain (deregister + survivor re-prefill), never an
        error."""
        self.server.enter_maintenance()
        if self.migrate_window > 0 and callable(
            getattr(self.server, "migrate_sessions", None)
        ):
            self._evacuating = True
            try:
                targets = await self._survivors()
                if targets:
                    reg = self.service.registration
                    summary = await self.server.migrate_sessions(
                        targets,
                        window_s=self.migrate_window,
                        authority=f"{reg.address}:{reg.port}",
                    )
                    # flush the final landings into the catalog, then
                    # linger two beats — long enough for one full
                    # gateway poll cycle to read them (gateways poll
                    # at least as often as members beat) before the
                    # record deregisters
                    self._beat_once()
                    if int(summary.get("done", 0) or 0) > 0:
                        await asyncio.sleep(
                            min(self.heartbeat_interval * 2.0, 1.0)
                        )
            except Exception as exc:
                # migration is an accelerator for the drain, never a
                # blocker: any failure here means survivors re-prefill
                log.warning(
                    "%s: drain migration failed (%s); falling back "
                    "to plain drain", self.instance_id, exc,
                )
            finally:
                self._evacuating = False
        await self._deregister()
        if not wait:
            return True
        deadline = time.monotonic() + timeout
        while getattr(self.server, "inflight", 0) > 0:
            if time.monotonic() >= deadline:
                log.warning(
                    "%s: drain timed out with %d in flight",
                    self.instance_id,
                    self.server.inflight,
                )
                return False
            await asyncio.sleep(0.02)
        log.info("%s: drained", self.instance_id)
        return True

    async def _survivors(self) -> list:
        """The healthy peers a drain may migrate KV toward:
        ``(instance_id, address, port, fingerprint_set)`` per catalog
        record, excluding self, standbys and the prefill pool (a
        session's KV belongs where decode runs), and peers that are
        themselves mid-migration. Catalog errors return [] — the
        drain then falls back to a plain deregister."""
        loop = asyncio.get_event_loop()
        try:
            instances = await loop.run_in_executor(
                None, self.backend.instances, self.service_name
            )
        except Exception as exc:
            log.warning(
                "%s: survivor discovery failed: %s",
                self.instance_id, exc,
            )
            return []
        out = []
        for inst in instances or []:
            if inst.id == self.instance_id:
                continue
            fields = notes.split_note(getattr(inst, "notes", ""))
            if fields.get("role", "") in ("standby", "prefill"):
                continue
            mg, _landed = notes.parse_field("mg", fields.get("mg", ""))
            if mg["active"]:
                continue
            _ver, fps = notes.parse_field("pd", fields.get("pd", ""))
            out.append(
                (inst.id, inst.address, int(inst.port), fps)
            )
        out.sort(key=lambda t: t[0])
        return out

    def resume(self) -> None:
        """Exit maintenance; the next heartbeat lazily re-registers
        (deregister reset ``was_registered``)."""
        self.server.exit_maintenance()

    # -- control-plane hookup -------------------------------------------

    def attach_bus(self, bus: EventBus) -> "asyncio.Task[None]":
        """Subscribe to the supervisor bus so the control plane's
        maintenance verbs drain/resume this replica."""
        self.subscribe(bus)
        self.register(bus)
        self._bus_task = spawn(
            self._bus_loop(), name=f"fleet-member-bus:{self.instance_id}"
        )
        return self._bus_task

    async def _bus_loop(self) -> None:
        try:
            while True:
                event = await self.next_event()
                if event in (GLOBAL_SHUTDOWN, QUIT_BY_TEST):
                    return
                if event == GLOBAL_ENTER_MAINTENANCE:
                    await self.drain()
                elif event == GLOBAL_EXIT_MAINTENANCE:
                    self.resume()
        except asyncio.CancelledError:
            pass
        finally:
            self.unsubscribe()
            self.unregister()

    def __repr__(self) -> str:  # pragma: no cover - trivial
        return f"fleet.FleetMember[{self.instance_id}]"
