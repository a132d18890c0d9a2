"""Fault injection for the chaos harness (the port's own copy of
``containerpilot_tpu/chaos/faults.py``, on the port's ``discovery``).

Five fault families, each reproducing a real production failure the
reference ContainerPilot's design exists to absorb:

- **Replica kill** (SIGKILL semantics): the replica's listener and
  every live connection drop abruptly and its heartbeats stop WITHOUT
  deregistering — the catalog record decays to critical by TTL expiry,
  exactly like a host that lost power. In-flight requests see resets;
  the gateway must retry them away and route around the corpse.
- **Wedged health check**: the replica process is alive but stops
  being serveable (``ready`` regresses — a wedged device tunnel, a
  deadlocked worker). Heartbeats stop, the record TTL-expires, traffic
  routes around it; recovery resumes beats and the record revives.
- **Slow replica**: injected per-request latency via the serve-side
  test hook (``InferenceServer.chaos_hook``) — the brownout case tail
  hedging exists for.
- **Lossy transport**: a TCP proxy in front of the replica aborts
  connections after N response bytes (RST mid-response), modeling a
  flaky NIC/conntrack path between gateway and replica.
- **Catalog flap**: the discovery backend transiently answers with an
  empty healthy set (torn NFS read, catalog restart). The gateway's
  hold-down must damp it instead of wiping its routing table.
- **Slow boot**: every replica launched AFTER the fault arms takes an
  extra N seconds in warmup (injected through the serve-side
  ``chaos_hook`` seam, attributed as ``compile_warmup`` in the
  device-time ledger) — the production shape of a cold scale-up
  paying image pull + weight load + kernel builds mid-burst, and the
  fault the warm-standby pool (fleet/standby.py) exists to mask:
  promotion skips the slow boot entirely while the background refill
  pays it off the critical path.

Faults are declarative ``(at_s, kind, target)`` records; the scenario
runner applies each when the trace clock passes ``at_s`` and logs it
into the report's fault ledger.
"""
from __future__ import annotations

import asyncio
import logging
from dataclasses import dataclass
from typing import List, Optional, Tuple

from ..discovery import Backend, ServiceInstance, ServiceRegistration

log = logging.getLogger("containerpilot.chaos")


class FlakyBackend(Backend):
    """Delegating discovery backend that can serve a bounded run of
    empty reads — the gateway-visible shape of a torn catalog read or
    a catalog server restart. Registration/TTL verbs pass through
    untouched (members keep heartbeating the real catalog; only the
    reader flaps, which is how NFS tears actually present)."""

    def __init__(self, inner: Backend) -> None:
        self.inner = inner
        self._empty_reads_left = 0
        self.flaps_served = 0

    def flap(self, polls: int) -> None:
        """Serve the next ``polls`` poll cycles an empty healthy set."""
        self._empty_reads_left = polls

    # -- reader surface (flappable) ---------------------------------

    def check_for_upstream_changes(
        self, service_name: str, tag: str = "", dc: str = ""
    ) -> Tuple[bool, bool]:
        if self._empty_reads_left > 0:
            # a torn read looks like "everything vanished": report a
            # change to an empty healthy set. The budget is consumed
            # by instances() — one poll cycle is check + re-list, and
            # reporting a change guarantees the gateway re-lists.
            return True, False
        return self.inner.check_for_upstream_changes(
            service_name, tag, dc
        )

    def instances(
        self, service_name: str, tag: str = ""
    ) -> List[ServiceInstance]:
        if self._empty_reads_left > 0:
            self._empty_reads_left -= 1
            self.flaps_served += 1
            return []
        return self.inner.instances(service_name, tag)

    # -- writer surface (pass-through) -------------------------------

    def service_register(
        self, registration: ServiceRegistration, status: str = ""
    ) -> None:
        self.inner.service_register(registration, status)

    def service_deregister(self, service_id: str) -> None:
        self.inner.service_deregister(service_id)

    def update_ttl(self, check_id: str, output: str, status: str) -> None:
        self.inner.update_ttl(check_id, output, status)


class ChaosProxy:
    """TCP forwarder between the gateway and one replica that can
    inject transport loss: when armed, each connection's server->client
    relay aborts (RST, not FIN) after forwarding ``reset_after_bytes``
    response bytes. Registered in the catalog in the replica's place,
    so the gateway dials through it without knowing."""

    def __init__(
        self, target_host: str, target_port: int, host: str = "127.0.0.1"
    ) -> None:
        self.target_host = target_host
        self.target_port = target_port
        self.host = host
        self.port = 0
        self.reset_after_bytes: Optional[int] = None
        self.resets_injected = 0
        self._server: Optional[asyncio.AbstractServer] = None
        self._conns: List[asyncio.StreamWriter] = []

    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._handle, self.host, 0
        )
        self.port = self._server.sockets[0].getsockname()[1]

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            for writer in list(self._conns):
                writer.close()
            await self._server.wait_closed()
            self._server = None

    async def _handle(
        self,
        client_reader: asyncio.StreamReader,
        client_writer: asyncio.StreamWriter,
    ) -> None:
        try:
            upstream_reader, upstream_writer = (
                await asyncio.open_connection(
                    self.target_host, self.target_port
                )
            )
        except OSError:
            client_writer.close()
            return
        self._conns.extend((client_writer, upstream_writer))
        # the response side carries the injected fault; the request
        # side forwards verbatim
        up = asyncio.ensure_future(
            self._relay(client_reader, upstream_writer)
        )
        down = asyncio.ensure_future(
            self._relay(
                upstream_reader, client_writer,
                limit_writer=client_writer,
            )
        )
        try:
            await asyncio.gather(up, down, return_exceptions=True)
        finally:
            for writer in (client_writer, upstream_writer):
                try:
                    writer.close()
                except Exception:  # cpcheck: disable=CP-SWALLOW — teardown guard: socket already dead
                    pass
                if writer in self._conns:
                    self._conns.remove(writer)

    async def _relay(
        self,
        reader: asyncio.StreamReader,
        writer: asyncio.StreamWriter,
        limit_writer: Optional[asyncio.StreamWriter] = None,
    ) -> None:
        """Pump bytes until EOF. When this is the response direction
        (``limit_writer`` set) and the proxy is armed, abort after the
        byte budget — transport.abort() sends an RST so the gateway
        sees a hard connection reset, not a tidy FIN."""
        forwarded = 0
        try:
            while True:
                chunk = await reader.read(65536)
                if not chunk:
                    break
                budget = (
                    self.reset_after_bytes
                    if limit_writer is not None else None
                )
                if budget is not None and forwarded + len(chunk) > budget:
                    writer.write(chunk[: max(0, budget - forwarded)])
                    await writer.drain()
                    self.resets_injected += 1
                    limit_writer.transport.abort()
                    return
                forwarded += len(chunk)
                writer.write(chunk)
                await writer.drain()
        except (OSError, asyncio.CancelledError):
            return
        finally:
            try:
                writer.write_eof()
            except (OSError, RuntimeError):
                return


@dataclass(frozen=True)
class Fault:
    """One scheduled fault. ``kind`` selects the harness verb; the
    scenario runner applies it when the trace clock passes ``at_s``."""

    at_s: float
    kind: str  # kill | wedge | unwedge | slow | slow_boot | lossy | flap
    replica: int = 0
    #: kind-specific magnitude: slow -> delay seconds; slow_boot ->
    #: warmup delay seconds for replicas launched after it arms (0
    #: disarms); lossy -> reset after this many response bytes (0
    #: disarms); flap -> poll count
    value: float = 0.0
