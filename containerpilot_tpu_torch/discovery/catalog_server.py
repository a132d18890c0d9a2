"""cp-catalogd: a Consul-API-compatible catalog server for pods.

The reference delegates cross-host coordination entirely to an external
Consul cluster (reference: discovery/consul.go). Pods usually don't
run one — so this framework ships its own catalog daemon speaking the
same agent-API subset the supervisor (and anything else using that API)
needs:

    PUT /v1/agent/service/register          body: AgentServiceRegistration
    PUT /v1/agent/service/deregister/<id>
    PUT /v1/agent/check/update/<check-id>   body: {Status, Output}
    GET /v1/health/service/<name>?passing=1[&tag=][&dc=]

One host in the pod (or a CPU VM) runs:

    python -m containerpilot_tpu_torch -catalog-server 0.0.0.0:8500

and every host's supervisor points ``consul: "<leader>:8500"`` at it
over DCN. TTL semantics match Consul: a check that misses its TTL goes
critical and drops out of passing health queries;
``DeregisterCriticalServiceAfter`` reaps long-critical services.

State is in-memory; with ``-catalog-snapshot`` it is also journaled to disk
(atomic JSON snapshot, written when dirty) and reloaded on start, so a
supervised catalog daemon that crashes and restarts serves its last
known registrations immediately instead of returning an empty catalog
until every supervisor's next heartbeat. Restored TTLs are re-armed
for one fresh TTL window (the entry was passing when snapshotted; its
owner gets one round to heartbeat before it goes critical).

The port's own copy of ``containerpilot_tpu/discovery/catalog_server.py``.
"""
from __future__ import annotations

import asyncio
import json
import logging
import os
import time
import urllib.parse
from dataclasses import asdict, dataclass, field
from typing import Any, Dict, List, Optional

from ..config.timing import DurationError, parse_duration
from ..utils.http import HTTPServer, Request, Response
from ..utils.tasks import spawn

log = logging.getLogger("containerpilot.catalog")


@dataclass
class _Entry:
    id: str
    name: str
    address: str
    port: int
    tags: List[str]
    ttl: float
    status: str = "critical"
    expires: float = 0.0  # 0 = never passed yet
    dereg_after: float = 0.0  # seconds critical before reaping; 0 = never
    critical_since: float = 0.0
    enable_tag_override: bool = False

    def effective_status(self, now: float) -> str:
        if self.status == "passing" and self.ttl > 0 and now > self.expires:
            return "critical"
        return self.status


class CatalogServer:
    """In-memory Consul-compatible catalog."""

    def __init__(
        self, host: str = "0.0.0.0", port: int = 8500, dc: str = "dc1",
        snapshot_path: str = "", snapshot_every: float = 2.0,
    ) -> None:
        self.host = host
        self.port = port
        self.dc = dc  # health queries for another dc return empty
        self.snapshot_path = snapshot_path
        self.snapshot_every = snapshot_every
        self._dirty = False
        self._entries: Dict[str, _Entry] = {}  # by instance id
        self._server = HTTPServer()
        self._reaper: Optional["asyncio.Task[None]"] = None
        # routes with path params are matched manually
        self._server.route(
            "PUT", "/v1/agent/service/register", self._register
        )
        self._server.fallback = self._dispatch_dynamic

    # -- lifecycle --------------------------------------------------------

    async def run(self) -> None:
        if self.snapshot_path:
            # disk read off-loop: nothing is serving yet, but a slow
            # volume must not delay sibling tasks on this loop
            await asyncio.get_running_loop().run_in_executor(
                None, self._load_snapshot
            )
        await self._server.start_tcp(self.host, self.port)
        self._reaper = spawn(self._reap_loop(), name="catalog-reaper")
        log.info("catalog: serving Consul-compatible API on %s:%d",
                 self.host, self.port)

    async def stop(self) -> None:
        if self._reaper is not None:
            self._reaper.cancel()
        await self._server.stop()
        # final write AFTER the listener is down: a mutation handled
        # during shutdown was acknowledged, so it must be journaled
        if self.snapshot_path:
            await self._journal()

    # -- durability -------------------------------------------------------

    def _load_snapshot(self) -> None:
        try:
            with open(self.snapshot_path) as fh:
                raw = json.load(fh)
        except FileNotFoundError:
            return
        except (OSError, ValueError) as exc:
            log.warning("catalog: unreadable snapshot %s (%s); starting "
                        "empty", self.snapshot_path, exc)
            return
        now = time.time()
        saved_at = float(raw.get("saved_at") or now)
        for item in raw.get("entries", []):
            try:
                entry = _Entry(**item)
            except TypeError:
                log.warning("catalog: skipping malformed snapshot entry")
                continue
            if entry.status == "passing" and entry.ttl > 0:
                if entry.expires >= saved_at:
                    # it was genuinely passing when journaled: one
                    # fresh TTL window to heartbeat before critical
                    entry.expires = now + entry.ttl
                else:
                    # its TTL had already lapsed pre-snapshot (expiry
                    # is computed at query time, never written back) —
                    # don't resurrect a dead service as healthy
                    entry.status = "critical"
            entry.critical_since = 0.0
            self._entries[entry.id] = entry
        if self._entries:
            log.info("catalog: restored %d entries from %s",
                     len(self._entries), self.snapshot_path)

    def _snapshot_payload(self) -> dict:
        """Freeze entry state for journaling. Runs ON the event loop —
        the write happens off-loop, and ``_entries`` must not be
        iterated there while request handlers keep mutating it."""
        return {
            "saved_at": time.time(),
            "entries": [asdict(e) for e in
                        sorted(self._entries.values(),
                               key=lambda e: e.id)],
        }

    def _write_snapshot(self, payload: Optional[dict] = None) -> bool:
        """Blocking file write; async callers go through _journal."""
        if payload is None:
            payload = self._snapshot_payload()
        tmp = f"{self.snapshot_path}.tmp"
        try:
            with open(tmp, "w") as fh:
                json.dump(payload, fh)
            os.replace(tmp, self.snapshot_path)  # atomic on POSIX
            return True
        except OSError as exc:
            log.warning("catalog: snapshot write failed: %s", exc)
            return False

    async def _journal(self) -> None:
        """Snapshot to disk without stalling the loop: capture the
        payload here, hand the file I/O to the default executor."""
        payload = self._snapshot_payload()
        # clear BEFORE the write so mutations landing during it
        # re-dirty the journal and get picked up next cadence
        self._dirty = False
        ok = await asyncio.get_running_loop().run_in_executor(
            None, self._write_snapshot, payload
        )
        if not ok:
            self._dirty = True

    async def _reap_loop(self) -> None:
        """Reap services critical longer than DeregisterCriticalServiceAfter;
        journal dirty state to the snapshot file on the same cadence."""
        last_snapshot = 0.0
        try:
            while True:
                await asyncio.sleep(
                    min(1.0, self.snapshot_every) if self.snapshot_path
                    else 1.0
                )
                if (
                    self.snapshot_path and self._dirty
                    and time.time() - last_snapshot >= self.snapshot_every
                ):
                    await self._journal()
                    last_snapshot = time.time()
                now = time.time()
                for entry in list(self._entries.values()):
                    status = entry.effective_status(now)
                    if status == "critical":
                        if entry.critical_since == 0.0:
                            entry.critical_since = now
                            # journal the transition: a later hard
                            # crash must not restore this entry from a
                            # stale passing-era snapshot (the rewrite
                            # moves saved_at past its expires)
                            self._dirty = True
                        elif (
                            entry.dereg_after > 0
                            and now - entry.critical_since > entry.dereg_after
                        ):
                            log.info(
                                "catalog: reaping %s (critical > %.0fs)",
                                entry.id,
                                entry.dereg_after,
                            )
                            self._entries.pop(entry.id, None)
                            self._dirty = True
                    else:
                        entry.critical_since = 0.0
        except asyncio.CancelledError:
            pass

    # -- handlers -----------------------------------------------------------

    async def _register(self, req: Request) -> Response:
        try:
            body = json.loads(req.body.decode() or "{}")
        except ValueError:
            return Response(400, b"bad json\n")
        check = body.get("Check") or {}
        ttl = 0.0
        if check.get("TTL"):
            try:
                ttl = parse_duration(check["TTL"])
            except DurationError:
                return Response(400, b"bad TTL\n")
        dereg_after = 0.0
        if check.get("DeregisterCriticalServiceAfter"):
            try:
                dereg_after = parse_duration(
                    check["DeregisterCriticalServiceAfter"]
                )
            except DurationError:
                return Response(400, b"bad DeregisterCriticalServiceAfter\n")
        try:
            port = int(body.get("Port") or 0)
        except (TypeError, ValueError):
            return Response(400, b"bad Port\n")
        entry = _Entry(
            id=body.get("ID") or body.get("Name", ""),
            name=body.get("Name", ""),
            address=body.get("Address", ""),
            port=port,
            tags=list(body.get("Tags") or []),
            ttl=ttl,
            status=check.get("Status") or "critical",
            dereg_after=dereg_after,
            enable_tag_override=bool(body.get("EnableTagOverride", False)),
        )
        if not entry.id or not entry.name:
            return Response(400, b"service needs ID and Name\n")
        if entry.status == "passing" and entry.ttl > 0:
            entry.expires = time.time() + entry.ttl
        self._entries[entry.id] = entry
        self._dirty = True
        log.debug("catalog: registered %s (%s)", entry.id, entry.status)
        return Response(200, b"")

    async def _dispatch_dynamic(self, req: Request) -> Optional[Response]:
        if req.method == "PUT" and req.path.startswith(
            "/v1/agent/service/deregister/"
        ):
            service_id = urllib.parse.unquote(req.path.rsplit("/", 1)[-1])
            if self._entries.pop(service_id, None) is not None:
                self._dirty = True
            log.debug("catalog: deregistered %s", service_id)
            return Response(200, b"")
        if req.method == "PUT" and req.path.startswith(
            "/v1/agent/check/update/"
        ):
            check_id = urllib.parse.unquote(req.path.rsplit("/", 1)[-1])
            # check ids are "service:<instance-id>"
            instance_id = check_id.split(":", 1)[-1]
            entry = self._entries.get(instance_id)
            if entry is None:
                return Response(404, b"unknown check\n")
            try:
                body = json.loads(req.body.decode() or "{}")
            except ValueError:
                return Response(400, b"bad json\n")
            status = body.get("Status", "passing")
            new_status = "passing" if status in ("pass", "passing") else (
                "warning" if status in ("warn", "warning") else "critical"
            )
            if new_status != entry.status:
                # TTL refreshes alone don't dirty the snapshot (expires
                # is re-armed on restore); status transitions do
                self._dirty = True
            entry.status = new_status
            if entry.status == "passing" and entry.ttl > 0:
                entry.expires = time.time() + entry.ttl
            return Response(200, b"")
        if req.method == "GET" and req.path == "/metrics":
            # prometheus exposition for the catalog daemon itself, so a
            # supervised cp-catalogd is scrapeable like everything else
            now = time.time()
            by_status: Dict[str, int] = {}
            for entry in self._entries.values():
                status = entry.effective_status(now)
                by_status[status] = by_status.get(status, 0) + 1
            # one labeled family only: the total is sum(by status),
            # so an unlabeled twin would double-count aggregations
            lines = ["# TYPE cp_catalog_services gauge"]
            for status in ("passing", "warning", "critical"):
                lines.append(
                    f'cp_catalog_services{{status="{status}"}} '
                    f"{by_status.get(status, 0)}"
                )
            lines.append("# TYPE cp_catalog_snapshot_enabled gauge")
            lines.append(
                f"cp_catalog_snapshot_enabled "
                f"{1 if self.snapshot_path else 0}"
            )
            return Response(
                200, ("\n".join(lines) + "\n").encode(),
                content_type="text/plain; version=0.0.4",
            )
        if req.method == "GET" and req.path.startswith("/v1/health/service/"):
            name = urllib.parse.unquote(req.path.rsplit("/", 1)[-1])
            passing_only = req.query.get("passing", ["0"])[0] not in ("0", "")
            tag = req.query.get("tag", [""])[0]
            dc = req.query.get("dc", [""])[0]
            if dc and dc != self.dc:
                # this catalog serves exactly one datacenter
                return Response(
                    200, b"[]", content_type="application/json"
                )
            now = time.time()
            out: List[Dict[str, Any]] = []
            for entry in sorted(self._entries.values(), key=lambda e: e.id):
                if entry.name != name:
                    continue
                status = entry.effective_status(now)
                if passing_only and status != "passing":
                    continue
                if tag and tag not in entry.tags:
                    continue
                out.append(
                    {
                        "Node": {"Node": "catalog", "Address": entry.address},
                        "Service": {
                            "ID": entry.id,
                            "Service": entry.name,
                            "Address": entry.address,
                            "Port": entry.port,
                            "Tags": entry.tags,
                        },
                        "Checks": [
                            {
                                "CheckID": f"service:{entry.id}",
                                "Status": status,
                            }
                        ],
                    }
                )
            return Response(
                200, json.dumps(out).encode(), content_type="application/json"
            )
        return None
