"""The telemetry server: Prometheus /metrics + /status JSON.

Capability parity with the reference (reference: telemetry/telemetry.go,
telemetry/status.go): a TCP HTTP server (default :9090) exposing

- ``/metrics``: the Prometheus exposition (built-in supervisor metrics
  plus user-defined metric collectors), and
- ``/status``: JSON of job/service/watch state, with live job status
  resolved at request time (reference: status.go:47-69).

The server advertises itself in the catalog via the synthetic
``containerpilot`` job (see config.py), exactly like the reference.
Bind retries tolerate a lingering port from a prior generation
(reference: telemetry/telemetry.go:82-88).

The port's own copy of ``containerpilot_tpu/telemetry/telemetry.py``.
"""
from __future__ import annotations

import asyncio
import json
import logging
from typing import TYPE_CHECKING, Any, Dict, List

from ..utils.http import HTTPServer, Request, Response
from ..utils.prom import REGISTRY, ensure_build_info, exposition
from ..version import VERSION
from .config import TelemetryConfig
from .metrics import Metric

if TYPE_CHECKING:  # pragma: no cover
    from ..jobs import Job
    from ..watches import Watch

log = logging.getLogger("containerpilot.telemetry")

BIND_RETRIES = 10
BIND_RETRY_DELAY = 1.0  # reference: telemetry.go:82-88 / control.go:130-137


class Telemetry:
    def __init__(self, cfg: TelemetryConfig) -> None:
        self.cfg = cfg
        self.metrics: List[Metric] = [Metric(m) for m in cfg.metrics]
        # the shared identity gauge every /metrics surface exports
        ensure_build_info(REGISTRY, "supervisor")
        self._server = HTTPServer()
        self._server.route("GET", "/metrics", self._handle_metrics)
        self._server.route("GET", "/status", self._handle_status)
        # /status sources (reference: telemetry/status.go:72-103)
        self._jobs: List["Job"] = []
        self._watch_names: List[str] = []

    def monitor_jobs(self, jobs: List["Job"]) -> None:
        self._jobs = [j for j in jobs if j.name != "containerpilot"]

    def monitor_watches(self, watches: List["Watch"]) -> None:
        self._watch_names = [w.name for w in watches]

    async def _handle_metrics(self, _req: Request) -> Response:
        # ONE exposition convention for every /metrics surface in-tree
        # (supervisor, serving, fleet gateway): utils/prom.py
        payload, content_type = exposition(REGISTRY)
        return Response(200, payload, content_type=content_type)

    async def _handle_status(self, _req: Request) -> Response:
        jobs_out: List[Dict[str, Any]] = []
        services_out: List[Dict[str, Any]] = []
        for job in self._jobs:
            status = str(job.get_status())
            jobs_out.append({"Name": job.name, "Status": status})
            if job.service is not None:
                services_out.append(
                    {
                        "Name": job.service.name,
                        "Address": job.service.registration.address,
                        "Port": job.service.registration.port,
                        "Status": status,
                    }
                )
        body = json.dumps(
            {
                "Version": VERSION,
                "Jobs": jobs_out,
                "Services": services_out,
                "Watches": self._watch_names,
            }
        ).encode()
        return Response(200, body, content_type="application/json")

    async def run(self) -> None:
        """Bind with retries (a prior generation's socket may linger)."""
        for attempt in range(BIND_RETRIES):
            try:
                await self._server.start_tcp(self.cfg.address, self.cfg.port)
                log.info(
                    "telemetry: serving on %s:%d", self.cfg.address, self.cfg.port
                )
                return
            except OSError as exc:
                if attempt == BIND_RETRIES - 1:
                    raise
                log.warning(
                    "telemetry: bind failed (%s), retrying in %.0fs",
                    exc,
                    BIND_RETRY_DELAY,
                )
                await asyncio.sleep(BIND_RETRY_DELAY)

    async def stop(self) -> None:
        await self._server.stop()
