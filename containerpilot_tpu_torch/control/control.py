"""The control plane: HTTP over a unix domain socket.

Capability parity with the reference (reference: control/control.go,
control/endpoints.go). Endpoints (all under /v3):

- ``POST /v3/environ``              set env vars for future execs/reloads
- ``POST /v3/reload``               set reload flag + shut down generation
- ``POST /v3/metric``               publish {METRIC, "name|value"} events
- ``POST /v3/maintenance/enable``   publish GlobalEnterMaintenance
- ``POST /v3/maintenance/disable``  publish GlobalExitMaintenance
- ``GET  /v3/maintenance/status``   {"maintenance": bool} (extension:
  drain runbooks confirm the flip landed)
- ``GET  /v3/ping``                 liveness of the socket

Binding retries while a prior generation's socket file lingers
(reference: control/control.go:125-140). A Prometheus counter tracks
request statuses (reference: control/control.go:27-33).

The port's own copy of ``containerpilot_tpu/control/control.py``.
"""
from __future__ import annotations

import asyncio
import json
import logging
import os
from typing import Optional

from ..events import (
    Event,
    EventBus,
    EventCode,
    GLOBAL_ENTER_MAINTENANCE,
    GLOBAL_EXIT_MAINTENANCE,
)
from ..utils.http import HTTPServer, Request, Response
from ..utils.prom import REGISTRY, Counter
from .config import ControlConfig

log = logging.getLogger("containerpilot.control")

BIND_RETRIES = 10
BIND_RETRY_DELAY = 1.0  # reference: control/control.go:130-137

_REQUEST_COUNTER = Counter(
    "containerpilot_control_http_requests",
    "Control-plane HTTP requests by status and path",
    ["status", "path"],
    registry=REGISTRY,
)


class ControlServer:
    """One generation's control server (reference: control/control.go:36-93)."""

    def __init__(self, cfg: ControlConfig) -> None:
        self.cfg = cfg
        self.bus: Optional[EventBus] = None
        # the last maintenance verb posted through THIS generation's
        # socket; /v3/maintenance/status reads it back so operators
        # (and fleet drain runbooks) can confirm the flip landed
        self.maintenance = False
        self._server = HTTPServer()
        self._server.route("GET", "/v3/ping", self._ping)
        self._server.route("POST", "/v3/environ", self._put_environ)
        self._server.route("POST", "/v3/reload", self._post_reload)
        self._server.route("POST", "/v3/metric", self._post_metric)
        self._server.route(
            "POST", "/v3/maintenance/enable", self._post_maintenance_enable
        )
        self._server.route(
            "POST", "/v3/maintenance/disable", self._post_maintenance_disable
        )
        self._server.route(
            "GET", "/v3/maintenance/status", self._get_maintenance_status
        )
        # observability beyond the reference: the bus's recent-event
        # ring and the live actor-task table, for debugging live
        # supervisors
        self._server.route("GET", "/v3/events", self._get_events)
        self._server.route("GET", "/v3/tasks", self._get_tasks)

    # -- lifecycle ------------------------------------------------------

    async def run(self, bus: EventBus) -> None:
        self.bus = bus
        await self._listen_with_retry()

    async def _listen_with_retry(self) -> None:
        for attempt in range(BIND_RETRIES):
            try:
                self._try_unlink_stale_socket()
                await self._server.start_unix(self.cfg.socket)
                os.chmod(self.cfg.socket, 0o660)
                log.debug("control: serving at %s", self.cfg.socket)
                return
            except OSError as exc:
                if attempt == BIND_RETRIES - 1:
                    raise
                log.warning(
                    "control: error listening to socket at %s: %s",
                    self.cfg.socket,
                    exc,
                )
                await asyncio.sleep(BIND_RETRY_DELAY)

    def _try_unlink_stale_socket(self) -> None:
        """A previous generation (or crashed supervisor) may have left
        the socket file behind; a fresh bind needs it gone
        (reference: control/control.go:125-140)."""
        if os.path.exists(self.cfg.socket):
            try:
                os.unlink(self.cfg.socket)
            except OSError:
                pass

    async def stop(self) -> None:
        await self._server.stop()
        self._try_unlink_stale_socket()

    # -- endpoint helpers -----------------------------------------------

    def _count(self, status: int, path: str) -> None:
        _REQUEST_COUNTER.labels(str(status), path).inc()

    def _respond(
        self,
        status: int,
        path: str,
        body: bytes = b"\n",
        content_type: str = "text/plain; charset=utf-8",
    ) -> Response:
        self._count(status, path)
        return Response(status, body, content_type=content_type)

    # -- endpoints ------------------------------------------------------

    async def _ping(self, req: Request) -> Response:
        return self._respond(200, req.path)

    async def _put_environ(self, req: Request) -> Response:
        """Set env vars in the supervisor process so reloads and future
        execs observe them (reference: endpoints.go:57-72); '-putenv'
        persistence across reloads comes from this process surviving
        generations."""
        try:
            env = json.loads(req.body.decode() or "null")
            if not isinstance(env, dict):
                raise ValueError("not an object")
            for key, value in env.items():
                os.environ[str(key)] = str(value)
        except (ValueError, UnicodeDecodeError):
            return self._respond(422, req.path)
        return self._respond(200, req.path)

    async def _post_reload(self, req: Request) -> Response:
        log.debug("control: reloading app via control plane")
        assert self.bus is not None
        self.bus.set_reload_flag()
        self.bus.shutdown()
        return self._respond(200, req.path)

    async def _post_metric(self, req: Request) -> Response:
        assert self.bus is not None
        try:
            metrics = json.loads(req.body.decode() or "null")
            if not isinstance(metrics, dict):
                raise ValueError("not an object")
        except (ValueError, UnicodeDecodeError):
            return self._respond(422, req.path)
        for key, value in metrics.items():
            self.bus.publish(Event(EventCode.METRIC, f"{key}|{value}"))
        return self._respond(200, req.path)

    async def _get_events(self, req: Request) -> Response:
        assert self.bus is not None
        body = json.dumps(
            [
                {"code": e.code.value, "source": e.source}
                for e in self.bus.debug_events()
            ]
        ).encode()
        return self._respond(200, req.path, body, "application/json")

    async def _get_tasks(self, req: Request) -> Response:
        """Live asyncio task table — which actors/timers/execs exist
        right now (the single-event-loop analog of a thread dump)."""
        tasks = sorted(
            t.get_name()
            for t in asyncio.all_tasks()
            if not t.done()
        )
        body = json.dumps(tasks).encode()
        return self._respond(200, req.path, body, "application/json")

    async def _post_maintenance_enable(self, req: Request) -> Response:
        assert self.bus is not None
        self.maintenance = True
        self.bus.publish(GLOBAL_ENTER_MAINTENANCE)
        return self._respond(200, req.path)

    async def _post_maintenance_disable(self, req: Request) -> Response:
        assert self.bus is not None
        self.maintenance = False
        self.bus.publish(GLOBAL_EXIT_MAINTENANCE)
        return self._respond(200, req.path)

    async def _get_maintenance_status(self, req: Request) -> Response:
        body = json.dumps({"maintenance": self.maintenance}).encode()
        return self._respond(200, req.path, body, "application/json")
