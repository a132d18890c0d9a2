"""HTTP client for the control plane's unix socket.

Capability parity with the reference (reference: client/client.go):
one verb per control endpoint, used by the CLI subcommands and usable
as an SDK by supervised workloads (e.g. a training loop POSTing
step-rate metrics).

The client keeps ONE unix-socket connection across verbs (the control
server speaks HTTP/1.1 keep-alive): an SDK posting a metric every
step no longer pays a dial per call. If the server reaped the idle
connection (restart, idle timeout), the next verb sees the close
before any response byte and transparently redials once — the server
answered nothing, so nothing was applied. ``close()`` drops the kept
connection; ``keep_alive=False`` restores dial-per-verb.

The port's own copy of ``containerpilot_tpu/client/client.py``.
"""
from __future__ import annotations

import errno
import http.client
import json
import socket
import threading
import time
from typing import Any, Dict, Optional

from ..utils.httpclient import keepalive_request


class ControlClientError(RuntimeError):
    pass


# connect-phase failures worth retrying briefly: the socket file does
# not exist yet (supervisor still booting), nothing is accepting on it
# yet, or the kernel pushed back transiently. All three happen on the
# FIRST control call after `containerpilot start` and nothing has been
# sent when they fire, so a retry cannot double-apply a request.
_TRANSIENT_ERRNOS = frozenset(
    {errno.ECONNREFUSED, errno.EAGAIN, errno.ENOENT, errno.EALREADY}
)


class _UnixHTTPConnection(http.client.HTTPConnection):
    def __init__(self, socket_path: str, timeout: float = 10.0) -> None:
        super().__init__("localhost", timeout=timeout)
        self._socket_path = socket_path

    def connect(self) -> None:
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        sock.settimeout(self.timeout)
        sock.connect(self._socket_path)
        self.sock = sock


class ControlClient:
    def __init__(
        self,
        socket_path: str,
        timeout: float = 10.0,
        retries: int = 3,
        retry_delay: float = 0.05,
        keep_alive: bool = True,
    ) -> None:
        self.socket_path = socket_path
        self.timeout = timeout
        # >= 0 so _request's loop always makes at least one attempt
        # (its last iteration always returns or raises)
        self.retries = max(retries, 0)
        self.retry_delay = retry_delay
        self.keep_alive = keep_alive
        # the kept connection is taken/put under a lock so the client
        # stays thread-safe (each verb previously built a private
        # connection); concurrent verbs simply dial extra connections
        # and only one is kept
        self._conn: Optional[_UnixHTTPConnection] = None
        self._conn_lock = threading.Lock()

    def _take_conn(self) -> Optional[_UnixHTTPConnection]:
        with self._conn_lock:
            conn, self._conn = self._conn, None
        return conn

    def _put_conn(self, conn: _UnixHTTPConnection) -> None:
        with self._conn_lock:
            if self._conn is None:
                self._conn = conn
                return
        conn.close()

    def close(self) -> None:
        """Drop the kept connection (idempotent; the next verb
        redials)."""
        conn = self._take_conn()
        if conn is not None:
            try:
                conn.close()
            except OSError:
                pass

    def __enter__(self) -> "ControlClient":
        return self

    def __exit__(self, *_exc) -> None:
        self.close()

    def _request(
        self, method: str, path: str, body: Optional[Dict[str, Any]] = None
    ) -> str:
        """One control-plane round trip over the kept connection
        (utils/httpclient.py owns the redial discipline: a kept
        connection that failed before any response byte is resent
        once on a fresh dial; anything after response bytes is NOT —
        the server may have processed the verb).

        Transient connect-phase socket errors (ECONNREFUSED/EAGAIN/
        ENOENT while the supervisor is still binding its socket) retry
        with short exponential backoff instead of failing the first
        control call after start; anything else surfaces
        immediately."""
        payload = json.dumps(body) if body is not None else None
        headers = {"Content-Type": "application/json"} if payload else {}
        put = self._put_conn if self.keep_alive else (
            lambda conn: conn.close()
        )
        delay = self.retry_delay
        for attempt in range(self.retries + 1):
            try:
                status, data = keepalive_request(
                    self._take_conn,
                    put,
                    lambda: _UnixHTTPConnection(
                        self.socket_path, self.timeout
                    ),
                    method, path, body=payload, headers=headers,
                )
            except (OSError, http.client.HTTPException) as exc:
                transient = (
                    isinstance(exc, OSError)
                    and exc.errno in _TRANSIENT_ERRNOS
                )
                if transient and attempt < self.retries:
                    time.sleep(delay)
                    delay = min(delay * 2, 0.5)
                    continue
                raise ControlClientError(f"{method} {path}: {exc}") from None
            text = data.decode("utf-8", "replace")
            if status != 200:
                raise ControlClientError(
                    f"{method} {path}: HTTP {status}: {text.strip()}"
                )
            return text

    def reload(self) -> None:
        """POST /v3/reload (reference: client.go:45-52)."""
        self._request("POST", "/v3/reload")

    def set_maintenance(self, enable: bool) -> None:
        """POST /v3/maintenance/{enable,disable} (reference: client.go:56-68)."""
        verb = "enable" if enable else "disable"
        self._request("POST", f"/v3/maintenance/{verb}")

    def put_env(self, env: Dict[str, str]) -> None:
        """POST /v3/environ (reference: client.go:72-84)."""
        self._request("POST", "/v3/environ", env)

    def put_metric(self, metrics: Dict[str, Any]) -> None:
        """POST /v3/metric (reference: client.go:88-100)."""
        self._request("POST", "/v3/metric", metrics)

    def get_ping(self) -> bool:
        """GET /v3/ping (reference: client.go:104-115)."""
        self._request("GET", "/v3/ping")
        return True

    def get_maintenance_status(self) -> bool:
        """GET /v3/maintenance/status: whether the supervisor is in
        maintenance mode right now (an extension over the reference's
        write-only maintenance verbs — drain runbooks need to confirm
        the flip actually landed)."""
        data = json.loads(self._request("GET", "/v3/maintenance/status"))
        return bool(data.get("maintenance"))

    def get_events(self) -> list:
        """GET /v3/events: the supervisor's recent-event ring (an
        observability extension over the reference's control API)."""
        return json.loads(self._request("GET", "/v3/events"))

    def get_tasks(self) -> list:
        """GET /v3/tasks: the live actor/timer/exec task table."""
        return json.loads(self._request("GET", "/v3/tasks"))
