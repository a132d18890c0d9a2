"""HTTP client for the supervisor's control plane on its unix socket:
the verb a supervised trainer needs, ``put_metric`` (the port's own copy of
``containerpilot_tpu/client/client.py``'s ``ControlClient``, which the
port may not import).

One unix-socket connection is kept across verbs (the control server
speaks HTTP/1.1 keep-alive); ``utils/httpclient.py`` owns the redial
discipline. Transient connect-phase errors (the socket not there yet,
nothing accepting) retry with a short exponential backoff, since
nothing was sent when they fire.
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
    ) -> None:
        self.socket_path = socket_path
        self.timeout = timeout
        self.retries = max(retries, 0)
        self.retry_delay = retry_delay
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
        """Drop the kept connection (the next verb redials)."""
        conn = self._take_conn()
        if conn is not None:
            conn.close()

    def _request(
        self, method: str, path: str, body: Optional[Dict[str, Any]] = None
    ) -> str:
        payload = json.dumps(body) if body is not None else None
        headers = {"Content-Type": "application/json"} if payload else {}
        delay = self.retry_delay
        for attempt in range(self.retries + 1):
            try:
                status, data = keepalive_request(
                    self._take_conn, self._put_conn,
                    lambda: _UnixHTTPConnection(self.socket_path, self.timeout),
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

    def put_metric(self, metrics: Dict[str, Any]) -> None:
        """POST /v3/metric."""
        self._request("POST", "/v3/metric", metrics)
