"""Keep-alive discipline for synchronous http.client callers (the port's
own copy of ``containerpilot_tpu/utils/httpclient.py``'s
``keepalive_request``, without the trace-id header: the port has no
tracing yet).

- take the kept connection, else dial a fresh one;
- a KEPT connection that fails before any response byte arrived (a
  reset while sending, or ``RemoteDisconnected`` from
  ``getresponse()``) gets one transparent redial-and-resend: the server
  closed an idle connection and never took the request;
- a failure after ``getresponse()`` returned is not resent;
- the connection is kept again only when the response wasn't
  ``Connection: close``.
"""
from __future__ import annotations

import http.client
from typing import Callable, Dict, Optional, Tuple


def keepalive_request(
    take_conn: Callable[[], Optional[http.client.HTTPConnection]],
    put_conn: Callable[[http.client.HTTPConnection], None],
    new_conn: Callable[[], http.client.HTTPConnection],
    method: str,
    path: str,
    body=None,
    headers: Optional[Dict[str, str]] = None,
) -> Tuple[int, bytes]:
    """One request over the kept connection; returns (status, body).
    Raises whatever the transport raised (OSError /
    http.client.HTTPException) once the one redial is exhausted."""
    send_headers = dict(headers or {})
    while True:
        conn = take_conn()
        reused = conn is not None
        if conn is None:
            conn = new_conn()
        try:
            conn.request(method, path, body=body, headers=send_headers)
        except (OSError, http.client.HTTPException) as exc:
            conn.close()
            if reused and isinstance(exc, ConnectionError):
                continue  # send bounced off the reaped kept conn
            raise
        try:
            resp = conn.getresponse()
            payload = resp.read()
        except (OSError, http.client.HTTPException) as exc:
            conn.close()
            if reused and isinstance(exc, http.client.RemoteDisconnected):
                continue  # closed without a single response byte
            raise
        if resp.will_close:
            conn.close()
        else:
            put_conn(conn)
        return resp.status, payload
