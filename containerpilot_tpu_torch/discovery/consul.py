"""Consul discovery backend over the raw HTTP API (the port's own copy of
``containerpilot_tpu/discovery/consul.py``, over the port's
``utils/httpclient.keepalive_request``, without the reference's
Prometheus gauge of watched instances).

Capability parity with the reference's Consul backend
(reference: discovery/consul.go, discovery/config.go) without the
vendored client library: the four agent/health endpoints the supervisor
needs, URI/map config with ``CONSUL_HTTP_ADDR`` / ``CONSUL_HTTP_SSL`` /
``CONSUL_HTTP_TOKEN`` environment overrides
(reference: discovery/config.go:29-61), per-watch caching of the
last-seen instance list with compare-for-change
(reference: discovery/consul.go:102-125).

Catalog calls ride PERSISTENT keep-alive connections, one per thread
(heartbeats run on the discovery FIFO thread, watch/gateway polls on a
small poll executor — each keeps its own warm connection to the
agent): TTL refreshes every ttl/2 seconds and membership polls every
interval no longer dial per call. A connection the agent closed while
idle is detected before any response byte and redialed transparently
once; agents that answer ``Connection: close`` (or any non-keep-alive
proxy in front of one) degrade gracefully to dial-per-call.
"""
from __future__ import annotations

import http.client
import json
import logging
import os
import threading
import urllib.parse
from typing import Any, Dict, List, Optional, Tuple

from ..utils.httpclient import keepalive_request
from .backend import (
    Backend,
    DiscoveryError,
    ServiceInstance,
    ServiceRegistration,
)

log = logging.getLogger("containerpilot.discovery")

class ConsulBackend(Backend):
    def __init__(
        self,
        address: str = "localhost:8500",
        scheme: str = "http",
        token: str = "",
        timeout: float = 10.0,
    ) -> None:
        self.address = address
        self.scheme = scheme
        self.token = token
        self.timeout = timeout
        self._last_seen: Dict[str, List[ServiceInstance]] = {}
        # one persistent agent connection PER THREAD:
        # http.client.HTTPConnection is not thread-safe, and catalog
        # traffic comes from a handful of long-lived threads (the
        # discovery FIFO drain, the poll executor) that each get to
        # keep their own warm connection
        self._local = threading.local()

    # -- construction ---------------------------------------------------

    @classmethod
    def from_uri(cls, uri: str) -> "ConsulBackend":
        scheme = "http"
        address = uri
        if "://" in uri:
            scheme, address = uri.split("://", 1)
        return cls._with_env_overrides(address=address, scheme=scheme)

    @classmethod
    def from_map(cls, raw: Dict[str, Any]) -> "ConsulBackend":
        return cls._with_env_overrides(
            address=str(raw.get("address", "localhost:8500")),
            scheme=str(raw.get("scheme", "http")),
            token=str(raw.get("token", "")),
        )

    @classmethod
    def _with_env_overrides(
        cls, address: str, scheme: str, token: str = ""
    ) -> "ConsulBackend":
        address = os.environ.get("CONSUL_HTTP_ADDR", address)
        if os.environ.get("CONSUL_HTTP_SSL", "").lower() in ("1", "true"):
            scheme = "https"
        token = os.environ.get("CONSUL_HTTP_TOKEN", token)
        if "://" in address:
            scheme, address = address.split("://", 1)
        return cls(address=address, scheme=scheme, token=token)

    # -- HTTP plumbing --------------------------------------------------

    def _take_conn(self) -> Optional[http.client.HTTPConnection]:
        conn = getattr(self._local, "conn", None)
        self._local.conn = None
        return conn

    def _put_conn(self, conn: http.client.HTTPConnection) -> None:
        self._local.conn = conn

    def _new_conn(self) -> http.client.HTTPConnection:
        cls = (
            http.client.HTTPSConnection
            if self.scheme == "https"
            else http.client.HTTPConnection
        )
        # http.client parses a "host:port" string itself
        return cls(self.address, timeout=self.timeout)

    def _request(
        self, method: str, path: str, body: Optional[Dict[str, Any]] = None
    ) -> Any:
        """One agent round trip over this thread's kept connection
        (utils/httpclient.py owns the redial discipline: a kept
        connection the agent reaped while idle fails before any
        response byte and is resent once on a fresh dial)."""
        data = json.dumps(body).encode() if body is not None else None
        headers = {"Content-Type": "application/json"}
        if self.token:
            headers["X-Consul-Token"] = self.token
        try:
            status, payload = keepalive_request(
                self._take_conn, self._put_conn, self._new_conn,
                method, path, body=data, headers=headers,
            )
        except (OSError, http.client.HTTPException) as exc:
            raise DiscoveryError(
                f"consul {method} {path}: {exc}"
            ) from None
        if status >= 400:
            raise DiscoveryError(
                f"consul {method} {path}: {status} {payload[:200]!r}"
            )
        if not payload:
            return None
        try:
            return json.loads(payload)
        except ValueError:
            return None

    # -- Backend interface ----------------------------------------------

    def service_register(
        self, registration: ServiceRegistration, status: str = ""
    ) -> None:
        body: Dict[str, Any] = {
            "ID": registration.id,
            "Name": registration.name,
            "Tags": registration.tags,
            "Port": registration.port,
            "Address": registration.address,
            "EnableTagOverride": registration.enable_tag_override,
            "Check": {
                "TTL": f"{registration.ttl}s",
                "Notes": f"TTL for {registration.name} set by containerpilot",
            },
        }
        if status:
            body["Check"]["Status"] = status
        if registration.deregister_critical_service_after:
            body["Check"]["DeregisterCriticalServiceAfter"] = (
                registration.deregister_critical_service_after
            )
        self._request("PUT", "/v1/agent/service/register", body)

    def service_deregister(self, service_id: str) -> None:
        self._request(
            "PUT",
            "/v1/agent/service/deregister/"
            + urllib.parse.quote(service_id, safe=":"),
        )

    def update_ttl(self, check_id: str, output: str, status: str) -> None:
        # ":" stays raw — it is legal in a path segment and check ids are
        # "service:<id>" (the reference's client sends them unescaped)
        self._request(
            "PUT",
            "/v1/agent/check/update/" + urllib.parse.quote(check_id, safe=":"),
            {"Output": output, "Status": "passing" if status == "pass" else status},
        )

    def _health_service(
        self, service_name: str, tag: str, dc: str
    ) -> List[ServiceInstance]:
        query: List[Tuple[str, str]] = [("passing", "1")]
        if tag:
            query.append(("tag", tag))
        if dc:
            query.append(("dc", dc))
        path = (
            "/v1/health/service/"
            + urllib.parse.quote(service_name, safe=":")
            + "?"
            + urllib.parse.urlencode(query)
        )
        entries = self._request("GET", path) or []
        out: List[ServiceInstance] = []
        for entry in entries:
            svc = entry.get("Service", {})
            node = entry.get("Node", {})
            out.append(
                ServiceInstance(
                    id=svc.get("ID", ""),
                    name=svc.get("Service", service_name),
                    address=svc.get("Address") or node.get("Address", ""),
                    port=int(svc.get("Port") or 0),
                )
            )
        out.sort(key=lambda i: (i.id, i.address, i.port))
        return out

    def check_for_upstream_changes(
        self, service_name: str, tag: str = "", dc: str = ""
    ) -> Tuple[bool, bool]:
        """Poll + compare-for-change (reference: discovery/consul.go:87-125)."""
        try:
            instances = self._health_service(service_name, tag, dc)
        except DiscoveryError as exc:
            log.warning("failed to query %s: %s", service_name, exc)
            return False, False
        last = self._last_seen.get(service_name)
        did_change = (last is not None and last != instances) or (
            last is None and bool(instances)
        )
        self._last_seen[service_name] = instances
        return did_change, bool(instances)

    def instances(self, service_name: str, tag: str = "") -> List[ServiceInstance]:
        try:
            return self._health_service(service_name, tag, "")
        except DiscoveryError:
            return []
