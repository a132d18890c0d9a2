"""The port's Consul-API catalog daemon
(``containerpilot_tpu_torch/discovery/catalog_server.py``) against the
reference's: the same request sequence, sent to both servers side by
side in one event loop, gets the same status, content type and body at
every step — registration, TTL heartbeats and expiry, tag/dc/passing
filters, deregistration, the reaper, ``/metrics``, malformed requests —
and the snapshot journal restores the same entries."""
import asyncio
import json

from containerpilot_tpu.discovery.catalog_server import (
    CatalogServer as RefCatalogServer,
)
from containerpilot_tpu_torch.discovery.catalog_server import CatalogServer


async def _request(port, method, path, body=b""):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    if not isinstance(body, bytes):
        body = json.dumps(body).encode()
    writer.write(
        f"{method} {path} HTTP/1.1\r\nHost: 127.0.0.1\r\n"
        f"Connection: close\r\nContent-Length: {len(body)}\r\n\r\n"
        .encode() + body)
    await writer.drain()
    raw = await reader.read()
    writer.close()
    await writer.wait_closed()
    head, _, data = raw.partition(b"\r\n\r\n")
    lines = head.decode().split("\r\n")
    headers = dict(line.split(": ", 1) for line in lines[1:])
    return int(lines[0].split()[1]), headers.get("Content-Type"), data


def _register(sid, name="web", ttl="", status="", tags=(), port=8080,
              dereg=""):
    body = {"ID": sid, "Name": name, "Address": "10.0.0.7", "Port": port,
            "Tags": list(tags)}
    check = {}
    if ttl:
        check["TTL"] = ttl
    if status:
        check["Status"] = status
    if dereg:
        check["DeregisterCriticalServiceAfter"] = dereg
    if check:
        body["Check"] = check
    return ("PUT", "/v1/agent/service/register", body)


SEQUENCE = [
    ("GET", "/v1/health/service/web", b""),
    _register("web-1", ttl="10s", status="passing"),
    _register("web-2", ttl="10s", tags=("v2", "canary")),
    _register("web-3", tags=("v2",), port="9090"),
    _register("db-1", name="db", ttl="150ms", status="passing"),
    _register("gone-1", name="gone", ttl="1ms", status="passing",
              dereg="1ms"),
    ("GET", "/v1/health/service/web", b""),
    ("GET", "/v1/health/service/web?passing=1", b""),
    ("GET", "/v1/health/service/web?tag=v2", b""),
    ("GET", "/v1/health/service/web?passing=1&tag=canary", b""),
    ("GET", "/v1/health/service/web?dc=dc1", b""),
    ("GET", "/v1/health/service/web?dc=dc2", b""),
    ("PUT", "/v1/agent/check/update/service:web-2", {"Status": "passing"}),
    ("PUT", "/v1/agent/check/update/service:web-3", {"Status": "warn"}),
    ("PUT", "/v1/agent/check/update/service:nope", {"Status": "passing"}),
    ("PUT", "/v1/agent/check/update/service:web-1", b"{bad json"),
    ("GET", "/v1/health/service/web?passing=1", b""),
    ("GET", "/v1/health/service/web?passing=0", b""),
    ("PUT", "/v1/agent/service/register", b"{bad json"),
    _register("bad-ttl", ttl="5 fortnights"),
    _register("bad-port", port="eighty"),
    ("PUT", "/v1/agent/service/register", {"Name": ""}),
    ("PUT", "/v1/agent/service/register",
     {"ID": "x", "Name": "x", "Check": {"TTL": "1s",
                                        "DeregisterCriticalServiceAfter":
                                        "soon"}}),
    ("GET", "/v1/agent/service/register", b""),
    ("GET", "/v1/nothing/here", b""),
    ("PUT", "/v1/agent/service/deregister/web-1", b""),
    ("PUT", "/v1/agent/service/deregister/never-was", b""),
    ("GET", "/v1/health/service/web", b""),
    ("GET", "/metrics", b""),
    ("SLEEP", 0.3),  # db-1's TTL lapses
    ("GET", "/v1/health/service/db", b""),
    ("GET", "/v1/health/service/db?passing=1", b""),
    ("PUT", "/v1/agent/check/update/service:db-1", {"Status": "pass"}),
    ("GET", "/v1/health/service/db?passing=1", b""),
    ("SLEEP", 2.3),  # the reaper sees gone-1 critical, then reaps it
    ("GET", "/v1/health/service/gone", b""),
    ("GET", "/metrics", b""),
]


def test_same_requests_get_the_same_answers(run, tmp_path):
    async def scenario():
        servers = [
            RefCatalogServer("127.0.0.1", 0,
                             snapshot_path=str(tmp_path / "ref.json")),
            CatalogServer("127.0.0.1", 0,
                          snapshot_path=str(tmp_path / "port.json")),
        ]
        for server in servers:
            await server.run()
        ports = [s._server.bound_port for s in servers]
        try:
            for step in SEQUENCE:
                if step[0] == "SLEEP":
                    await asyncio.sleep(step[1])
                    continue
                ref, port = await asyncio.gather(
                    *[_request(p, *step) for p in ports])
                assert port == ref, step
        finally:
            for server in servers:
                await server.stop()

        # the journal: the same entries restored by a fresh daemon
        restored = []
        for cls, name in ((RefCatalogServer, "ref"),
                          (CatalogServer, "port")):
            server = cls("127.0.0.1", 0,
                         snapshot_path=str(tmp_path / f"{name}.json"))
            await server.run()
            try:
                restored.append(await _request(
                    server._server.bound_port, "GET",
                    "/v1/health/service/web"))
            finally:
                await server.stop()
        assert restored[0] == restored[1]
        assert len(json.loads(restored[1][2])) == 2

    run(scenario(), timeout=60)
