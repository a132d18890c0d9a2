"""cp-mux/1 in the port (utils/http.py's server half, fleet/pool.py's
client half) against the JAX package's copy: the frame codec is byte for
byte the reference's; the nine ``test_mux_*`` cases of
tests/test_http.py:435-707 run against the port's server, the stream
cases once with the port's ``MuxConnection`` and once with the
reference's; and the port's client talks to the reference server.

The reference client is adopted onto a socket this file upgrades itself
and keeps the writer of: the reference ``MuxConnection.adopt`` drops the
``StreamWriter``, and on CPython 3.12 ``StreamWriter.__del__`` closes
the transport once the writer is collected (the port's client keeps it;
ROADMAP.md queue 3)."""
import asyncio
import json
import socket

import pytest
import torch

from containerpilot_tpu.fleet import pool as ref_pool
from containerpilot_tpu.utils import http as ref_http
from containerpilot_tpu_torch.fleet.pool import (
    MuxConnection,
    UpstreamError,
    dial_mux,
)
from containerpilot_tpu_torch.utils import http as port_http
from containerpilot_tpu_torch.utils.http import (
    FRAME_END,
    FRAME_HEADERS,
    FRAME_PING,
    FRAME_PONG,
    MUX_PROTOCOL,
    MUX_UPGRADE_PATH,
    HTTPServer,
    Response,
    StreamingResponse,
    encode_frame,
    read_frame,
)

CLIENTS = ["port", "reference"]


async def _start_server(server_cls=HTTPServer, responses=port_http,
                        **attrs):
    server = server_cls()
    for key, value in attrs.items():
        setattr(server, key, value)

    async def ok(_req):
        return responses.Response(200, b"hello\n")

    async def echo(req):
        return responses.Response(200, req.body,
                                  content_type="application/json")

    server.route("GET", "/ok", ok)
    server.route("POST", "/echo", echo)
    await server.start_tcp("127.0.0.1", 0)
    return server


async def _mux_upgrade(port):
    """Raw-socket upgrade handshake -> (reader, writer, head)."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(
        f"GET {MUX_UPGRADE_PATH} HTTP/1.1\r\nHost: x\r\n"
        f"Connection: Upgrade\r\nUpgrade: {MUX_PROTOCOL}\r\n\r\n".encode()
    )
    await writer.drain()
    head = await reader.readuntil(b"\r\n\r\n")
    return reader, writer, head


def _head_frame(sid, method="GET", path="/ok"):
    return encode_frame(
        FRAME_HEADERS, sid,
        json.dumps({"method": method, "path": path, "headers": {}}).encode(),
    )


class _Client:
    """A mux connection by either package's client; close() tears it
    down (and drops the writer the reference client needs kept)."""

    def __init__(self, conn, writer=None):
        self.conn = conn
        self._writer = writer

    def close(self):
        self.conn.close()


async def _connect(port, client):
    if client == "port":
        conn = await dial_mux("127.0.0.1", port, 5.0)
        assert isinstance(conn, MuxConnection)
        return _Client(conn)
    reader, writer, head = await _mux_upgrade(port)
    assert head.startswith(b"HTTP/1.1 101 ")
    conn = ref_pool.MuxConnection("r1", f"127.0.0.1:{port}")
    conn.adopt(reader, writer)
    return _Client(conn, writer)


def _errors(client):
    return ((UpstreamError,) if client == "port"
            else (ref_pool.UpstreamError,))


def test_frame_codec_byte_equal_to_reference():
    for name in ("MUX_PROTOCOL", "MUX_UPGRADE_PATH", "FRAME_HEADERS",
                 "FRAME_DATA", "FRAME_END", "FRAME_CANCEL", "FRAME_PING",
                 "FRAME_PONG", "FRAME_WINDOW", "MUX_MAX_FRAME",
                 "MUX_INITIAL_WINDOW", "MUX_CHUNK", "MUX_MAX_STREAMS",
                 "MAX_BODY"):
        assert getattr(port_http, name) == getattr(ref_http, name), name
    assert port_http.FRAME_HEAD.format == ref_http.FRAME_HEAD.format == ">IBI"
    assert port_http.FRAME_TYPES == ref_http.FRAME_TYPES
    for ftype in sorted(ref_http.FRAME_TYPES):
        for sid, payload in ((0, b""), (1, b"x"), (7, b'{"a": 1}'),
                             ((1 << 32) - 1, bytes(range(256)) * 9)):
            assert (port_http.encode_frame(ftype, sid, payload)
                    == ref_http.encode_frame(ftype, sid, payload))
    assert (port_http._mux_refusal_head()
            == ref_http._mux_refusal_head())
    resp = (Response(422, b"bad\n", headers={"X-CP-Trace": "ab"}),
            ref_http.Response(422, b"bad\n", headers={"X-CP-Trace": "ab"}))
    assert (port_http._mux_response_head(resp[0])
            == ref_http._mux_response_head(resp[1]))


def test_mux_upgrade_negotiation_and_ping(run):
    """The upgrade earns a 101 and the connection speaks frames: PING
    round-trips as PONG with the payload echoed."""

    async def scenario():
        server = await _start_server()
        reader, writer, head = await _mux_upgrade(server.bound_port)
        writer.write(encode_frame(FRAME_PING, 0, b"nonce-1"))
        await writer.drain()
        pong = await read_frame(reader)
        counters = (server.mux_connections, server.connections_accepted)
        writer.close()
        await server.stop()
        return head, pong, counters

    head, pong, (mux_conns, conns) = run(scenario(), timeout=30)
    assert head.startswith(b"HTTP/1.1 101 ")
    assert b"Upgrade: cp-mux/1" in head
    assert pong == (FRAME_PONG, 0, b"nonce-1")
    assert mux_conns == 1 and conns == 1


@pytest.mark.parametrize("client", CLIENTS)
def test_mux_streams_interleave_on_one_connection(run, client):
    """A fast stream opened after a slow one completes first, on one
    socket."""

    async def scenario():
        server = await _start_server()
        gate = asyncio.Event()

        async def slow(_req):
            await gate.wait()
            return Response(200, b"slow\n")

        server.route("GET", "/slow", slow)
        c = await _connect(server.bound_port, client)
        s_slow = await c.conn.open_stream("GET", "/slow")
        s_fast = await c.conn.open_stream("GET", "/ok")
        fast_status, _ = await s_fast.response_head(5.0)
        fast_body = await s_fast.read_body(5.0, 1 << 20)
        slow_still_inflight = not s_slow.ended
        gate.set()
        slow_status, _ = await s_slow.response_head(5.0)
        slow_body = await s_slow.read_body(5.0, 1 << 20)
        echo = await c.conn.open_stream("POST", "/echo", body=b'{"x": 1}')
        echo_head = await echo.response_head(5.0)
        echo_body = await echo.read_body(5.0, 1 << 20)
        counters = (server.connections_accepted, server.mux_streams_served)
        c.close()
        await server.stop()
        return (fast_status, fast_body, slow_still_inflight, slow_status,
                slow_body, echo_head, echo_body, counters)

    (fast_status, fast_body, inflight, slow_status, slow_body, echo_head,
     echo_body, c) = run(scenario(), timeout=30)
    assert fast_status == 200 and fast_body == b"hello\n"
    assert inflight
    assert slow_status == 200 and slow_body == b"slow\n"
    assert echo_head[0] == 200 and echo_body == b'{"x": 1}'
    assert echo_head[1]["content-type"] == "application/json"
    assert c == (1, 3)


@pytest.mark.parametrize("client", CLIENTS)
def test_mux_per_stream_backpressure(run, client):
    """A stream whose consumer stops granting WINDOW credit stalls alone
    at its window; the co-resident stream completes, and draining the
    stalled one releases the rest."""

    async def scenario():
        server = await _start_server()
        big = b"x" * (200 * 1024)  # > MUX_INITIAL_WINDOW

        async def bulk(_req):
            async def gen():
                yield big

            return StreamingResponse(gen(), content_type="text/plain")

        server.route("GET", "/bulk", bulk)
        c = await _connect(server.bound_port, client)
        s_bulk = await c.conn.open_stream("GET", "/bulk")
        await s_bulk.response_head(5.0)
        first = await s_bulk.read_chunk(5.0)
        s_ok = await c.conn.open_stream("GET", "/ok")
        ok_status, _ = await s_ok.response_head(5.0)
        ok_body = await s_ok.read_body(5.0, 1 << 20)
        rest = first
        while True:
            chunk = await s_bulk.read_chunk(5.0)
            if not chunk:
                break
            rest += chunk
        c.close()
        await server.stop()
        return ok_status, ok_body, rest

    ok_status, ok_body, rest = run(scenario(), timeout=30)
    assert ok_status == 200 and ok_body == b"hello\n"
    assert rest == b"x" * (200 * 1024)


@pytest.mark.parametrize("client", CLIENTS)
def test_mux_cancel_mid_stream_runs_handler_cleanup(run, client):
    """CANCEL mid-DATA: the streaming handler's close callback and its
    generator's finally both run, and the connection keeps serving."""

    async def scenario():
        server = await _start_server()
        cleaned = {"finally": False, "close": False}

        async def endless(_req):
            async def gen():
                try:
                    while True:
                        yield b"tick\n"
                        await asyncio.sleep(0.01)
                finally:
                    cleaned["finally"] = True

            return StreamingResponse(
                gen(), close=lambda: cleaned.__setitem__("close", True)
            )

        server.route("GET", "/endless", endless)
        c = await _connect(server.bound_port, client)
        stream = await c.conn.open_stream("GET", "/endless")
        await stream.response_head(5.0)
        assert await stream.read_chunk(5.0)
        assert stream.cancel()
        for _ in range(100):
            if cleaned["finally"] and cleaned["close"]:
                break
            await asyncio.sleep(0.02)
        s_ok = await c.conn.open_stream("GET", "/ok")
        ok_status, _ = await s_ok.response_head(5.0)
        await s_ok.read_body(5.0, 1 << 20)
        alive = await c.conn.ping()
        conns = server.connections_accepted
        c.close()
        await server.stop()
        return dict(cleaned), ok_status, alive, conns

    cleaned, ok_status, alive, conns = run(scenario(), timeout=30)
    assert cleaned == {"finally": True, "close": True}
    assert ok_status == 200 and alive
    assert conns == 1


def test_mux_protocol_error_closes_the_connection(run):
    """An unknown frame type kills the whole connection; the client
    reads to EOF instead of hanging."""

    async def scenario():
        server = await _start_server()
        reader, writer, _ = await _mux_upgrade(server.bound_port)
        writer.write(_head_frame(1) + encode_frame(FRAME_END, 1))
        resp_head = await read_frame(reader)
        writer.write(b"\x00\x00\x00\x04\xff\x00\x00\x00\x01zzzz")
        await writer.drain()
        leftover = await reader.read()
        writer.close()
        await server.stop()
        return resp_head[0], leftover

    ftype, leftover = run(scenario(), timeout=30)
    assert ftype == FRAME_HEADERS
    assert leftover is not None


@pytest.mark.parametrize("client", CLIENTS)
def test_mux_abort_rsts_all_streams(run, client):
    """abort() fails every in-flight stream promptly and exactly once."""

    async def scenario():
        server = await _start_server()
        gate = asyncio.Event()

        async def stuck(_req):
            await gate.wait()
            return Response(200, b"never\n")

        server.route("GET", "/stuck", stuck)
        c = await _connect(server.bound_port, client)
        s1 = await c.conn.open_stream("GET", "/stuck")
        s2 = await c.conn.open_stream("GET", "/stuck")
        await asyncio.sleep(0.05)
        await server.abort()
        errors = []
        for stream in (s1, s2):
            try:
                await stream.response_head(5.0)
            except _errors(client) as exc:
                errors.append(exc)
        dead = c.conn.dead
        c.close()
        return len(errors), dead

    n_errors, dead = run(scenario(), timeout=30)
    assert n_errors == 2 and dead


def test_mux_negotiation_fallback_to_http11(run):
    """A server with mux disabled answers the upgrade through the route
    table (404, keep-alive): the port's dial reports no mux, and the same
    socket still serves plain HTTP/1.1."""

    async def scenario():
        server = await _start_server(mux_enabled=False)
        conn = await dial_mux("127.0.0.1", server.bound_port, 5.0)
        reader, writer, head = await _mux_upgrade(server.bound_port)
        writer.write(b"GET /ok HTTP/1.1\r\nHost: x\r\nConnection: close"
                     b"\r\n\r\n")
        await writer.drain()
        after = await reader.read()
        writer.close()
        counters = (server.mux_connections, server.connections_accepted)
        await server.stop()
        return conn, head, after, counters

    conn, head, after, (mux_conns, conns) = run(scenario(), timeout=30)
    assert conn is None
    assert head.startswith(b"HTTP/1.1 404 ") and b"keep-alive" in head
    # the declined upgrade's 404 body, then the next request's answer
    assert after.startswith(b"not found\nHTTP/1.1 200 OK")
    assert after.endswith(b"hello\n")
    assert mux_conns == 0 and conns == 2


def test_plain_http_clients_unchanged_on_mux_server(run):
    """A client that never sends the upgrade gets plain HTTP/1.1 from a
    mux-enabled server."""

    async def scenario():
        server = await _start_server()
        loop = asyncio.get_running_loop()

        def client():
            sock = socket.create_connection(
                ("127.0.0.1", server.bound_port), timeout=5
            )
            sock.sendall(b"GET /ok HTTP/1.1\r\nHost: x\r\n\r\n")
            first = b""
            while b"hello\n" not in first:
                first += sock.recv(65536)
            sock.close()
            return first

        data = await loop.run_in_executor(None, client)
        counters = (server.mux_connections, server.mux_streams_served)
        await server.stop()
        return data, counters

    data, (mux_conns, mux_streams) = run(scenario(), timeout=30)
    assert data.startswith(b"HTTP/1.1 200 OK\r\n")
    assert b"Connection: keep-alive" in data
    assert b"cp-mux" not in data
    assert mux_conns == 0 and mux_streams == 0


@pytest.mark.parametrize("client", CLIENTS)
def test_mux_stream_cap_refuses_excess_stream_with_503(run, client):
    """The stream cap refuses the excess stream with a per-stream 503;
    the connection and its live stream are untouched."""

    async def scenario():
        server = await _start_server(MUX_MAX_STREAMS=1)
        gate = asyncio.Event()

        async def stuck(_req):
            await gate.wait()
            return Response(200, b"first\n")

        server.route("GET", "/stuck", stuck)
        c = await _connect(server.bound_port, client)
        s1 = await c.conn.open_stream("GET", "/stuck")
        s2 = await c.conn.open_stream("GET", "/ok")
        refused_status, refused_headers = await s2.response_head(5.0)
        await s2.read_body(5.0, 1 << 20)
        gate.set()
        ok_status, _ = await s1.response_head(5.0)
        body = await s1.read_body(5.0, 1 << 20)
        c.close()
        await server.stop()
        return refused_status, refused_headers, ok_status, body

    refused, headers, ok_status, body = run(scenario(), timeout=30)
    assert refused == 503 and headers.get("retry-after")
    assert ok_status == 200 and body == b"first\n"


def test_port_client_against_reference_server(run):
    """The port's MuxConnection against the reference HTTPServer:
    streams interleave on one socket, a traced head carries the id, PING
    answers, and a server with mux off declines the upgrade."""

    async def scenario():
        server = await _start_server(ref_http.HTTPServer, ref_http)
        gate = asyncio.Event()
        seen = {}

        async def slow(req):
            seen["trace"] = req.headers.get("x-cp-trace")
            await gate.wait()
            return ref_http.Response(200, b"slow\n")

        server.route("GET", "/slow", slow)
        conn = await dial_mux("127.0.0.1", server.bound_port, 5.0)
        s_slow = await conn.open_stream("GET", "/slow",
                                        trace_id="abc123def4567890")
        s_fast = await conn.open_stream("GET", "/ok")
        fast = (await s_fast.response_head(5.0))[0], await s_fast.read_body(
            5.0, 1 << 20)
        gate.set()
        slow = (await s_slow.response_head(5.0))[0], await s_slow.read_body(
            5.0, 1 << 20)
        alive = await conn.ping()
        counters = (server.connections_accepted, server.mux_streams_served)
        conn.close()
        await server.stop()
        off = await _start_server(ref_http.HTTPServer, ref_http,
                                  mux_enabled=False)
        declined = await dial_mux("127.0.0.1", off.bound_port, 5.0)
        await off.stop()
        return fast, slow, alive, counters, seen, declined

    fast, slow, alive, counters, seen, declined = run(scenario(), timeout=30)
    assert fast == (200, b"hello\n") and slow == (200, b"slow\n")
    assert alive and counters == (1, 2)
    assert seen["trace"] == "abc123def4567890"
    assert declined is None


def test_replica_serves_completions_over_one_mux_connection(run):
    """The port's InferenceServer (--text --slots) over one cp-mux/1
    connection: concurrent buffered and streamed /v1/completions equal
    the same requests over HTTP/1.1, each stream's trace id reaches the
    replica through the spliced head template and comes back in the
    digest header or the final SSE event, and /v1/traces files it; with
    mux=False the replica declines the upgrade."""
    from containerpilot_tpu_torch.models import transformer as ttf
    from containerpilot_tpu_torch.workload.serve import InferenceServer

    cfg = ttf.TransformerConfig(vocab_size=512, d_model=32, n_heads=2,
                                n_layers=1, d_ff=64, max_seq_len=64,
                                dtype=torch.float32)
    params = ttf.init_params(0, cfg, device="cpu")
    bodies = [{"prompt": "hello", "max_new_tokens": 9, "eos_id": -1},
              {"prompt": "abc", "max_new_tokens": 12},
              {"prompt": "xyz", "max_new_tokens": 10, "eos_id": -1,
               "stream": True}]

    async def http11(port, body):
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        payload = json.dumps(body).encode()
        writer.write(f"POST /v1/completions HTTP/1.1\r\nHost: x\r\n"
                     f"Connection: close\r\nContent-Length: {len(payload)}"
                     f"\r\n\r\n".encode() + payload)
        await writer.drain()
        raw = await reader.read()
        writer.close()
        return raw.partition(b"\r\n\r\n")[2]

    async def scenario():
        server = InferenceServer(cfg, params, "127.0.0.1", 0, 64, text=True,
                                 slots=2, slot_chunk=4, device="cpu")
        await server.run()
        off = InferenceServer(cfg, params, "127.0.0.1", 0, 64, device="cpu",
                              mux=False)
        await off.run()
        try:
            conn = await dial_mux("127.0.0.1", server.port, 5.0)

            async def one(i, body):
                stream = await conn.open_stream(
                    "POST", "/v1/completions", json.dumps(body).encode(),
                    trace_id=f"mux-{i}")
                status, headers = await stream.response_head(60.0)
                return status, headers, await stream.read_body(60.0, 1 << 20)

            over_mux = await asyncio.gather(*[one(i, b)
                                              for i, b in enumerate(bodies)])
            plain = [await http11(server.port, b) for b in bodies]
            traces = await http11_get(server.port, "/v1/traces")
            declined = await dial_mux("127.0.0.1", off.port, 5.0)
            conn.close()
            return over_mux, plain, json.loads(traces), declined
        finally:
            await server.stop()
            await off.stop()

    async def http11_get(port, path):
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        writer.write(f"GET {path} HTTP/1.1\r\nHost: x\r\nConnection: close"
                     f"\r\n\r\n".encode())
        await writer.drain()
        raw = await reader.read()
        writer.close()
        return raw.partition(b"\r\n\r\n")[2]

    over_mux, plain, traces, declined = run(scenario(), timeout=120)
    assert declined is None
    ids = {t["trace_id"]: t for t in traces["recent"]}
    for i, ((status, headers, data), want) in enumerate(zip(over_mux,
                                                            plain)):
        assert status == 200
        if bodies[i].get("stream"):
            assert headers["content-type"] == "text/event-stream"
            events = [json.loads(line[len(b"data: "):])
                      for line in data.split(b"\n")
                      if line.startswith(b"data: ")]
            plain_events = [json.loads(line[len(b"data: "):])
                            for line in want.split(b"\n")
                            if line.startswith(b"data: ")]
            assert events[-1]["trace"] == f"mux-{i}"
            assert "decode~" in events[-1]["spans"]
            strip = [{k: v for k, v in e.items() if k not in ("trace",
                                                               "spans")}
                     for e in events]
            assert strip == [{k: v for k, v in e.items()
                              if k not in ("trace", "spans")}
                             for e in plain_events]
        else:
            assert json.loads(data) == json.loads(want)
            assert headers["x-cp-trace"] == f"mux-{i}"
            assert "prefill~" in headers["x-cp-span-digest"]
        stages = [s["stage"] for s in ids[f"mux-{i}"]["spans"]]
        assert stages[:3] == ["slot_queue_wait", "prefill", "decode"]
        assert ids[f"mux-{i}"]["stream_id"] >= 1
