"""Minimal asyncio HTTP/1.1 server with keep-alive and cp-mux/1: the
port's own copy of ``containerpilot_tpu/utils/http.py``, so a torch
replica speaks the same transport, byte for byte, as a JAX replica (the
fleet gateway's multiplexed path and its HTTP/1.1 fallback).

Connection contract:

- **Buffered responses are Content-Length-framed and the connection
  stays open** (HTTP/1.1 keep-alive): sequential requests on one
  connection skip the dial + teardown tax, which is what the fleet
  gateway's replica pool, the ControlClient, and the catalog
  heartbeat/poll clients rely on. A client sends ``Connection:
  close`` (or speaks HTTP/1.0 without ``keep-alive``) to get the old
  one-shot behavior. Idle connections are reaped after
  ``KEEPALIVE_IDLE_TIMEOUT`` and capped at ``KEEPALIVE_MAX_REQUESTS``
  requests; protocol-level errors (400/408) always close, since the
  connection's framing can no longer be trusted.
- **StreamingResponse keeps its close-delimited contract**: sent with
  ``Connection: close`` and no Content-Length, the closing connection
  ends the stream.
- No chunked encoding; bodies need Content-Length.
- **cp-mux/1 multiplexing is negotiated, never assumed**: a client
  that sends ``Connection: Upgrade`` + ``Upgrade: cp-mux/1`` on a
  request switches the connection to the framed, multiplexed protocol
  below (many concurrent requests — streams included — interleaved on
  one socket). A client that never sends the upgrade gets the exact
  HTTP/1.1 byte stream it always got, and a server with
  ``mux_enabled=False`` answers the upgrade request through the
  normal route table (404), leaving the connection usable as plain
  keep-alive — which is precisely the client's fallback signal.

cp-mux/1 wire format (one frame)::

    u32 payload_length | u8 type | u32 stream_id | payload

Types: HEADERS (1, JSON request/response head), DATA (2, body
bytes), END (3, closes that direction of the stream), CANCEL (4,
abort the stream, either side), PING (5) / PONG (6, liveness, stream
id echoed), WINDOW (7, u32 flow-control credit). Response DATA is
window-gated per stream (``MUX_INITIAL_WINDOW`` bytes of credit,
refilled by WINDOW frames as the consumer drains), so one slow SSE
consumer stalls only its own stream while co-resident streams keep
interleaving. Request bodies are small and bounded by ``MAX_BODY``
instead of windowed. Framing violations (unknown type, oversized
frame, HEADERS for a live stream id, malformed HEADERS JSON) close
the whole connection: its framing can no longer be trusted, exactly
like a 400 on the HTTP/1.1 path.
"""
from __future__ import annotations

import asyncio
import json
import logging
import struct
from typing import Awaitable, Callable, Dict, List, Optional, Set, Tuple
from urllib.parse import parse_qs, urlsplit

log = logging.getLogger("containerpilot.http")

MAX_BODY = 4 * 1024 * 1024

_tracing = None


def _get_tracing():
    """Lazy tracing accessor: utils.http is imported by nearly every
    package, so the telemetry dependency stays off the module import
    path and is resolved once, on the first mux stream served."""
    global _tracing
    if _tracing is None:
        from ..telemetry import tracing as _tracing_mod

        _tracing = _tracing_mod
    return _tracing

# -- cp-mux/1 framed multiplexing ------------------------------------

MUX_PROTOCOL = "cp-mux/1"
#: path the client's upgrade request targets; unroutable on purpose,
#: so a mux-less server answers it 404 (the fallback signal) without
#: ever colliding with a real route
MUX_UPGRADE_PATH = "/_mux"

FRAME_HEADERS = 1
FRAME_DATA = 2
FRAME_END = 3
FRAME_CANCEL = 4
FRAME_PING = 5
FRAME_PONG = 6
FRAME_WINDOW = 7
FRAME_TYPES = frozenset((
    FRAME_HEADERS, FRAME_DATA, FRAME_END, FRAME_CANCEL,
    FRAME_PING, FRAME_PONG, FRAME_WINDOW,
))

FRAME_HEAD = struct.Struct(">IBI")  # payload length, type, stream id
MUX_MAX_FRAME = 1 << 20
#: per-stream response-DATA credit a receiver starts with
MUX_INITIAL_WINDOW = 64 * 1024
#: largest single DATA frame a sender emits (interleaving granularity)
MUX_CHUNK = 32 * 1024
#: concurrent streams one connection may carry; the 513th is refused
#: with a per-stream 503, never a connection error
MUX_MAX_STREAMS = 512


class MuxProtocolError(Exception):
    """The peer violated cp-mux/1 framing; the connection is dead."""


def encode_frame(ftype: int, stream_id: int, payload: bytes = b"") -> bytes:
    return FRAME_HEAD.pack(len(payload), ftype, stream_id) + payload


async def read_frame(reader: asyncio.StreamReader) -> Tuple[int, int, bytes]:
    """One frame off the wire; raises MuxProtocolError on framing
    violations and IncompleteReadError on EOF."""
    length, ftype, stream_id = FRAME_HEAD.unpack(
        await reader.readexactly(FRAME_HEAD.size)
    )
    if ftype not in FRAME_TYPES:
        raise MuxProtocolError(f"unknown frame type {ftype}")
    if length > MUX_MAX_FRAME:
        raise MuxProtocolError(f"{length}-byte frame exceeds cap")
    payload = await reader.readexactly(length) if length else b""
    return ftype, stream_id, payload


async def timed_read(reader: asyncio.StreamReader, coro, timeout: float):
    """Await one read (or a multi-read coroutine) on ``reader`` under
    a deadline WITHOUT ``asyncio.wait_for``: wait_for creates a Task
    plus a timer per call (~100us on a busy host), which at one-per-
    header-line dominates a proxied request's hot path. A plain timer
    handle costs ~1us; on expiry it poisons the reader with
    ``asyncio.TimeoutError``, which the pending await raises.

    A reader poisoned by a TRUE timeout stays failed — correct here,
    because every caller abandons the connection after a read
    timeout. But the timer can also fire in the same event-loop tick
    in which the read completed (data callback and due timer both run
    before the awaiting task resumes and cancels the handle); in that
    race the read returns normally while the poison would fail the
    connection's NEXT read — so after a successful await, this call's
    own sentinel exception is cleared."""
    exc = asyncio.TimeoutError()
    handle = asyncio.get_event_loop().call_later(
        timeout, reader.set_exception, exc
    )
    try:
        result = await coro
    finally:
        handle.cancel()
        if reader.exception() is exc:
            # the timer fired after the read already completed: the
            # connection is healthy, un-poison it (on the raise path
            # this is dead state either way — the conn is abandoned)
            reader._exception = None  # noqa: SLF001
    return result


class Request:
    def __init__(
        self,
        method: str,
        path: str,
        query: Dict[str, list],
        headers: Dict[str, str],
        body: bytes,
        version: str = "HTTP/1.1",
    ) -> None:
        self.method = method
        self.path = path
        self.query = query
        self.headers = headers
        self.body = body
        self.version = version

    def wants_keepalive(self) -> bool:
        """The client side of the connection-reuse handshake:
        HTTP/1.1 defaults to keep-alive unless the request says
        ``Connection: close``; HTTP/1.0 defaults to close unless it
        says ``Connection: keep-alive``."""
        connection = self.headers.get("connection", "").lower()
        if "close" in connection:
            return False
        if self.version.upper().startswith("HTTP/1.0"):
            return "keep-alive" in connection
        return True


class Response:
    def __init__(
        self,
        status: int = 200,
        body: bytes = b"",
        content_type: str = "text/plain; charset=utf-8",
        headers: Optional[Dict[str, str]] = None,
    ) -> None:
        self.status = status
        self.body = body
        self.content_type = content_type
        self.headers = headers or {}


class StreamingResponse:
    """A response whose body arrives incrementally from an async
    iterator of byte chunks (SSE events, chunk-boundary token
    deltas). Sent with ``Connection: close`` and no Content-Length:
    the closing connection delimits the stream, which every HTTP/1.1
    client understands. A stream therefore always ENDS its connection
    — streaming responses opt out of the server's keep-alive.

    Client disconnects are detected promptly (the reader hits EOF)
    and the iterator is ``aclose()``d, so a handler generator's
    ``finally`` can release what the request holds (e.g. free a slot
    mid-generation)."""

    def __init__(
        self,
        chunks,  # AsyncIterator[bytes]
        status: int = 200,
        content_type: str = "text/event-stream",
        headers: Optional[Dict[str, str]] = None,
        close: Optional[Callable[[], None]] = None,
    ) -> None:
        self.status = status
        self.chunks = chunks
        self.content_type = content_type
        self.headers = headers or {}
        # aclose() on a NEVER-STARTED async generator skips its body
        # entirely (an immediate disconnect aborts before the first
        # __anext__), so generator-finally cleanup alone is not
        # enough: ``close`` is invoked unconditionally when the
        # stream ends, however it ends. Make it idempotent — the
        # generator's own finally may run too.
        self.close = close


class _MuxServerStream:
    """Server-side state for one cp-mux stream: the decoded HEADERS,
    the accumulating request body, the handler task once END arrives,
    and the response-DATA flow-control window."""

    __slots__ = (
        "sid", "head", "body", "body_len", "task", "window", "credit",
    )

    def __init__(self, sid: int, head: Dict) -> None:
        self.sid = sid
        self.head = head
        self.body: List[bytes] = []
        self.body_len = 0
        self.task: Optional["asyncio.Task[None]"] = None
        self.window = MUX_INITIAL_WINDOW
        self.credit = asyncio.Event()

    def to_request(self):
        """Build the Request this stream carries, or a Response for
        content-level errors (bad head shape earns a per-stream 400,
        not a connection teardown — the framing itself was fine)."""
        method = self.head.get("method")
        path = self.head.get("path")
        if not isinstance(method, str) or not isinstance(path, str):
            return Response(400, b"malformed mux request head\n")
        raw_headers = self.head.get("headers")
        headers: Dict[str, str] = {}
        if isinstance(raw_headers, dict):
            headers = {
                str(k).lower(): str(v) for k, v in raw_headers.items()
            }
        parts = urlsplit(path)
        return Request(
            method.upper(), parts.path, parse_qs(parts.query), headers,
            b"".join(self.body),
        )


def _mux_response_head(response) -> bytes:
    """The JSON HEADERS payload for a Response/StreamingResponse."""
    headers = {"content-type": response.content_type}
    for key, value in response.headers.items():
        headers[key.lower()] = value
    return json.dumps(
        {"status": response.status, "headers": headers}
    ).encode()


def _mux_refusal_head() -> bytes:
    return json.dumps(
        {
            "status": 503,
            "headers": {
                "content-type": "text/plain; charset=utf-8",
                "retry-after": "1",
            },
        }
    ).encode()


_REASONS = {
    200: "OK",
    400: "Bad Request",
    404: "Not Found",
    405: "Method Not Allowed",
    408: "Request Timeout",
    422: "Unprocessable Entity",
    429: "Too Many Requests",
    500: "Internal Server Error",
    503: "Service Unavailable",
    504: "Gateway Timeout",
}

Handler = Callable[[Request], Awaitable[Response]]


class HTTPServer:
    """Route-table HTTP server over asyncio streams; bind via
    ``start_tcp``."""

    def __init__(self) -> None:
        self.routes: Dict[Tuple[str, str], Handler] = {}
        self._server: Optional[asyncio.AbstractServer] = None
        # live connection writers, so stop() can force-close lingering
        # keep-alive connections instead of leaving their handler
        # coroutines parked on a readline forever
        self._conns: Set[asyncio.StreamWriter] = set()
        # observability (and the keep-alive test suite's ground truth):
        # how many connections were accepted vs requests served — a
        # reuse ratio of requests/connections >> 1 means pooling works
        self.connections_accepted = 0
        self.requests_served = 0
        # cp-mux/1: whether this server accepts the upgrade, and how
        # many connections/streams took it (mux requests also count
        # into requests_served — they ARE requests)
        self.mux_enabled = True
        self.mux_connections = 0
        self.mux_streams_served = 0

    def route(self, method: str, path: str, handler: Handler) -> None:
        self.routes[(method.upper(), path)] = handler

    async def start_tcp(self, host: str, port: int) -> None:
        self._server = await asyncio.start_server(self._handle, host, port)

    @property
    def bound_port(self) -> Optional[int]:
        """The actual TCP port after binding (useful with port 0)."""
        if self._server is None or not self._server.sockets:
            return None
        return self._server.sockets[0].getsockname()[1]

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            # force-close lingering keep-alive connections BEFORE
            # awaiting wait_closed(): on Python >= 3.12.1 wait_closed
            # blocks until every connection handler finishes, and an
            # idle handler is parked on its next-request read for up
            # to KEEPALIVE_IDLE_TIMEOUT
            for conn_writer in list(self._conns):
                conn_writer.close()
            await self._server.wait_closed()
            self._server = None
        else:
            for conn_writer in list(self._conns):
                conn_writer.close()
        # yield once so the force-closed handlers observe EOF and exit
        await asyncio.sleep(0)

    async def abort(self) -> None:
        """Die like SIGKILL (chaos/testing): drop the listener and RST
        every live connection with nothing flushed. ``stop()`` closes
        connections politely (FIN after buffered bytes), which lets a
        handler racing shutdown still deliver a well-formed error
        response — a process that was KILLED can't do that, and fault
        injection must not be gentler than the fault it models."""
        if self._server is not None:
            self._server.close()
        for conn_writer in list(self._conns):
            transport = conn_writer.transport
            if transport is not None:
                transport.abort()
        if self._server is not None:
            await self._server.wait_closed()
            self._server = None
        await asyncio.sleep(0)

    # bound on reading one request (headers+body): a stalled client
    # can't pin a connection open indefinitely. Handler execution is
    # deliberately unbounded (inference warmup can be slow).
    REQUEST_READ_TIMEOUT = 30.0
    # how long a keep-alive connection may sit idle between requests
    # before the server reaps it, and how many requests one connection
    # may carry before being retired (bounds fd/state lifetime under
    # misbehaving clients)
    KEEPALIVE_IDLE_TIMEOUT = 75.0
    KEEPALIVE_MAX_REQUESTS = 1000
    # concurrent cp-mux streams one connection may carry; an excess
    # stream is refused with a per-stream 503, never a conn error
    MUX_MAX_STREAMS = MUX_MAX_STREAMS

    async def _handle(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        self.connections_accepted += 1
        self._conns.add(writer)
        try:
            await self._serve_connection(reader, writer)
        finally:
            self._conns.discard(writer)
            try:
                writer.close()
                await writer.wait_closed()
            except Exception:
                pass

    async def _serve_connection(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        """The keep-alive loop: requests are served off one connection
        until the client closes, asks to close, idles out, hits the
        per-connection request cap, or trips a protocol error."""
        served = 0
        while True:
            # the FIRST request on a fresh connection is bounded by the
            # read timeout (a stalled half-request earns a 408, see the
            # slow-loris path below); BETWEEN requests the bound is the
            # idle timeout and expiry is a quiet reap, not an error —
            # an idle pooled client did nothing wrong
            try:
                request_line = await timed_read(
                    reader,
                    reader.readline(),
                    self.REQUEST_READ_TIMEOUT
                    if served == 0
                    else self.KEEPALIVE_IDLE_TIMEOUT,
                )
            except asyncio.TimeoutError:
                if served == 0:
                    await self._write_response(
                        writer, Response(408, b"request timeout\n"),
                        close=True,
                    )
                return
            except (ConnectionError, asyncio.IncompleteReadError):
                return
            except Exception:
                # e.g. ValueError from a request line overrunning the
                # StreamReader limit: a client error must still get an
                # answer, never an unhandled task exception
                log.exception("request line read failed")
                await self._write_response(
                    writer,
                    Response(400, b"malformed request line\n"),
                    close=True,
                )
                return
            if not request_line:
                return  # client closed the connection cleanly
            # the narrow client-error excepts cover only the READ
            # phase; a handler raising TimeoutError must surface as a
            # logged 500, not be misblamed on the client as a 408
            try:
                request = await timed_read(
                    reader,
                    self._read_request(reader, request_line),
                    self.REQUEST_READ_TIMEOUT,
                )
            except asyncio.TimeoutError:
                request = Response(408, b"request timeout\n")
            except asyncio.IncompleteReadError:
                request = Response(400, b"truncated request\n")
            except ConnectionError:
                return
            except Exception:
                log.exception("request read failed")
                request = Response(500, b"internal server error\n")
            if isinstance(request, Response):
                # protocol-level failure: request framing can no
                # longer be trusted, so answer and close
                await self._write_response(writer, request, close=True)
                return
            served += 1
            self.requests_served += 1
            if (
                self.mux_enabled
                and request.headers.get("upgrade", "").lower()
                == MUX_PROTOCOL
                and "upgrade"
                in request.headers.get("connection", "").lower()
            ):
                # negotiated switch to framed multiplexing: everything
                # after the 101 is cp-mux/1 frames, both directions.
                # With mux_enabled=False the request instead falls
                # through to the route table (MUX_UPGRADE_PATH is
                # unroutable -> 404 keep-alive), which is the
                # client's signal to stay on plain HTTP/1.1.
                try:
                    writer.write(
                        b"HTTP/1.1 101 Switching Protocols\r\n"
                        b"Upgrade: " + MUX_PROTOCOL.encode() + b"\r\n"
                        b"Connection: Upgrade\r\n\r\n"
                    )
                    await writer.drain()
                except (ConnectionError, BrokenPipeError, OSError):
                    return  # client reset before/under the 101
                self.mux_connections += 1
                await self._serve_mux(reader, writer)
                return
            keep = (
                request.wants_keepalive()
                and served < self.KEEPALIVE_MAX_REQUESTS
            )
            try:
                response = await self._dispatch(request)
            except Exception:
                log.exception("request handling failed")
                response = Response(500, b"internal server error\n")
            if isinstance(response, StreamingResponse):
                # close-delimited by contract; ends the connection
                await self._write_stream(reader, writer, response)
                return
            if not await self._write_response(
                writer, response, close=not keep
            ):
                return  # client went away mid-write
            if not keep:
                return

    # -- cp-mux/1 accept path -------------------------------------------

    async def _serve_mux(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        """The multiplexed sibling of the keep-alive loop: one read
        loop demultiplexes frames into per-stream state, each
        completed request dispatches as its own task, and response
        writes interleave on the shared socket. Frames are enqueued
        whole under a writer lock, so concurrent stream tasks can
        never tear each other's frames; per-stream WINDOW credit gates
        response DATA, so a stream whose consumer stalls parks only
        its own task while the others keep writing."""
        streams: Dict[int, _MuxServerStream] = {}
        tasks: Set["asyncio.Task[None]"] = set()
        frames_seen = 0

        # frame writes need no lock: each frame is emitted by ONE
        # synchronous writer.write() call (built fully before the
        # write, no await in between), so concurrent stream tasks
        # interleave at frame granularity by construction — and the
        # drain afterwards is pure flow control, safe to share. This
        # also keeps the writer publishing outside any lock
        # (CP-LOCKPUB's shape: never await subscribers mid-critical-
        # section).
        async def send(ftype: int, sid: int, payload: bytes = b"") -> None:
            writer.write(encode_frame(ftype, sid, payload))
            await writer.drain()

        async def send_data(stream: "_MuxServerStream", data: bytes) -> None:
            view = memoryview(data)
            while view:
                while stream.window <= 0:
                    stream.credit.clear()
                    await stream.credit.wait()
                n = min(len(view), stream.window, MUX_CHUNK)
                stream.window -= n
                await send(FRAME_DATA, stream.sid, bytes(view[:n]))
                view = view[n:]

        async def send_streaming(
            stream: "_MuxServerStream", response: StreamingResponse
        ) -> None:
            """Relay an async-iterator body as interleaved DATA
            frames. Mirrors _write_stream's cleanup contract: the
            generator is aclose()d and the close callback fires
            however the stream ends (completion, CANCEL, connection
            death) — a handler's finally still frees what the request
            holds. A handler that dies mid-iteration CANCELs the
            stream (the client's error signal), never leaves it
            dangling without an END."""
            agen = response.chunks
            ended = False
            try:
                await send(
                    FRAME_HEADERS, stream.sid,
                    _mux_response_head(response),
                )
                async for chunk in agen:
                    await send_data(stream, chunk)
                await send(FRAME_END, stream.sid)
                ended = True
            except (ConnectionError, BrokenPipeError, OSError):
                ended = True  # connection is gone; nothing to CANCEL
            except Exception:
                log.exception("mux stream write failed")
            finally:
                if not ended:
                    try:
                        await send(FRAME_CANCEL, stream.sid)
                    except (ConnectionError, BrokenPipeError, OSError):
                        log.debug("mux: CANCEL after failed stream "
                                  "write found the connection gone")
                try:
                    await agen.aclose()
                except Exception:
                    log.exception("mux stream close failed")
                if response.close is not None:
                    try:
                        response.close()
                    except Exception:
                        log.exception("mux stream close callback failed")

        async def run_stream(stream: "_MuxServerStream") -> None:
            # each stream runs as its own task, so binding the stream
            # id here scopes it to exactly this request's handler —
            # log records emitted under it carry stream_id (and the
            # handler's trace carries it for /v1/traces)
            _get_tracing().set_stream_id(stream.sid)
            try:
                request = stream.to_request()
                if isinstance(request, Response):
                    response: Response = request
                else:
                    self.requests_served += 1
                    self.mux_streams_served += 1
                    try:
                        response = await self._dispatch(request)
                    except Exception:
                        log.exception("mux request handling failed")
                        response = Response(
                            500, b"internal server error\n"
                        )
                if isinstance(response, StreamingResponse):
                    await send_streaming(stream, response)
                    return
                try:
                    head = _mux_response_head(response)
                    body = response.body
                    if len(body) <= stream.window:
                        # common case: the whole response fits the
                        # client's current window — HEADERS+DATA+END
                        # as ONE write and ONE drain (three separate
                        # frame sends cost two extra drain cycles on
                        # the hot path)
                        stream.window -= len(body)
                        frames = encode_frame(
                            FRAME_HEADERS, stream.sid, head
                        )
                        if body:
                            frames += encode_frame(
                                FRAME_DATA, stream.sid, body
                            )
                        frames += encode_frame(FRAME_END, stream.sid)
                        writer.write(frames)
                        await writer.drain()
                    else:
                        await send(FRAME_HEADERS, stream.sid, head)
                        await send_data(stream, body)
                        await send(FRAME_END, stream.sid)
                except (ConnectionError, BrokenPipeError, OSError):
                    return  # peer is gone; reader loop unwinds the rest
            finally:
                streams.pop(stream.sid, None)

        async def watchdog() -> None:
            # the mux analog of the keep-alive idle reap: a connection
            # with no live streams and no frames for a full idle
            # window is retired; one with in-flight streams is never
            # reaped, however slow its handlers (handler execution is
            # deliberately unbounded, as on the HTTP/1.1 path)
            seen = -1
            while True:
                await asyncio.sleep(self.KEEPALIVE_IDLE_TIMEOUT)
                if not streams and frames_seen == seen:
                    writer.close()
                    return
                seen = frames_seen

        reaper = asyncio.ensure_future(watchdog())
        try:
            while True:
                try:
                    ftype, sid, payload = await read_frame(reader)
                except (
                    asyncio.IncompleteReadError, ConnectionError, OSError,
                ):
                    return  # peer went away; tasks unwind in finally
                except MuxProtocolError as exc:
                    log.warning("mux: protocol error: %s", exc)
                    return
                frames_seen += 1
                if ftype == FRAME_PING:
                    await send(FRAME_PONG, sid, payload)
                elif ftype == FRAME_HEADERS:
                    if sid == 0 or sid in streams:
                        log.warning(
                            "mux: HEADERS for invalid/live stream %d", sid
                        )
                        return
                    try:
                        head = json.loads(payload.decode())
                        if not isinstance(head, dict):
                            raise ValueError("head is not an object")
                    except (ValueError, UnicodeDecodeError) as exc:
                        log.warning("mux: malformed HEADERS: %s", exc)
                        return
                    if len(streams) >= self.MUX_MAX_STREAMS:
                        # refuse THIS stream, keep the connection: the
                        # client sees a retryable 503, its co-resident
                        # streams see nothing at all
                        await send(
                            FRAME_HEADERS, sid,
                            _mux_refusal_head(),
                        )
                        await send(FRAME_END, sid)
                        continue
                    streams[sid] = _MuxServerStream(sid, head)
                elif ftype == FRAME_DATA:
                    stream = streams.get(sid)
                    if stream is None or stream.task is not None:
                        continue  # cancelled/raced: late frames are noise
                    stream.body_len += len(payload)
                    if stream.body_len > MAX_BODY:
                        log.warning("mux: stream %d body exceeds cap", sid)
                        return
                    stream.body.append(payload)
                elif ftype == FRAME_END:
                    stream = streams.get(sid)
                    if stream is None or stream.task is not None:
                        continue
                    stream.task = asyncio.ensure_future(
                        run_stream(stream)
                    )
                    tasks.add(stream.task)
                    stream.task.add_done_callback(tasks.discard)
                elif ftype == FRAME_CANCEL:
                    stream = streams.pop(sid, None)
                    if stream is not None and stream.task is not None:
                        # the handler task's finally (and a streaming
                        # response's aclose/close) runs its cleanup;
                        # the stream id is free for reuse immediately
                        stream.task.cancel()
                elif ftype == FRAME_WINDOW:
                    stream = streams.get(sid)
                    if stream is not None and len(payload) == 4:
                        stream.window += int.from_bytes(payload, "big")
                        stream.credit.set()
                # FRAME_PONG from a client is valid but meaningless here
        except (ConnectionError, BrokenPipeError, OSError):
            # a read-loop send (PONG, stream-cap refusal) bounced off
            # a peer that just reset: same quiet exit as read-side EOF
            return
        finally:
            reaper.cancel()
            for task in list(tasks):
                task.cancel()
            for task in list(tasks):
                try:
                    await task
                except asyncio.CancelledError:
                    pass
                except Exception:
                    log.exception("mux stream task failed during close")

    async def _write_response(
        self,
        writer: asyncio.StreamWriter,
        response: Response,
        *,
        close: bool,
    ) -> bool:
        """Send one Content-Length-framed response. Returns False when
        the client is gone (the connection is unusable either way)."""
        try:
            reason = _REASONS.get(response.status, "Unknown")
            headers = {
                "Content-Type": response.content_type,
                "Content-Length": str(len(response.body)),
                "Connection": "close" if close else "keep-alive",
                **response.headers,
            }
            head = f"HTTP/1.1 {response.status} {reason}\r\n" + "".join(
                f"{k}: {v}\r\n" for k, v in headers.items()
            )
            writer.write(head.encode() + b"\r\n" + response.body)
            await writer.drain()
            return True
        except (ConnectionError, BrokenPipeError):
            return False

    async def _write_stream(
        self,
        reader: asyncio.StreamReader,
        writer: asyncio.StreamWriter,
        response: StreamingResponse,
    ) -> None:
        """Send head, then relay chunks as they arrive; abort the
        moment the client goes away. Each chunk wait races a read on
        the request side of the socket — EOF there is the earliest
        reliable disconnect signal (drain() only fails on a later
        write)."""
        async def _client_gone() -> None:
            # only a true EOF means the client left: a pipelined
            # second request from a keep-alive client puts BYTES on
            # the read side, which must not abort the stream mid-way
            while await reader.read(65536):
                pass

        agen = response.chunks
        eof_task = asyncio.ensure_future(_client_gone())
        try:
            reason = _REASONS.get(response.status, "Unknown")
            headers = {
                "Content-Type": response.content_type,
                "Cache-Control": "no-store",
                "Connection": "close",
                **response.headers,
            }
            head = f"HTTP/1.1 {response.status} {reason}\r\n" + "".join(
                f"{k}: {v}\r\n" for k, v in headers.items()
            )
            writer.write(head.encode() + b"\r\n")
            await writer.drain()
            while True:
                get_task = asyncio.ensure_future(agen.__anext__())
                await asyncio.wait(
                    {get_task, eof_task},
                    return_when=asyncio.FIRST_COMPLETED,
                )
                if eof_task.done():
                    get_task.cancel()
                    try:
                        await get_task
                    except (StopAsyncIteration, asyncio.CancelledError,
                            Exception):
                        pass
                    break
                chunk = get_task.result()  # raises StopAsyncIteration
                writer.write(chunk)
                await writer.drain()
        except StopAsyncIteration:
            pass
        except (ConnectionError, BrokenPipeError):
            pass
        except Exception:
            log.exception("stream write failed")
        finally:
            eof_task.cancel()
            try:
                await eof_task
            except (asyncio.CancelledError, Exception):
                pass
            try:
                await agen.aclose()  # run the generator's cleanup
            except Exception:
                log.exception("stream close failed")
            if response.close is not None:
                try:
                    response.close()
                except Exception:
                    log.exception("stream close callback failed")
            try:
                writer.close()
                await writer.wait_closed()
            except Exception:
                pass

    async def _read_request(
        self, reader: asyncio.StreamReader, request_line: bytes
    ):
        """Parse one request whose request line was already read;
        returns a Request, or a Response for protocol-level errors."""
        try:
            method, target, version = request_line.decode().split(None, 2)
        except (ValueError, UnicodeDecodeError):
            return Response(400, b"malformed request line\n")
        headers: Dict[str, str] = {}
        while True:
            line = await reader.readline()
            if line in (b"\r\n", b"\n", b""):
                break
            if b":" in line:
                try:
                    key, _, value = line.decode().partition(":")
                except UnicodeDecodeError:
                    return Response(400, b"malformed header\n")
                headers[key.strip().lower()] = value.strip()
        try:
            length = int(headers.get("content-length", "0") or "0")
        except ValueError:
            return Response(400, b"bad content-length\n")
        if length < 0:
            return Response(400, b"bad content-length\n")
        if length > MAX_BODY:
            return Response(400, b"body too large\n")
        body = await reader.readexactly(length) if length else b""
        parts = urlsplit(target)
        return Request(
            method.upper(), parts.path, parse_qs(parts.query), headers,
            body, version=version.strip(),
        )

    async def _dispatch(self, request: Request) -> Response:
        handler = self.routes.get((request.method, request.path))
        if handler is None:
            if any(p == request.path for (_m, p) in self.routes):
                return Response(405, b"method not allowed\n")
            return Response(404, b"not found\n")
        return await handler(request)
