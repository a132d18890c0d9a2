"""The client half of cp-mux/1: the port's own copy of
``containerpilot_tpu/fleet/pool.py``'s ``MuxConnection`` and what it
needs to open an upgraded connection and run streams on it. The
gateway's connection pool is not ported; ``dial_mux`` stands in for its
dial-and-upgrade step.

One upgraded connection carries many interleaved streams to a single
server. Frames are parsed at the transport-protocol layer and routed to
per-stream handles; a response's DATA credit is granted back only as its
chunks are consumed, so a stalled reader parks only its own stream. A
connection that dies fails every in-flight stream exactly once.
"""
from __future__ import annotations

import asyncio
import json
import logging
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

from ..telemetry import tracing
from ..utils.http import (
    FRAME_CANCEL,
    FRAME_DATA,
    FRAME_END,
    FRAME_HEAD,
    FRAME_HEADERS,
    FRAME_PING,
    FRAME_PONG,
    FRAME_TYPES,
    FRAME_WINDOW,
    MUX_MAX_FRAME,
    MUX_PROTOCOL,
    MUX_UPGRADE_PATH,
    encode_frame,
)

__all__ = [
    "MuxConnection",
    "MuxStream",
    "MuxStreamError",
    "UpstreamError",
    "dial_mux",
]


log = logging.getLogger("containerpilot.fleet")


class UpstreamError(RuntimeError):
    """Transport-level failure talking to one replica."""


class MuxStreamError(UpstreamError):
    """One stream failed on a connection that is still healthy
    (per-stream deadline, server-side stream abort): the co-resident
    streams are fine, so the caller must NOT evict the replica's
    connections — cancel this stream and move on."""


class MuxStream:
    """Client-side handle for one in-flight stream: a deque of events
    the connection's read loop pushes (response head, DATA chunks,
    END, errors) drained by the request's own task. Waits use a plain
    Event plus a timer handle — no Task-per-read, the same economy
    ``utils.http.timed_read`` buys the HTTP/1.1 hot path."""

    __slots__ = (
        "conn", "sid", "status", "headers", "ended",
        "_buf", "_event", "_expired",
    )

    def __init__(self, conn: "MuxConnection", sid: int) -> None:
        self.conn = conn
        self.sid = sid
        self.status: Optional[int] = None
        self.headers: Dict[str, str] = {}
        self.ended = False
        self._buf: Deque[Tuple] = deque()
        self._event = asyncio.Event()
        self._expired = False

    # -- read-loop side ----------------------------------------------

    def push(self, item: Tuple) -> None:
        self._buf.append(item)
        self._event.set()

    # -- consumer side -----------------------------------------------

    def _expire(self) -> None:
        self._expired = True
        self._event.set()

    async def _next(self, timeout: float) -> Tuple:
        while not self._buf:
            self._event.clear()
            self._expired = False
            handle = asyncio.get_event_loop().call_later(
                timeout, self._expire
            )
            try:
                await self._event.wait()
            finally:
                handle.cancel()
            if self._expired and not self._buf:
                raise MuxStreamError(
                    f"{self.conn.authority}: stream {self.sid} timed "
                    f"out after {timeout}s"
                )
        return self._buf.popleft()

    async def response_head(
        self, timeout: float
    ) -> Tuple[int, Dict[str, str]]:
        kind, payload = await self._next(timeout)
        if kind == "err":
            self.ended = True
            raise payload
        if kind != "head":
            self.ended = True
            raise MuxStreamError(
                f"{self.conn.authority}: stream {self.sid} got "
                f"{kind!r} before the response head"
            )
        self.status, self.headers = payload
        return self.status, self.headers

    async def read_chunk(self, timeout: float) -> bytes:
        """The next DATA chunk, or b"" once the stream ended. Credit
        is granted back only as chunks are CONSUMED here, so a relay
        whose downstream stalls stops refilling the sender's window —
        that is the whole per-stream backpressure loop."""
        if self.ended:
            return b""
        kind, payload = await self._next(timeout)
        if kind == "data":
            if not (self._buf and self._buf[0][0] == "end"):
                # skip the refill when END is already buffered: a
                # buffered response would otherwise pay a whole extra
                # socket send (and the server an extra wakeup) per
                # request for credit nobody will ever spend
                self.conn.grant(self.sid, len(payload))
            return payload
        self.ended = True
        if kind == "end":
            return b""
        if kind == "err":
            raise payload
        raise MuxStreamError(
            f"{self.conn.authority}: stream {self.sid} got "
            f"unexpected {kind!r} mid-body"
        )

    async def read_body(self, timeout: float, cap: int) -> bytes:
        chunks: List[bytes] = []
        total = 0
        while True:
            chunk = await self.read_chunk(timeout)
            if not chunk:
                return b"".join(chunks)
            total += len(chunk)
            if total > cap:
                self.cancel()
                raise MuxStreamError(
                    f"{self.conn.authority}: stream {self.sid} body "
                    f"exceeds {cap}-byte cap"
                )
            chunks.append(chunk)

    def cancel(self) -> bool:
        """Abort this stream with a CANCEL frame, leaving the shared
        connection in service. Returns True when a live stream was
        actually cancelled (the caller's 'a teardown was saved'
        signal); a stream that already ended, or whose connection is
        already dead, has nothing to cancel."""
        if self.ended:
            return False
        self.ended = True
        return self.conn.cancel_stream(self.sid)


class _MuxClientProtocol(asyncio.Protocol):
    """Client frame parser living AT the transport-protocol layer:
    complete frames are parsed and routed to stream handles
    synchronously inside ``data_received``, so a response wakes the
    awaiting request task DIRECTLY — no intermediate reader task, no
    per-read future machinery. This is what keeps mux's per-request
    cost at parity with the classic keep-alive path at concurrency 1
    (a reader-task design pays one extra task switch per response)."""

    def __init__(self, conn: "MuxConnection") -> None:
        self.conn = conn
        self.buf = bytearray()
        self.paused = False
        self.drained = asyncio.Event()
        self.drained.set()

    def connection_made(self, transport) -> None:  # pragma: no cover
        pass  # the transport was adopted mid-life; conn holds it

    def data_received(self, data: bytes) -> None:
        buf = self.buf
        buf += data
        head_size = FRAME_HEAD.size
        pos = 0
        end = len(buf)
        conn = self.conn
        while end - pos >= head_size:
            length, ftype, sid = FRAME_HEAD.unpack_from(buf, pos)
            if ftype not in FRAME_TYPES or length > MUX_MAX_FRAME:
                conn.protocol_error(f"bad frame ({ftype}, {length})")
                return
            if end - pos < head_size + length:
                break
            payload = bytes(buf[pos + head_size:pos + head_size + length])
            pos += head_size + length
            if not conn.on_frame(ftype, sid, payload):
                return  # protocol error already handled
        del buf[:pos]

    def connection_lost(self, exc: Optional[Exception]) -> None:
        self.drained.set()  # never leave a drain waiter hanging
        self.conn._die(UpstreamError(
            f"{self.conn.authority}: mux connection died: "
            f"{exc or 'EOF'}"
        ))

    def pause_writing(self) -> None:
        self.paused = True
        self.drained.clear()

    def resume_writing(self) -> None:
        self.paused = False
        self.drained.set()


class MuxConnection:
    """One upgraded cp-mux/1 connection carrying many interleaved
    streams to a single replica. Frames are parsed at the protocol
    layer (_MuxClientProtocol) and routed to per-stream handles;
    death (EOF, reset, protocol violation) fails every in-flight
    stream exactly once."""

    def __init__(self, replica_id: str, authority: str) -> None:
        self.replica_id = replica_id
        self.authority = authority
        self.dead = False
        self.dead_exc: Optional[UpstreamError] = None
        self.streams: Dict[int, MuxStream] = {}
        self.streams_opened = 0
        self._next_id = 1
        self._transport = None
        self._writer: Optional[asyncio.StreamWriter] = None
        self._protocol: Optional[_MuxClientProtocol] = None
        self._pongs: Dict[bytes, asyncio.Event] = {}
        #: (method, path) -> encoded head; (method, path, True) ->
        #: (prefix, suffix) template the trace id splices between
        self._head_cache: Dict[Tuple, object] = {}

    @property
    def active_streams(self) -> int:
        return len(self.streams)

    def adopt(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        """Take over the freshly upgraded socket from its stream pair:
        swap the transport's protocol for the frame parser. Any bytes
        the server raced onto the wire after its 101 are replayed out
        of the StreamReader's buffer first."""
        transport = writer.transport
        # hold the writer for the connection's life: on CPython 3.12
        # ``StreamWriter.__del__`` closes its transport, so a writer
        # dropped here would kill the adopted socket at its next
        # collection
        self._writer = writer
        protocol = _MuxClientProtocol(self)
        leftover = b""
        buffered = getattr(reader, "_buffer", None)
        if buffered:
            leftover = bytes(buffered)
            buffered.clear()
        transport.set_protocol(protocol)
        self._transport = transport
        self._protocol = protocol
        try:
            if not transport.is_reading():
                transport.resume_reading()
        except (RuntimeError, AttributeError):
            log.debug("mux: transport resume after adopt not needed")
        if leftover:
            protocol.data_received(leftover)

    def _head(self, method: str, path: str,
              trace_id: Optional[str]) -> bytes:
        """The HEADERS payload of a request, encoded once per (method,
        path) and cached. A traced head is a cached (prefix, suffix)
        template with the trace id spliced in, as the gateway sends it;
        an id that is not splice-safe (tracing.safe_id) is JSON-encoded
        instead, never spliced."""
        def encode(trace) -> bytes:
            headers = {"content-type": "application/json"}
            if trace is not None:
                headers["x-cp-trace"] = trace
            return json.dumps({"method": method, "path": path,
                               "headers": headers}).encode()

        if not trace_id:
            head = self._head_cache.get((method, path))
            if head is None:
                head = self._head_cache[(method, path)] = encode(None)
            return head
        if tracing.safe_id(trace_id) is None:
            return encode(trace_id)
        parts = self._head_cache.get((method, path, True))
        if parts is None:
            template = encode("@TRACE-ID@").split(b'"@TRACE-ID@"')
            # a method/path holding the placeholder would tear the
            # template: encode such heads whole
            parts = ((template[0] + b'"', b'"' + template[1])
                     if len(template) == 2 else None)
            self._head_cache[(method, path, True)] = parts
        if parts is None:
            return encode(trace_id)
        return parts[0] + trace_id.encode() + parts[1]

    async def open_stream(
        self,
        method: str,
        path: str,
        body: bytes = b"",
        trace_id: Optional[str] = None,
    ) -> MuxStream:
        """Send HEADERS(+DATA)+END for a new stream in one write and
        return its handle; ``trace_id`` rides the HEADERS frame as
        ``x-cp-trace``. Raises UpstreamError when the connection is
        dead or the send fails."""
        if self.dead:
            raise UpstreamError(f"{self.authority}: connection already dead")
        sid = self._next_id
        self._next_id += 1
        if self._next_id >= 1 << 32:
            self._next_id = 1
        frames = encode_frame(FRAME_HEADERS, sid,
                              self._head(method, path, trace_id))
        if body:
            frames += encode_frame(FRAME_DATA, sid, body)
        frames += encode_frame(FRAME_END, sid)
        stream = MuxStream(self, sid)
        self.streams[sid] = stream
        self.streams_opened += 1
        try:
            self._transport.write(frames)
        except (ConnectionError, OSError) as exc:
            self.streams.pop(sid, None)
            self._die(UpstreamError(f"{self.authority}: {exc}"))
            raise UpstreamError(f"{self.authority}: {exc}") from None
        if self._protocol.paused:
            # transport backpressure (rare: the socket buffer filled);
            # wait it out so opens can't pile unbounded bytes
            await self._protocol.drained.wait()
            if self.dead:
                self.streams.pop(sid, None)
                raise UpstreamError(
                    f"{self.authority}: connection died during drain")
        return stream

    def grant(self, sid: int, n: int) -> None:
        """Refill the server's send window for one stream; fire-and-
        forget (tiny frame — a dead transport surfaces through
        connection_lost, not here)."""
        if self.dead or n <= 0:
            return
        try:
            self._transport.write(
                encode_frame(FRAME_WINDOW, sid, n.to_bytes(4, "big"))
            )
        except (ConnectionError, OSError):
            log.debug("mux: WINDOW write found %s gone", self.authority)

    def cancel_stream(self, sid: int) -> bool:
        stream = self.streams.pop(sid, None)
        if self.dead:
            return False
        try:
            self._transport.write(encode_frame(FRAME_CANCEL, sid))
        except (ConnectionError, OSError):
            return False
        return stream is not None

    async def ping(self, timeout: float = 5.0) -> bool:
        """Round-trip liveness probe (tests, warmup)."""
        if self.dead:
            return False
        nonce = str(self.streams_opened).encode() + b":" + str(
            id(self)
        ).encode()
        event = asyncio.Event()
        self._pongs[nonce] = event
        try:
            self._transport.write(encode_frame(FRAME_PING, 0, nonce))
            await asyncio.wait_for(event.wait(), timeout)
            return True
        except (ConnectionError, OSError, asyncio.TimeoutError):
            return False
        finally:
            self._pongs.pop(nonce, None)

    def on_frame(self, ftype: int, sid: int, payload: bytes) -> bool:
        """Route one parsed frame; called synchronously from the
        protocol's data_received. Returns False when the frame killed
        the connection (protocol violation)."""
        if ftype == FRAME_HEADERS:
            stream = self.streams.get(sid)
            if stream is None:
                return True  # cancelled: late frames are noise
            try:
                head = json.loads(payload.decode())
                status = int(head["status"])
                headers = {
                    str(k).lower(): str(v)
                    for k, v in (head.get("headers") or {}).items()
                }
            except (ValueError, KeyError, TypeError,
                    UnicodeDecodeError) as exc:
                self.protocol_error(f"malformed response head: {exc}")
                return False
            stream.push(("head", (status, headers)))
        elif ftype == FRAME_DATA:
            stream = self.streams.get(sid)
            if stream is not None:
                stream.push(("data", payload))
        elif ftype == FRAME_END:
            stream = self.streams.pop(sid, None)
            if stream is not None:
                stream.push(("end", None))
        elif ftype == FRAME_CANCEL:
            stream = self.streams.pop(sid, None)
            if stream is not None:
                stream.push((
                    "err",
                    MuxStreamError(
                        f"{self.authority}: stream {sid} cancelled "
                        f"by the server"
                    ),
                ))
        elif ftype == FRAME_PONG:
            event = self._pongs.get(bytes(payload))
            if event is not None:
                event.set()
        elif ftype == FRAME_PING:
            self._transport.write(encode_frame(FRAME_PONG, sid, payload))
        # FRAME_WINDOW: request bodies aren't windowed; ignore
        return True

    def protocol_error(self, msg: str) -> None:
        self._die(UpstreamError(
            f"{self.authority}: mux protocol error: {msg}"
        ))

    def _die(self, exc: UpstreamError) -> None:
        """Fail every in-flight stream EXACTLY once: the stream table
        is drained here, so neither a late frame nor a second close
        can deliver a second error."""
        if self.dead:
            return
        self.dead = True
        self.dead_exc = exc
        failed = list(self.streams.values())
        self.streams.clear()
        for stream in failed:
            stream.push(("err", exc))
        if self._transport is not None:
            self._transport.close()

    def close(self, reason: str = "connection closed") -> None:
        """Tear down (eviction, shutdown): in-flight streams fail
        once and the transport closes."""
        self._die(UpstreamError(f"{self.authority}: {reason}"))


def _parse_head(
    head_blob: bytes, authority: str
) -> Tuple[int, Dict[str, str]]:
    """Status + lowercased headers from one response head blob;
    raises UpstreamError on garbage (the upgrade probe's parser)."""
    lines = head_blob.split(b"\r\n")
    parts = lines[0].decode("latin-1", "replace").split(None, 2)
    if len(parts) < 2 or not parts[1].isascii() or not parts[1].isdigit():
        raise UpstreamError(
            f"{authority}: malformed status line {lines[0]!r}"
        )
    headers: Dict[str, str] = {}
    for line in lines[1:]:
        if not line:
            continue
        key, _, value = line.decode("latin-1", "replace").partition(":")
        headers[key.strip().lower()] = value.strip()
    return int(parts[1]), headers


async def dial_mux(
    host: str, port: int, timeout: float = 10.0, replica_id: str = "",
) -> Optional[MuxConnection]:
    """Dial ``host:port`` and ask for the cp-mux/1 upgrade. Returns the
    upgraded connection, or None when the server declined (a server
    without mux answers the upgrade path through its route table, 404):
    the caller's signal to stay on plain HTTP/1.1. Raises UpstreamError
    when the dial or the upgrade exchange fails."""
    authority = f"{host}:{port}"
    try:
        reader, writer = await asyncio.wait_for(
            asyncio.open_connection(host, port), timeout
        )
    except (OSError, asyncio.TimeoutError) as exc:
        raise UpstreamError(f"connect {authority}: {exc}") from None
    try:
        writer.write(
            (
                f"GET {MUX_UPGRADE_PATH} HTTP/1.1\r\n"
                f"Host: {authority}\r\n"
                f"Connection: Upgrade\r\n"
                f"Upgrade: {MUX_PROTOCOL}\r\n\r\n"
            ).encode()
        )
        await writer.drain()
        head_blob = await asyncio.wait_for(
            reader.readuntil(b"\r\n\r\n"), timeout
        )
        status, _headers = _parse_head(head_blob, authority)
    except (
        OSError, ConnectionError, asyncio.TimeoutError,
        asyncio.IncompleteReadError, asyncio.LimitOverrunError,
        UpstreamError,
    ) as exc:
        writer.close()
        if isinstance(exc, UpstreamError):
            raise
        raise UpstreamError(f"mux upgrade {authority}: {exc}") from None
    if status != 101:
        writer.close()
        return None
    conn = MuxConnection(replica_id or authority, authority)
    conn.adopt(reader, writer)
    return conn
