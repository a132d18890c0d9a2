"""Minimal asyncio HTTP/1.1 server with keep-alive and streaming
responses: the plain part of ``containerpilot_tpu/utils/http.py`` (the
port keeps its own copy; the cp-mux/1 upgrade and the tracing hooks are
not ported yet).

Buffered responses are Content-Length-framed and the connection stays
open unless the client asks to close (HTTP/1.0 without keep-alive, or
``Connection: close``). A ``StreamingResponse`` is close-delimited and
ends its connection. Protocol errors (400/408) answer and close.
"""
from __future__ import annotations

import asyncio
import logging
from typing import (
    AsyncIterator,
    Awaitable,
    Callable,
    Dict,
    Optional,
    Set,
    Tuple,
    Union,
)
from urllib.parse import urlsplit

log = logging.getLogger("containerpilot.http")

MAX_BODY = 4 * 1024 * 1024


class Request:
    def __init__(self, method: str, path: str, headers: Dict[str, str],
                 body: bytes, version: str = "HTTP/1.1") -> None:
        self.method = method
        self.path = path
        self.headers = headers
        self.body = body
        self.version = version

    def wants_keepalive(self) -> bool:
        connection = self.headers.get("connection", "").lower()
        if "close" in connection:
            return False
        if self.version.upper().startswith("HTTP/1.0"):
            return "keep-alive" in connection
        return True


class Response:
    def __init__(self, status: int = 200, body: bytes = b"",
                 content_type: str = "text/plain; charset=utf-8",
                 headers: Optional[Dict[str, str]] = None) -> None:
        self.status = status
        self.body = body
        self.content_type = content_type
        self.headers = headers or {}


_REASONS = {
    200: "OK",
    400: "Bad Request",
    404: "Not Found",
    405: "Method Not Allowed",
    408: "Request Timeout",
    422: "Unprocessable Entity",
    500: "Internal Server Error",
    503: "Service Unavailable",
}


class StreamingResponse:
    """A response whose body arrives incrementally from an async
    iterator of byte chunks (SSE events). Sent with ``Connection:
    close`` and no Content-Length: the closing connection delimits the
    stream, so a stream always ends its connection.

    A client disconnect is seen at once (the request side of the socket
    reaches EOF) and the iterator is ``aclose()``d, so a handler
    generator's ``finally`` can release what the request holds (free a
    slot mid-generation). ``close`` is called however the stream ends,
    also when the iterator never started (``aclose()`` of an unstarted
    async generator skips its body), so it must be idempotent."""

    def __init__(
        self,
        chunks: AsyncIterator[bytes],
        status: int = 200,
        content_type: str = "text/event-stream",
        headers: Optional[Dict[str, str]] = None,
        close: Optional[Callable[[], None]] = None,
    ) -> None:
        self.status = status
        self.chunks = chunks
        self.content_type = content_type
        self.headers = headers or {}
        self.close = close


Handler = Callable[[Request], Awaitable[Union[Response, StreamingResponse]]]


class HTTPServer:
    """Route-table HTTP server over asyncio streams; bind via
    ``start_tcp``."""

    # bound on reading one request; handler execution is unbounded
    REQUEST_READ_TIMEOUT = 30.0
    KEEPALIVE_IDLE_TIMEOUT = 75.0
    KEEPALIVE_MAX_REQUESTS = 1000

    def __init__(self) -> None:
        self.routes: Dict[Tuple[str, str], Handler] = {}
        self._server: Optional[asyncio.AbstractServer] = None
        self._conns: Set[asyncio.StreamWriter] = set()

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
            # close idle keep-alive connections first: wait_closed waits
            # for every connection handler to finish
            for conn_writer in list(self._conns):
                conn_writer.close()
            await self._server.wait_closed()
            self._server = None
        else:
            for conn_writer in list(self._conns):
                conn_writer.close()
        await asyncio.sleep(0)

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        self._conns.add(writer)
        try:
            await self._serve_connection(reader, writer)
        finally:
            self._conns.discard(writer)
            try:
                writer.close()
                await writer.wait_closed()
            except (ConnectionError, OSError):
                pass

    async def _serve_connection(self, reader: asyncio.StreamReader,
                                writer: asyncio.StreamWriter) -> None:
        served = 0
        while True:
            timeout = (
                self.REQUEST_READ_TIMEOUT if served == 0
                else self.KEEPALIVE_IDLE_TIMEOUT
            )
            try:
                request_line = await asyncio.wait_for(
                    reader.readline(), timeout
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
            except ValueError:  # request line over the reader's limit
                await self._write_response(
                    writer, Response(400, b"malformed request line\n"),
                    close=True,
                )
                return
            if not request_line:
                return  # client closed the connection
            try:
                request = await asyncio.wait_for(
                    self._read_request(reader, request_line),
                    self.REQUEST_READ_TIMEOUT,
                )
            except asyncio.TimeoutError:
                request = Response(408, b"request timeout\n")
            except asyncio.IncompleteReadError:
                request = Response(400, b"truncated request\n")
            except ConnectionError:
                return
            if isinstance(request, Response):
                await self._write_response(writer, request, close=True)
                return
            served += 1
            keep = (
                request.wants_keepalive()
                and served < self.KEEPALIVE_MAX_REQUESTS
            )
            try:
                response = await self._dispatch(request)
            except Exception:
                # a boundary that must keep serving: log, answer 500
                log.exception("request handling failed")
                response = Response(500, b"internal server error\n")
            if isinstance(response, StreamingResponse):
                # close-delimited by contract; ends the connection
                await self._write_stream(reader, writer, response)
                return
            if not await self._write_response(writer, response, close=not keep):
                return
            if not keep:
                return

    async def _write_response(self, writer: asyncio.StreamWriter,
                              response: Response, *, close: bool) -> bool:
        """Send one Content-Length-framed response; False when the
        client is gone."""
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

    async def _write_stream(self, reader: asyncio.StreamReader,
                            writer: asyncio.StreamWriter,
                            response: StreamingResponse) -> None:
        """Send the head, then relay chunks as they arrive; stop the
        moment the client goes away. Each chunk wait races a read on the
        request side of the socket: EOF there is the earliest reliable
        disconnect signal (a write fails only later)."""
        async def client_gone() -> None:
            # only EOF means the client left: a pipelined request puts
            # bytes on the read side and must not abort the stream
            while await reader.read(65536):
                pass

        chunks = response.chunks
        gone = asyncio.ensure_future(client_gone())
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
                nxt = asyncio.ensure_future(chunks.__anext__())
                await asyncio.wait({nxt, gone},
                                   return_when=asyncio.FIRST_COMPLETED)
                if gone.done():
                    nxt.cancel()
                    try:
                        await nxt
                    except (StopAsyncIteration, asyncio.CancelledError,
                            Exception):
                        pass
                    break
                writer.write(nxt.result())  # raises StopAsyncIteration
                await writer.drain()
        except StopAsyncIteration:
            pass
        except (ConnectionError, BrokenPipeError):
            pass
        except Exception:
            log.exception("stream write failed")
        finally:
            gone.cancel()
            try:
                await gone
            except (asyncio.CancelledError, Exception):
                pass
            try:
                await chunks.aclose()  # run the generator's cleanup
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

    async def _read_request(self, reader: asyncio.StreamReader,
                            request_line: bytes):
        """Parse one request whose request line was already read ->
        Request, or a Response for protocol-level errors."""
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
        if length < 0 or length > MAX_BODY:
            return Response(400, b"bad content-length\n")
        body = await reader.readexactly(length) if length else b""
        return Request(method.upper(), urlsplit(target).path, headers, body,
                       version=version.strip())

    async def _dispatch(self, request: Request) -> Response:
        handler = self.routes.get((request.method, request.path))
        if handler is None:
            if any(p == request.path for (_m, p) in self.routes):
                return Response(405, b"method not allowed\n")
            return Response(404, b"not found\n")
        return await handler(request)
