"""Minimal asyncio load-generator client for the chaos harness (the port's
own copy of ``containerpilot_tpu/chaos/client.py``).

The workload generator needs things stdlib HTTP clients make awkward:
TTFT measured at the first response byte, SSE event accounting, and
deliberately hanging up mid-stream (the abandoned-client fault). This
client speaks just enough HTTP/1.1 for the gateway's two response
shapes (Content-Length-framed JSON and close-delimited SSE) and
records a ``RequestRecord`` per call.

One connection per request, by design: each trace request models an
independent end client, so gateway-side keep-alive pooling (replica
side) is exercised while the client side stays adversarially churny.

Well-behaved clients honor ``Retry-After``: a 429 (admission shed) or
a maintenance 503 that carries one is retried after that delay times
an equal-jitter factor seeded per request — thousands of clients shed
in the same burst instant must NOT re-arrive in the same instant, or
the retry storm re-creates the spike shedding just absorbed (the
client-side mirror of the gateway's jittered retry backoff). A final
429/504 with Retry-After is recorded as a **shed**: honest overload
refusal the SLO scorer counts apart from failures. A retried 503
still sets ``saw_5xx`` — politeness must not hide a 5xx from the
zero-5xx invariants.
"""
from __future__ import annotations

import asyncio
import json
import random
import time
from typing import Any, Dict, Optional, Tuple

from ..telemetry.tracing import stage_totals
from .slo import RequestRecord
from .trace import TraceRequest

#: generous cap on any single request; scenario wall time is bounded
#: by the runner, this just keeps a wedged read from pinning the run
REQUEST_TIMEOUT_S = 60.0
#: Retry-After honor policy: how many times a polite client re-sends
#: a shed/maintenance answer, and the longest single wait it accepts
MAX_RETRY_AFTER_RETRIES = 2
MAX_RETRY_AFTER_WAIT_S = 5.0
#: statuses worth re-sending when the server quoted a Retry-After:
#: 429 is an admission shed, 503 a draining/overloaded hop. 504 is
#: NEVER retried — the request's deadline already passed.
RETRYABLE_WITH_HINT = frozenset({429, 503})
SHED_STATUSES = frozenset({429, 504})


async def _read_head(
    reader: asyncio.StreamReader,
) -> Tuple[int, Dict[str, str]]:
    blob = await reader.readuntil(b"\r\n\r\n")
    lines = blob.split(b"\r\n")
    parts = lines[0].decode("latin-1").split(None, 2)
    status = int(parts[1])
    headers: Dict[str, str] = {}
    for line in lines[1:]:
        if not line:
            continue
        key, _, value = line.decode("latin-1").partition(":")
        headers[key.strip().lower()] = value.strip()
    return status, headers


def _count_tokens(payload: Dict[str, Any]) -> int:
    rows = payload.get("tokens")
    if not isinstance(rows, list):
        return 0
    return sum(len(r) for r in rows if isinstance(r, list))


def _retry_after_s(headers: Dict[str, str]) -> Optional[float]:
    raw = headers.get("retry-after", "")
    if not raw:
        return None
    try:
        value = float(raw)
    except ValueError:
        return None
    return value if value >= 0 else None


async def issue_request(
    port: int,
    req: TraceRequest,
    clock_zero: float,
    host: str = "127.0.0.1",
    path: str = "/v1/generate",
) -> RequestRecord:
    """Issue one trace request against the gateway and record the
    outcome, honoring Retry-After on shed/maintenance answers. Never
    raises: transport failures land in ``error`` so the scorer can
    count them (a chaos run WANTS to observe failures). TTFT runs
    from the FIRST attempt — a retried shed that eventually succeeds
    is only good if the whole dance met the SLO."""
    record = RequestRecord(
        index=req.index,
        session_id=req.session_id,
        started_s=time.monotonic() - clock_zero,
        finished_s=0.0,
        stream=req.stream,
    )
    # per-request jitter stream: seeded so runs replay, distinct per
    # request so a burst's shed victims desynchronize
    rng = random.Random(req.seed * 2654435761 % (2**31) ^ 0x5EED)
    attempts = 0
    retry_wait_s = 0.0
    while True:
        headers = await _attempt(port, req, clock_zero, record, host, path)
        attempts += 1
        if (
            not record.error
            and 500 <= record.status <= 599
            and record.status != 504
        ):
            # a non-shed 5xx was SEEN, even if a polite retry later
            # lands a 200 — zero-5xx invariants must still count it
            record.saw_5xx = True
        if (
            record.error
            or record.status not in RETRYABLE_WITH_HINT
            or attempts > MAX_RETRY_AFTER_RETRIES
        ):
            break
        hint = _retry_after_s(headers)
        if hint is None:
            break
        record.client_retries += 1
        # equal jitter: [hint/2, hint] — the mean backs off with the
        # server's estimate, the spread kills the synchronized wave
        delay = min(hint, MAX_RETRY_AFTER_WAIT_S)
        jittered = delay * (0.5 + 0.5 * rng.random())
        retry_wait_s += jittered
        await asyncio.sleep(jittered)
        # a retry is a fresh exchange; only TTFT's zero point persists
        record.ttft_s = None
        record.tokens_out = 0
        record.truncated = False
    # a transport failure on the LAST attempt leaves the prior
    # answer's status/header flags behind — an errored exchange is
    # never an honest shed
    if (
        record.status in SHED_STATUSES
        and record.retry_after_quoted
        and not record.error
    ):
        record.shed = True
    if retry_wait_s > 0.0:
        # Retry-After parking is admission-imposed wait exactly like
        # gateway queue time — the client was told to stand off
        # because no dispatch capacity existed. Folding it into the
        # same stage keeps TTFT attribution honest: a request whose
        # SLO died in the shed-retry dance blames admission, not the
        # replica that eventually served it in milliseconds.
        record.stages["admission_queue_wait"] = (
            record.stages.get("admission_queue_wait", 0.0) + retry_wait_s
        )
    record.finished_s = time.monotonic() - clock_zero
    return record


async def _attempt(
    port: int,
    req: TraceRequest,
    clock_zero: float,
    record: RequestRecord,
    host: str,
    path: str,
) -> Dict[str, str]:
    """One wire exchange; mutates ``record`` and returns the response
    headers (empty on transport failure)."""
    # the record reflects the FINAL exchange: a retry that dies on
    # the wire must not inherit the prior attempt's status/header
    # flags (saw_5xx, set by the caller, is the cumulative memory)
    record.status = 0
    record.retry_after_quoted = False
    record.trace_id = ""
    record.stages = {}
    writer: Optional[asyncio.StreamWriter] = None
    headers: Dict[str, str] = {}
    try:
        record_body = json.dumps(req.payload()).encode()
        reader, writer = await asyncio.wait_for(
            asyncio.open_connection(host, port), REQUEST_TIMEOUT_S
        )
        priority_header = (
            f"X-Priority: {req.priority}\r\n"
            if req.priority != "interactive" else ""
        )
        head = (
            f"POST {path} HTTP/1.1\r\n"
            f"Host: {host}:{port}\r\n"
            f"Content-Type: application/json\r\n"
            f"Content-Length: {len(record_body)}\r\n"
            f"{priority_header}"
            f"Connection: close\r\n\r\n"
        )
        writer.write(head.encode() + record_body)
        await writer.drain()
        status, headers = await asyncio.wait_for(
            _read_head(reader), REQUEST_TIMEOUT_S
        )
        record.status = status
        record.retry_after_quoted = "retry-after" in headers
        # request identity + stage breakdown: every gateway answer —
        # sheds and 504s included — carries its trace id, and most
        # carry the span digest the triage ledger decomposes TTFT by
        record.trace_id = headers.get("x-cp-trace", "")
        record.stages = stage_totals(
            headers.get("x-cp-span-digest", "")
        )
        if "text/event-stream" in headers.get("content-type", ""):
            await _consume_stream(reader, req, record, clock_zero)
        else:
            length = int(headers.get("content-length", "0") or "0")
            body = await asyncio.wait_for(
                reader.readexactly(length) if length else reader.read(),
                REQUEST_TIMEOUT_S,
            )
            # buffered TTFT: the whole response IS the first token's
            # arrival (the replica decodes before writing anything)
            record.ttft_s = (
                time.monotonic() - clock_zero
            ) - record.started_s
            if status == 200:
                try:
                    record.tokens_out = _count_tokens(json.loads(body))
                except ValueError:
                    record.error = "unparseable 200 body"
    except (OSError, asyncio.TimeoutError,
            asyncio.IncompleteReadError, ValueError) as exc:
        record.error = f"{type(exc).__name__}: {exc}"
    finally:
        if writer is not None:
            writer.close()
    return headers


async def _consume_stream(
    reader: asyncio.StreamReader,
    req: TraceRequest,
    record: RequestRecord,
    clock_zero: float,
) -> None:
    """Read SSE events, marking TTFT at the first data event, hanging
    up after ``abandon_after_events`` when the trace says so, and
    flagging truncation when the stream ends without its terminal
    ``done`` event."""
    events = 0
    saw_done = False
    buffer = b""
    while True:
        chunk = await asyncio.wait_for(
            reader.read(65536), REQUEST_TIMEOUT_S
        )
        if not chunk:
            break
        buffer += chunk
        while b"\n\n" in buffer:
            raw, buffer = buffer.split(b"\n\n", 1)
            if not raw.startswith(b"data: "):
                continue
            try:
                event = json.loads(raw[len(b"data: "):])
            except ValueError:
                continue
            events += 1
            if record.ttft_s is None:
                record.ttft_s = (
                    time.monotonic() - clock_zero
                ) - record.started_s
            if event.get("done"):
                saw_done = True
                spans = event.get("spans")
                if isinstance(spans, str):
                    # the stream's digest channel: the replica ships
                    # its spans in the terminal frame (headers are
                    # long gone); merge them under the same prefix
                    # the gateway's stitcher uses
                    for stage, dur in stage_totals(spans).items():
                        key = "replica." + stage
                        record.stages[key] = (
                            record.stages.get(key, 0.0) + dur
                        )
            else:
                record.tokens_out += len(event.get("tokens") or [])
        if saw_done:
            return
        if (
            req.abandon_after_events is not None
            and events >= req.abandon_after_events
        ):
            record.abandoned = True
            return
    record.truncated = not saw_done
