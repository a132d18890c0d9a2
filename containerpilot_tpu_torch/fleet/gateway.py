"""FleetGateway: health-aware HTTP routing over discovered replicas (the
port's own copy of ``containerpilot_tpu/fleet/gateway.py``; its metrics
live in the port's ``utils/prom.Registry``, with the reference's family
names, labels, help strings and buckets).

The fleet's data plane. A gateway process discovers healthy
``InferenceServer`` replicas through a watches-style poll on the
discovery Backend (the same ``check_for_upstream_changes`` discipline
supervisor Watch actors use) and proxies the inference API over them:

- **Routing**: least-outstanding-requests across the healthy set,
  with optional affinity — requests carrying a ``session_id`` (or an
  ``X-Affinity-Key`` header, or — in ``prefix`` mode — sharing a
  prompt prefix) stick to one replica so its prefix KV cache keeps
  hitting. A sticky key whose replica drained away is re-routed and
  counted (``drained_away``).
- **Cache-contents-aware routing**: replicas advertise a versioned
  fingerprint digest of their warm prompt prefixes (kvtier/digest.py)
  through heartbeat notes, the same channel occupancy travels. When a
  request has no live sticky pin — a fresh session, a re-pin after a
  drain, a retry exclusion — ``_pick`` prefers a replica whose digest
  contains the request's prefix fingerprint, bounded by a load slack
  (``cache_slack``) so a wedged-but-warm replica is never chosen over
  a healthy cold one. ``cache_hint_hits``/``cache_hint_misses`` and a
  fleet-wide ``tokens_reused`` gauge land on ``/metrics`` + ``/fleet``.
- **Retries**: generation requests are idempotent under a fixed seed,
  so a transport failure or a 503 (a draining or warming replica)
  retries on a DIFFERENT replica with capped exponential backoff —
  the drain path's client-visible half: zero 5xx while a replica
  leaves the fleet.
- **Hedging**: once enough latency samples exist, a buffered request
  still unanswered at the observed tail quantile dispatches a hedge
  to a second replica; first success wins, the loser is cancelled
  (its connection closes, and the replica's continuous-batching loop
  absorbs the wasted decode).
- **Streaming**: SSE responses (``"stream": true``) relay chunk-by-
  chunk; retries apply only BEFORE the first upstream byte, never
  mid-stream.
- **Multiplexed transport**: with ``mux=True`` (default) each
  replica's traffic — buffered and SSE alike — rides interleaved
  cp-mux/1 streams on ONE warm upgraded connection (pool.py's
  MuxConnection over utils/http's frame codec), so in-flight
  concurrency per replica stops being bounded by socket count, a
  hedge loser or abandoned client costs a CANCEL frame instead of a
  connection teardown (``mux_cancels`` / ``conns_saved_by_mux``
  counters), and a slow SSE consumer stalls only its own stream's
  window. Replicas that decline the upgrade fall back per-replica to
  the classic pooled path below, negotiated transparently.
- **Connection pooling**: buffered hops to non-mux replicas reuse a
  bounded LIFO pool of keep-alive connections per replica (pool.py)
  instead of dialing per request; pooled connections are evicted when
  a replica leaves the healthy set or fails a request, a stale pooled
  connection gets ONE transparent redial, and hedged/retried legs
  always take distinct connections.
- **Metrics**: per-replica counters (routed, retried, hedged,
  drained_away, pool_hit/pool_miss/pool_evicted) plus request/latency
  series in a private registry on ``GET /metrics`` (utils/prom
  exposition), and a ``GET /fleet`` JSON snapshot for runbooks.

The gateway holds no model state: it is restartable at will, N
gateways can front one fleet, and every later scale PR (autoscaling,
multi-backend, spillover) slots in behind this surface.
"""
from __future__ import annotations

import asyncio
import hashlib
import json
import logging
import random
import time
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Any, Deque, Dict, Iterable, List, Optional, Set, Tuple

from ..discovery import Backend
from ..kvtier import FP_TOKENS, prefix_fingerprint
from ..analysis.loopcheck import LoopLagProbe
from ..telemetry import goodput as goodput_mod
from ..telemetry import tracing
from ..utils.http import (
    HTTPServer,
    Request,
    Response,
    StreamingResponse,
    timed_read,
)
from ..utils.prom import (
    Counter,
    Gauge,
    Histogram,
    Registry,
    ensure_build_info,
    ensure_loop_lag_gauge,
    exposition,
)
from ..utils.tasks import spawn
from ..watches import poll_upstream
from . import notes as notes_mod
from .admission import (
    AdmissionController,
    AdmissionError,
    DeadlineExpired,
    PRIORITY_NAMES,
    delta_seconds,
    parse_priority,
)
from .pool import (
    ConnectionPool,
    MuxStream,
    MuxStreamError,
    PooledConnection,
    StaleConnection,
    StaleMuxConnection,
    UpstreamError,
)
from .standby import (
    ROLE_ACTIVE,
    ROLE_DECODE,
    ROLE_PREFILL,
    ROLE_STANDBY,
    equal_jitter,
)

log = logging.getLogger("containerpilot.fleet")

# upstream statuses worth moving to another replica for: 503 is a
# draining/warming replica by this repo's own convention
RETRYABLE_STATUSES = frozenset({503})
#: roles a heartbeat note may carry; anything else (a newer replica
#: speaking a role this gateway predates) routes as active — advice
#: degrades, it never partitions
_KNOWN_ROLES = frozenset(
    {ROLE_ACTIVE, ROLE_STANDBY, ROLE_PREFILL, ROLE_DECODE}
)
#: every role that serves traffic (standby is parked capacity)
_SERVING_ROLES = (ROLE_ACTIVE, ROLE_PREFILL, ROLE_DECODE)
# replica endpoints the disaggregated handoff drives (serve.py):
# seed a prefill replica's cache, then have the decode replica pull
# the KV prefix replica-to-replica (kvtier/handoff.py)
PREFILL_PATH = "/v1/prefill"
KV_PULL_PATH = "/v1/kv/pull"
AFFINITY_MODES = ("none", "session", "prefix")
STICKY_CAPACITY = 4096
PREFIX_TOKENS = 16  # ids of the prompt prefix hashed in "prefix" mode
PREFIX_CHARS = 64   # chars of a text prompt hashed in "prefix" mode
HEDGE_MIN_SAMPLES = 20
# bound on a single upstream response body, Content-Length-declared or
# accumulated on the read-to-EOF (close-delimited) path: a replica that
# lies about its framing can't balloon the gateway's memory
MAX_UPSTREAM_BODY = 64 * 1024 * 1024


@dataclass
class Replica:
    """One healthy replica as the router sees it."""

    id: str
    address: str
    port: int
    outstanding: int = 0
    #: admission-queued requests whose sticky key pins here: work this
    #: replica WILL absorb that hasn't dispatched yet. Folded into the
    #: routing load signal — counting only dispatched requests made a
    #: replica absorbing queued work look idle the moment it wedged
    #: mid-burst, and least-outstanding kept feeding it.
    queued: int = 0
    first_seen: float = field(default_factory=time.monotonic)
    #: prefix fingerprints this replica advertised as warm (its
    #: heartbeat's ``pd=`` digest) — what cache-aware routing scores
    digest: frozenset = frozenset()
    digest_version: int = -1
    #: monotonic stamp of the last digest update (staleness signal)
    digest_at: float = 0.0
    #: last-seen reuse counters from the ``kv=`` note field
    kv: Dict[str, int] = field(default_factory=dict)
    #: last-seen device-time ledger totals from the ``gp=`` note
    #: field (cumulative stage seconds + dispatches/tokens; merged
    #: elementwise-max against torn notes, like ``kv``)
    goodput: Dict[str, float] = field(default_factory=dict)
    #: monotonic stamp of the first 200 a generate/completions got
    #: from this replica — the gateway half of time-to-first-routed-
    #: token after a scale event
    first_ok_at: Optional[float] = None
    #: fleet role from the ``role=`` heartbeat field: a ``standby``
    #: replica is warm, promotable capacity — catalog-visible and
    #: heartbeating, but excluded from ``_pick`` and from admission
    #: capacity until its post-promotion beat drops the field
    role: str = ROLE_ACTIVE
    #: compile-cache advertisement (``cc=<digest>:<dir>``, raw):
    #: same-host launches adopt the dir; surfaced on /fleet
    compile_cache: str = ""
    #: True while this replica is evacuating its sessions (``mg=``
    #: note, active flag): routing avoids NEW pins on it whenever
    #: any alternative exists — it is about to leave, and a fresh
    #: session there would need migrating right back
    migrating: bool = False
    #: last-seen cumulative ``mg=`` counters (the delta source for
    #: the fleet migration accounting; elementwise-max merged like
    #: the kv counters, so torn notes never regress them)
    migration: Dict[str, int] = field(default_factory=dict)
    #: fp -> survivor id landings already applied (so each landing
    #: repoints pins exactly once however many beats re-carry it)
    migrated: Dict[int, str] = field(default_factory=dict)

    @property
    def load(self) -> int:
        return self.outstanding + self.queued

    @property
    def authority(self) -> str:
        return f"{self.address}:{self.port}"


async def _send_on(
    conn: PooledConnection,
    method: str,
    path: str,
    body: bytes,
    read_timeout: float,
) -> Tuple[int, Dict[str, str]]:
    """Send one request on an already-open connection and parse the
    status line + headers. The caller keeps ownership of ``conn`` (and
    decides pool release vs discard after the body).

    The status line is bounded by ``read_timeout`` — the replica's
    HTTP server writes it after the handler finishes, so for a
    buffered generation it arrives only once the whole decode is done
    (seconds to minutes). Failures on a REUSED connection before any
    response byte raise StaleConnection: the server answered nothing,
    so resending on a fresh dial cannot double-apply the request."""
    reader, writer = conn.reader, conn.writer
    try:
        # cross-hop trace propagation: the replica records its spans
        # under the SAME id and hands back a digest (tracing.py)
        trace_id = tracing.current_trace_id()
        trace_line = (
            f"{tracing.TRACE_HEADER}: {trace_id}\r\n" if trace_id else ""
        )
        head = (
            f"{method} {path} HTTP/1.1\r\n"
            f"Host: {conn.authority}\r\n"
            f"Content-Type: application/json\r\n"
            f"Content-Length: {len(body)}\r\n"
            f"{trace_line}"
            f"Connection: keep-alive\r\n\r\n"
        )
        writer.write(head.encode() + body)
        await writer.drain()
        # ONE timed read for the whole response head: a wait_for per
        # header line costs a Task + timer each, which is measurable
        # on this hot path
        try:
            head_blob = await timed_read(
                reader, reader.readuntil(b"\r\n\r\n"), read_timeout
            )
        except asyncio.IncompleteReadError as exc:
            if not exc.partial:
                # EOF before any response byte
                if conn.reused:
                    raise StaleConnection(
                        f"{conn.authority}: pooled connection was "
                        f"closed by the server"
                    ) from None
                raise UpstreamError(
                    f"{conn.authority}: closed before the status line"
                ) from None
            # EOF inside the status line or header block: a replica
            # that died after the status line is a FAILED request,
            # never an empty-header success — surfacing it here is
            # what arms the retry/hedge path
            raise UpstreamError(
                f"{conn.authority}: EOF inside response headers "
                f"({exc.partial[:80]!r})"
            ) from None
        except asyncio.LimitOverrunError:
            raise UpstreamError(
                f"{conn.authority}: response head too large"
            ) from None
        lines = head_blob.split(b"\r\n")
        parts = lines[0].decode("latin-1").split(None, 2)
        if (
            len(parts) < 2
            or not parts[1].isascii()
            or not parts[1].isdigit()
        ):
            raise UpstreamError(
                f"{conn.authority}: malformed status line "
                f"{lines[0]!r}"
            )
        status = int(parts[1])
        headers: Dict[str, str] = {}
        for line in lines[1:]:
            if not line:
                continue
            key, _, value = line.decode("latin-1").partition(":")
            headers[key.strip().lower()] = value.strip()
        return status, headers
    except (ConnectionResetError, BrokenPipeError) as exc:
        # a write that bounced off a dead pooled connection: the
        # server reaped it while idle (its FIN can race our send)
        if conn.reused:
            raise StaleConnection(f"{conn.authority}: {exc}") from None
        raise UpstreamError(f"{conn.authority}: {exc}") from None
    except (OSError, asyncio.TimeoutError, UnicodeDecodeError) as exc:
        raise UpstreamError(f"{conn.authority}: {exc}") from None


def _parse_content_length(headers: Dict[str, str]) -> Optional[int]:
    """Strict Content-Length: ASCII decimal digits only. ``int()`` and
    ``str.isdigit()`` both accept Unicode digits ("١٢٣"), and the old
    isdigit() gate silently fell back to read-to-EOF on garbage — a
    malformed value now fails the request instead of mis-framing it."""
    raw = headers.get("content-length")
    if raw is None:
        return None
    if not raw.isascii() or not raw.isdigit():
        raise UpstreamError(f"malformed Content-Length {raw!r}")
    return int(raw)


async def _read_body(
    reader: asyncio.StreamReader, headers: Dict[str, str], timeout: float
) -> bytes:
    """Read a buffered response body: Content-Length when present,
    else until EOF (close-delimited). Both paths are capped at
    MAX_UPSTREAM_BODY; every failure mode raises UpstreamError."""
    length = _parse_content_length(headers)
    if length is not None:
        if length > MAX_UPSTREAM_BODY:
            raise UpstreamError(f"Content-Length {length} exceeds cap")
        try:
            return await timed_read(
                reader, reader.readexactly(length), timeout
            )
        except (
            OSError, asyncio.TimeoutError, asyncio.IncompleteReadError,
        ) as exc:
            raise UpstreamError(f"body read failed: {exc}") from None
    chunks: List[bytes] = []
    total = 0
    while True:
        try:
            chunk = await timed_read(reader, reader.read(65536), timeout)
        except (OSError, asyncio.TimeoutError) as exc:
            raise UpstreamError(f"body read failed: {exc}") from None
        if not chunk:
            return b"".join(chunks)
        total += len(chunk)
        if total > MAX_UPSTREAM_BODY:
            raise UpstreamError("close-delimited body exceeds cap")
        chunks.append(chunk)


#: bytes of relayed SSE kept for the final ``done`` frame's span
#: digest; events are small, so this comfortably holds the last one
_TAIL_KEEP = 4096


def _keep_tail(tail: bytearray, chunk: bytes) -> None:
    """Retain the last ``_TAIL_KEEP`` bytes of a relayed stream —
    enough to recover the terminal SSE event after EOF without ever
    buffering the stream itself."""
    tail += chunk
    if len(tail) > _TAIL_KEEP:
        del tail[:len(tail) - _TAIL_KEEP]


def _tail_digest(tail: bytes) -> str:
    """The replica span digest off a relayed stream's final ``done``
    event, or "" when the stream ended without one (abandon,
    truncation) — telemetry extraction must never fail a relay."""
    idx = tail.rfind(b"data: ")
    if idx < 0:
        return ""
    raw = tail[idx + len(b"data: "):].split(b"\n\n", 1)[0]
    try:
        event = json.loads(raw)
    except ValueError:
        return ""
    if not isinstance(event, dict) or not event.get("done"):
        return ""
    digest = event.get("spans")
    return digest if isinstance(digest, str) else ""


def _reusable(headers: Dict[str, str]) -> bool:
    """A connection goes back to the pool only when the response was
    Content-Length-framed (so the body had a definite end) and the
    server didn't announce ``Connection: close``."""
    return (
        "content-length" in headers
        and "close" not in headers.get("connection", "").lower()
    )


class FleetGateway:
    def __init__(
        self,
        backend: Backend,
        service_name: str = "inference",
        host: str = "127.0.0.1",
        port: int = 0,
        *,
        tag: str = "",
        poll_interval: float = 1.0,
        retries: int = 2,
        retry_backoff: float = 0.05,
        retry_backoff_cap: float = 0.5,
        retry_jitter: float = 0.5,
        jitter_seed: Optional[int] = None,
        empty_poll_threshold: int = 3,
        hedge: bool = True,
        hedge_quantile: float = 0.95,
        hedge_min_ms: float = 50.0,
        hedge_after_ms: Optional[float] = None,
        affinity: str = "session",
        cache_routing: bool = True,
        cache_slack: int = 2,
        sticky_capacity: int = STICKY_CAPACITY,
        connect_timeout: float = 5.0,
        request_timeout: float = 600.0,
        pool_max_idle: int = 8,
        pool_idle_ttl: float = 30.0,
        pool_max_uses: int = 1000,
        mux: bool = True,
        trace: bool = True,
        admission: Optional[Dict[str, Any]] = None,
    ) -> None:
        if affinity not in AFFINITY_MODES:
            raise ValueError(f"affinity must be one of {AFFINITY_MODES}")
        self.backend = backend
        self.service_name = service_name
        self.host = host
        self.port = port
        self.tag = tag
        self.poll_interval = poll_interval
        self.retries = retries
        self.retry_backoff = retry_backoff
        self.retry_backoff_cap = retry_backoff_cap
        # jittered backoff: when a replica dies under load, every
        # in-flight request fails in the same instant — identical
        # backoffs would re-dispatch them as one synchronized wave
        # onto the survivors. Seedable so chaos runs are reproducible.
        if not 0.0 <= retry_jitter <= 1.0:
            raise ValueError("retry_jitter must be in [0, 1]")
        self.retry_jitter = retry_jitter
        self._rng = random.Random(jitter_seed)
        # catalog-flap hold-down: a previously non-empty routing table
        # is wiped only after this many CONSECUTIVE empty polls — one
        # torn/empty catalog read must not turn into client-visible
        # "no healthy replicas" 503s
        if empty_poll_threshold < 1:
            raise ValueError("empty_poll_threshold must be >= 1")
        self.empty_poll_threshold = empty_poll_threshold
        self._empty_polls = 0
        self.flaps_damped = 0  # plain mirror of the counter for /fleet
        self.hedge = hedge
        self.hedge_quantile = hedge_quantile
        self.hedge_min_ms = hedge_min_ms
        # fixed hedge deadline override (tests, known-SLO deployments);
        # None = learn the tail from observed latencies
        self.hedge_after_ms = hedge_after_ms
        self.affinity = affinity
        # cache-contents-aware routing: when a request has no live
        # sticky pin, prefer a replica advertising the request's
        # prefix fingerprint — but only within ``cache_slack`` extra
        # load of the least-loaded candidate, so warmth never
        # overrides a wedged/overloaded replica's load signal
        self.cache_routing = cache_routing
        if cache_slack < 0:
            raise ValueError("cache_slack must be >= 0")
        self.cache_slack = cache_slack
        if sticky_capacity < 1:
            raise ValueError("sticky_capacity must be >= 1")
        self.sticky_capacity = sticky_capacity
        self.sticky_evicted = 0  # plain mirror for /fleet
        self.hint_hits = 0       # plain mirrors of the hint counters
        self.hint_misses = 0
        #: plain mirrors of the KV-handoff counters for /fleet
        #: (docs/60 § disaggregated serving): completed transfers,
        #: bytes moved, failures (fell back to local prefill), and
        #: handoffs skipped because the decode target was already
        #: digest-warm (the multiturn follow-up fast path); ms_sum
        #: accumulates per-transfer wall ms so total/ms_sum yields
        #: the mean handoff cost without scraping the histogram
        self.handoffs: Dict[str, float] = {
            "total": 0, "bytes": 0, "failed": 0, "skipped_warm": 0,
            "ms_sum": 0.0,
        }
        #: plain mirrors of the drain-migration counters for /fleet
        #: (docs/60 § drain runbook): sessions landed on a survivor,
        #: failed pushes (fell back to re-prefill), window-expiry
        #: timeouts, sticky pins repointed off landings, and 503
        #: drain answers that carried X-CP-Migrated-To
        self.migrations: Dict[str, int] = {
            "sessions_migrated": 0, "failed": 0, "timeout": 0,
            "pins_repointed": 0, "drain_answers": 0,
        }
        #: sticky key -> prefix fingerprint, recorded as pins form:
        #: the join the migration repoint needs (an ``mg=`` landing
        #: names an fp; this maps it back to the pinned sessions)
        self._session_fp: Dict[str, int] = {}
        #: final tokens_reused advertised by replicas that have LEFT
        #: the fleet, keyed by id — the fleet-wide gauge must not
        #: forget a drained replica's contribution, and keying by id
        #: lets a flapped-then-rejoined replica reclaim its own entry
        #: instead of being double-counted
        self._reuse_departed: Dict[str, int] = {}
        #: final ledger totals of replicas that LEFT the fleet, keyed
        #: by id — the fleet device-time ledger folds departed
        #: replicas in exactly like ``tokens_reused`` does (their
        #: boot/compile badput happened; a drain must not erase it),
        #: and a flapped-then-rejoined id reclaims its entry
        self._goodput_departed: Dict[str, Dict[str, float]] = {}
        #: first-200 stamps per replica id, surviving departure (a
        #: scale-up that served traffic and then drained still has a
        #: time-to-first-routed-token worth reporting)
        self._first_ok: Dict[str, float] = {}
        self.connect_timeout = connect_timeout
        self.request_timeout = request_timeout

        self.mux = mux
        # request tracing: on by default (the bench pins its cost at
        # effectively-free); --no-trace is the bench's A/B control,
        # not an operational recommendation
        self.trace = trace
        self._tracer = tracing.TraceRecorder("gateway")
        # staleness signal for flap triage: monotonic stamp of the
        # last catalog poll that RETURNED (empty or not); None until
        # the first one lands
        self._last_poll: Optional[float] = None
        self._replicas: Dict[str, Replica] = {}
        self._pool = ConnectionPool(
            max_idle=pool_max_idle,
            idle_ttl=pool_idle_ttl,
            max_uses=pool_max_uses,
            on_event=self._pool_event,
            mux=mux,
        )
        # admission control in front of routing: bounded queue,
        # deadlines, priorities, token buckets, shedding. The default
        # knobs are pass-through-permissive (huge per-replica inflight,
        # no deadline), so a gateway that doesn't configure overload
        # behaves exactly as before while the counters still exist.
        self._admission = AdmissionController(**(admission or {}))
        # graceful shutdown: stop admitting, finish queued + in-flight
        self.draining = False
        #: attached autoscalers, in attach order — a mixed fleet has
        #: one; a disaggregated fleet attaches one per pool so the
        #: prefill and decode pools size independently
        self._autoscalers: List[Any] = []
        self._sticky: "OrderedDict[str, str]" = OrderedDict()
        # per-endpoint pools of recent 200-latencies (seconds): the
        # hedge threshold for generate must not be poisoned by
        # millisecond score/model samples sharing one tail estimate
        self._latencies: Dict[str, Deque[float]] = {}
        self._poll_task: Optional["asyncio.Task[None]"] = None

        # private registry: N gateways (or a gateway next to a
        # supervisor) in one process must not collide (utils/prom.py)
        self._registry = Registry()
        self._m_requests = Counter(
            "containerpilot_gateway_requests",
            "gateway requests by endpoint and status code",
            ["endpoint", "code"], registry=self._registry,
        )
        self._m_latency = Histogram(
            "containerpilot_gateway_request_seconds",
            "gateway request wall time, by endpoint",
            ["endpoint"], registry=self._registry,
            buckets=(.005, .02, .05, .1, .25, .5, 1, 2.5, 5, 10, 30, 60),
        )
        self._m_routed = Counter(
            "containerpilot_gateway_routed",
            "requests dispatched to a replica",
            ["replica"], registry=self._registry,
        )
        self._m_retried = Counter(
            "containerpilot_gateway_retried",
            "requests retried away from a replica "
            "(transport failure or retryable status)",
            ["replica"], registry=self._registry,
        )
        self._m_hedged = Counter(
            "containerpilot_gateway_hedged",
            "hedge dispatches launched against a slow replica",
            ["replica"], registry=self._registry,
        )
        self._m_drained = Counter(
            "containerpilot_gateway_drained_away",
            "sticky keys re-routed because their replica left the fleet",
            ["replica"], registry=self._registry,
        )
        self._g_replicas = Gauge(
            "containerpilot_gateway_healthy_replicas",
            "replicas currently in the healthy routing set",
            registry=self._registry,
        )
        self._g_standby = Gauge(
            "containerpilot_gateway_standby_replicas",
            "healthy replicas parked in the standby role: warm, "
            "promotable, excluded from routing and admission "
            "capacity (fleet/standby.py)",
            registry=self._registry,
        )
        self._g_role = Gauge(
            "containerpilot_gateway_replicas_by_role",
            "healthy replicas by fleet role (active/prefill/decode/"
            "standby) — the disaggregated pool-size view (docs/60)",
            ["role"], registry=self._registry,
        )
        self._m_handoffs = Counter(
            "containerpilot_gateway_handoffs_total",
            "prefill->decode KV handoffs completed (prefix prefilled "
            "on the prefill pool, pulled by the decode target over "
            "cp-mux/1, readmitted through reuse_admission)",
            registry=self._registry,
        )
        self._m_handoff_failed = Counter(
            "containerpilot_gateway_handoffs_failed",
            "KV handoffs that failed any leg (prefill seed, pull, "
            "digest verify); the request fell back to local prefill "
            "on its routed replica — never a client-visible error",
            registry=self._registry,
        )
        self._m_handoff_bytes = Counter(
            "containerpilot_gateway_handoff_bytes",
            "KV bytes moved replica-to-replica by completed handoffs",
            registry=self._registry,
        )
        self._m_handoff_ms = Histogram(
            "containerpilot_gateway_handoff_ms",
            "wall milliseconds per completed KV handoff (prefill "
            "seed + replica-to-replica pull), the cost bound the "
            "disagg bench pins",
            registry=self._registry,
            buckets=(1, 2.5, 5, 10, 25, 50, 100, 250, 500, 1000,
                     2500, 5000),
        )
        self._m_migrated = Counter(
            "containerpilot_gateway_sessions_migrated",
            "sessions landed on a survivor by a drain migration "
            "(KV pushed — or already warm — and the fingerprint "
            "advertised as landed over the mg= note channel)",
            registry=self._registry,
        )
        self._m_migration_failed = Counter(
            "containerpilot_gateway_migration_failed",
            "drain-migration pushes that failed (dead target, "
            "poisoned chunk, declined adoption); the session fell "
            "back to re-prefill on its survivor — never a client "
            "error",
            registry=self._registry,
        )
        self._m_migration_timeout = Counter(
            "containerpilot_gateway_migration_timeout",
            "sessions left unmoved when a drain's migrate window "
            "expired; they fell back to cache-aware re-pin + "
            "re-prefill, today's drain behavior",
            registry=self._registry,
        )
        self._m_flaps_damped = Counter(
            "containerpilot_gateway_catalog_flaps_damped",
            "empty catalog polls absorbed by the hold-down instead of "
            "wiping a previously non-empty routing table",
            registry=self._registry,
        )
        self._m_pool_hits = Counter(
            "containerpilot_gateway_pool_hit",
            "proxied requests served over a reused pooled connection",
            ["replica"], registry=self._registry,
        )
        self._m_pool_misses = Counter(
            "containerpilot_gateway_pool_miss",
            "proxied requests that had to dial a fresh connection",
            ["replica"], registry=self._registry,
        )
        self._m_pool_evicted = Counter(
            "containerpilot_gateway_pool_evicted",
            "pooled connections dropped (replica left the healthy "
            "set, failed a request, or the connection went stale)",
            ["replica"], registry=self._registry,
        )
        self._m_mux_streams = Counter(
            "containerpilot_gateway_mux_streams",
            "proxied requests carried as cp-mux streams on a shared "
            "upgraded connection",
            ["replica"], registry=self._registry,
        )
        self._m_mux_cancels = Counter(
            "containerpilot_gateway_mux_cancels",
            "streams aborted with a CANCEL frame (hedge losers, "
            "abandoned clients, per-stream deadlines) with the shared "
            "connection left in service",
            ["replica"], registry=self._registry,
        )
        self._m_conns_saved = Counter(
            "containerpilot_gateway_conns_saved_by_mux",
            "upstream connections kept alive where the HTTP/1.1 path "
            "would have discarded one (cancelled legs, completed "
            "close-delimited streams)",
            ["replica"], registry=self._registry,
        )
        self._m_admitted = Counter(
            "containerpilot_gateway_admitted",
            "requests granted a dispatch slot, by priority class",
            ["priority"], registry=self._registry,
        )
        self._m_shed = Counter(
            "containerpilot_gateway_shed",
            "requests answered 429 by admission control, by reason "
            "(high_water / queue_full / session)",
            ["reason"], registry=self._registry,
        )
        self._m_expired = Counter(
            "containerpilot_gateway_deadline_expired",
            "queued requests 504'd at their TTFT deadline without "
            "ever dispatching upstream",
            registry=self._registry,
        )
        self._g_admission_depth = Gauge(
            "containerpilot_gateway_admission_depth",
            "requests waiting in the admission queue",
            registry=self._registry,
        )
        self._g_admission_depth.set_function(
            lambda: self._admission.depth
        )
        self._g_admission_inflight = Gauge(
            "containerpilot_gateway_admission_inflight",
            "requests holding a dispatch slot",
            registry=self._registry,
        )
        self._g_admission_inflight.set_function(
            lambda: self._admission.inflight
        )
        self._m_hint_hits = Counter(
            "containerpilot_gateway_cache_hint_hits",
            "routing picks that landed on a replica advertising the "
            "request's prefix fingerprint (cache-aware routing)",
            registry=self._registry,
        )
        self._m_hint_misses = Counter(
            "containerpilot_gateway_cache_hint_misses",
            "fingerprinted requests routed cold: no digest-advertising "
            "replica was warm (or the warm ones exceeded cache_slack)",
            registry=self._registry,
        )
        self._m_sticky_evicted = Counter(
            "containerpilot_gateway_sticky_evicted",
            "sticky-affinity pins evicted by the LRU capacity bound",
            registry=self._registry,
        )
        self._g_fleet_reused = Gauge(
            "containerpilot_gateway_fleet_tokens_reused",
            "fleet-wide prefix-cache tokens_reused: live replicas' "
            "last-advertised counters plus departed replicas' final "
            "ones (the SLO-goodput yardstick for KV reuse)",
            registry=self._registry,
        )
        self._g_fleet_reused.set_function(self._fleet_tokens_reused)
        self._g_fleet_productive = Gauge(
            "cp_fleet_productive_fraction",
            "fleet device-time ledger: (prefill + decode) seconds "
            "over all attributed seconds, live + departed replicas "
            "(docs/90-observability.md § device-time ledger)",
            registry=self._registry,
        )
        self._g_fleet_productive.set_function(
            self._fleet_productive_fraction
        )
        # per-stage latency decomposition: one histogram row per
        # tracing stage (admission_queue_wait, upstream_ttfb,
        # replica.prefill, ...) — the aggregate face of /v1/traces
        self._m_stage = Histogram(
            "cp_request_stage_seconds",
            "per-stage request latency decomposition "
            "(docs/90-observability.md has the stage glossary)",
            ["stage"], registry=self._registry,
            buckets=(.001, .005, .02, .05, .1, .25, .5, 1, 2.5, 5,
                     10, 30, 60),
        )
        ensure_build_info(self._registry, "gateway")
        # event-loop health sentinel (analysis/loopcheck.py): the
        # gateway loop carries every mux stream, admission timer, and
        # catalog poll on the box — one blocking call stalls them all
        # at once, and cp_loop_lag_ms is how that stall gets a name
        # instead of surfacing as unattributed TTFT jitter
        self._loop_probe = LoopLagProbe()
        ensure_loop_lag_gauge(self._registry, self._loop_probe)

        self._server = HTTPServer()
        self._server.route("GET", "/health", self._health)
        self._server.route("GET", "/metrics", self._metrics)
        self._server.route("GET", "/fleet", self._fleet_status)
        self._server.route("GET", "/v1/traces", self._traces)
        self._server.route("GET", "/v1/goodput", self._goodput)
        self._server.route("GET", "/v1/model", self._model_info)
        for path, endpoint in (
            ("/v1/generate", "generate"),
            ("/v1/completions", "completions"),
            ("/v1/score", "score"),
        ):
            self._server.route("POST", path, self._api(endpoint, path))

    # -- lifecycle ------------------------------------------------------

    async def run(self) -> None:
        await self._server.start_tcp(self.host, self.port)
        self.port = self._server.bound_port or self.port
        self._loop_probe.start()
        await self._poll_once()  # first routing set before traffic
        self._poll_task = spawn(
            self._poll_loop(), name=f"fleet-gateway:{self.service_name}"
        )
        log.info(
            "gateway: %s:%d fronting service %r (%d replicas)",
            self.host, self.port, self.service_name, len(self._replicas),
        )

    async def stop(self) -> None:
        self._loop_probe.stop()
        if self._poll_task is not None and not self._poll_task.done():
            self._poll_task.cancel()
            try:
                await self._poll_task
            except asyncio.CancelledError:
                pass
            self._poll_task = None
        self._pool.close_all()
        await self._server.stop()

    async def drain(self, timeout: float = 30.0) -> bool:
        """Graceful shutdown, the replica drain invariant mirrored at
        the gateway: stop admitting (new API requests answer 503 +
        honest Retry-After immediately), let everything already queued
        or in flight — streams included — finish, then return. True
        once idle; False when ``timeout`` expired with work still
        running (the caller stops anyway; the window is a bound, not a
        promise). Idempotent; ``stop()`` still closes the listener."""
        if not self.draining:
            log.info(
                "gateway: draining (%d in flight, %d queued)",
                self._admission.inflight, self._admission.depth,
            )
        self.draining = True
        deadline = time.monotonic() + timeout
        while (
            self._admission.inflight > 0 or self._admission.depth > 0
        ):
            if time.monotonic() >= deadline:
                log.warning(
                    "gateway: drain timed out with %d in flight, "
                    "%d queued",
                    self._admission.inflight, self._admission.depth,
                )
                return False
            await asyncio.sleep(0.02)
        log.info("gateway: drained")
        return True

    @property
    def admission(self) -> AdmissionController:
        return self._admission

    @property
    def registry(self):
        """The gateway's private prometheus registry, so co-located
        actors (the autoscaler) can expose counters on this /metrics."""
        return self._registry

    def attach_autoscaler(self, autoscaler: Any) -> None:
        """Surface an autoscaler's stats on ``GET /fleet`` (its
        prometheus side joins via ``registry=gateway.registry``).
        Call once per pool in a disaggregated fleet — every attached
        autoscaler's stats and scale events are reported; only the
        FIRST should pass the gateway registry (the per-pool metric
        names would collide)."""
        self._autoscalers.append(autoscaler)

    def pool_load(self, role: str = "") -> "FleetLoad":
        """One pool's demand snapshot for its autoscaler's
        ``signals`` hook. ``role=""`` folds every serving replica
        (the classic mixed-fleet signal). The admission queue depth
        rides the PREFILL pool's signal (and the mixed one's):
        queued work is work nobody has prefilled yet, i.e. TTFT
        deadline pressure on admissions — while the decode pool
        scales on pure slot occupancy (TPOT pressure), which is what
        lets the two pools size independently (docs/60)."""
        from .autoscaler import FleetLoad

        if role:
            members = self._role_members(role)
        else:
            members = [
                r for r in self._replicas.values()
                if r.role != ROLE_STANDBY
            ]
        depth = (
            self._admission.depth if role != ROLE_DECODE else 0
        )
        return FleetLoad(
            queue_depth=depth,
            per_replica={r.id: float(r.load) for r in members},
        )

    def _pool_event(self, event: str, replica_id: str) -> None:
        """Mirror pool bookkeeping into the prometheus registry."""
        counter = {
            "hit": self._m_pool_hits,
            "miss": self._m_pool_misses,
            "evicted": self._m_pool_evicted,
        }.get(event)
        if counter is not None:
            counter.labels(replica_id).inc()

    @property
    def replica_count(self) -> int:
        return len(self._replicas)

    # -- discovery ------------------------------------------------------

    async def _poll_loop(self) -> None:
        while True:
            await asyncio.sleep(self.poll_interval)
            try:
                await self._poll_once()
            except Exception as exc:  # a flaky catalog isn't fatal
                log.warning("gateway: catalog poll failed: %s", exc)

    async def _poll_once(self) -> None:
        loop = asyncio.get_event_loop()
        did_change, healthy = await poll_upstream(
            self.backend, self.service_name, self.tag
        )
        # the poll RETURNED (it may still be empty): the staleness
        # clock on /fleet resets here, so a wedged/flapping catalog
        # shows up as a growing catalog_poll_age_s
        self._last_poll = time.monotonic()
        # change detection already scanned the catalog; re-list only
        # when membership moved (or when this gateway holds nothing a
        # freshly-shared backend considers unchanged, or the healthy
        # set emptied) — steady state costs ONE catalog scan per poll
        if not did_change:
            if healthy and self._replicas:
                # a healthy steady-state poll closes any hold-down
                # window: only CONSECUTIVE empty polls may wipe
                self._empty_polls = 0
                return
            if not healthy and not self._replicas:
                return
        instances = await loop.run_in_executor(
            None, self.backend.instances, self.service_name, self.tag
        )
        fresh: Dict[str, Replica] = {}
        for inst in instances:
            address = inst.address or "127.0.0.1"
            known = self._replicas.get(inst.id)
            if known is not None and (known.address, known.port) == (
                address, inst.port,
            ):
                fresh[inst.id] = known  # keep live outstanding counts
            else:
                fresh[inst.id] = Replica(inst.id, address, inst.port)
            # refresh the KV-reuse advertisement (digest + counters)
            # off the catalog notes — notes changes flip did_change,
            # so a replica whose cache contents moved re-lists here
            self._apply_notes(fresh[inst.id], inst.notes)
        if not fresh and self._replicas:
            # catalog-flap hold-down: an empty healthy set right after
            # a non-empty one is more often a torn read / flapping
            # catalog than a simultaneous fleet-wide death. Keep the
            # current routing table (and its pools) until the emptiness
            # persists for empty_poll_threshold consecutive polls.
            self._empty_polls += 1
            if self._empty_polls < self.empty_poll_threshold:
                self._m_flaps_damped.inc()
                self.flaps_damped += 1
                log.warning(
                    "gateway: empty catalog poll %d/%d damped "
                    "(holding %d replicas)",
                    self._empty_polls, self.empty_poll_threshold,
                    len(self._replicas),
                )
                return
            log.warning(
                "gateway: %d consecutive empty polls; dropping all "
                "replicas", self._empty_polls,
            )
        if fresh:
            self._empty_polls = 0
        if did_change or set(fresh) != set(self._replicas):
            log.info(
                "gateway: healthy set -> %s",
                sorted(f"{r.id}@{r.authority}" for r in fresh.values()),
            )
        for rid, gone in self._replicas.items():
            if rid not in fresh and gone.kv.get("tokens_reused", 0):
                # keep a departed replica's reuse contribution in the
                # fleet-wide gauge (its counter dies with its record);
                # zero contributions aren't parked — a long-lived
                # gateway over an autoscaled no-reuse fleet must not
                # grow an entry per departed id forever
                self._reuse_departed[rid] = gone.kv["tokens_reused"]
            if rid not in fresh and any(gone.goodput.values()):
                # same fold-in for the device-time ledger: a retired
                # replica's boot/compile/serve seconds happened, and
                # the fleet's badput decomposition must keep them
                self._goodput_departed[rid] = dict(gone.goodput)
        for rid in fresh:
            # a replica that FLAPPED out and rejoined (wedge heal,
            # TTL-starved heartbeat, catalog flap) advertises the same
            # cumulative counter again — drop the parked copy or the
            # gauge double-counts it on every flap
            self._reuse_departed.pop(rid, None)
            self._goodput_departed.pop(rid, None)
        self._replicas = fresh
        self._g_replicas.set(len(fresh))
        # admission capacity tracks the SERVING healthy set — a parked
        # standby contributes no dispatch slots until its promotion
        # beat lands, at which point capacity grows and queued
        # waiters are granted immediately (the promote-into-a-burst
        # fast path). Phase-specialized replicas (prefill/decode)
        # serve traffic and count like active ones.
        serving = sum(
            1 for r in fresh.values() if r.role != ROLE_STANDBY
        )
        self._g_standby.set(len(fresh) - serving)
        for role in _KNOWN_ROLES:
            self._g_role.labels(role).set(
                sum(1 for r in fresh.values() if r.role == role)
            )
        self._admission.set_capacity(serving)
        # pooled connections to a replica that LEFT the healthy set
        # (drained, deregistered, TTL-expired) are evicted, never
        # reused: a draining replica would answer them 503, a dead one
        # not at all
        self._pool.prune(set(fresh))

    def _apply_notes(self, replica: Replica, notes: str) -> None:
        """Decode a replica's heartbeat check output (``ok occ=0.50
        kv=... pd=v3:...``) into its routing state, field-by-field
        through the note-wire registry (``fleet/notes.py``) — the
        single schema both this consumer and the member's producer
        are driven from. Tolerant: a torn or digest-free note leaves
        the previous advertisement in place rather than blanking a
        warm replica."""
        fields = notes_mod.split_note(notes)
        if "kv" in fields:
            parsed = notes_mod.parse_field("kv", fields["kv"])
            # the counters are CUMULATIVE: a torn note's zero-filled
            # tail (or a truncated digit) must not regress them — a
            # regressed tokens_reused parked by a departure would
            # permanently drop the replica's contribution from the
            # fleet-wide gauge. Elementwise max keeps the best-known
            # cumulative value per field.
            replica.kv = {
                name: max(value, replica.kv.get(name, 0))
                for name, value in parsed.items()
            }
        if "gp" in fields:
            # device-time ledger totals: cumulative like the kv
            # counters, so the same elementwise-max torn-note
            # discipline applies — a truncated note's zero-filled
            # tail must never regress a stage's known seconds
            replica.goodput = goodput_mod.merge_note_max(
                replica.goodput,
                notes_mod.parse_field("gp", fields["gp"]),
            )
        if "pd" in fields:
            version, fps = notes_mod.parse_field("pd", fields["pd"])
            if version is not None and version != replica.digest_version:
                replica.digest = fps
                replica.digest_version = version
                replica.digest_at = time.monotonic()
        if "mg" in fields:
            # drain-migration progress: cumulative counters (same
            # elementwise-max torn-note discipline as kv=) whose
            # deltas feed the fleet accounting, plus fp->target
            # landings — each NEW landing repoints the drainer's
            # matching sticky pins onto the survivor immediately
            counters, landed = notes_mod.parse_field(
                "mg", fields["mg"]
            )
            prev = replica.migration
            merged = {
                name: max(counters.get(name, 0), prev.get(name, 0))
                for name in ("done", "total", "failed", "timeout")
            }
            moved = merged["done"] - prev.get("done", 0)
            failed = merged["failed"] - prev.get("failed", 0)
            timed_out = merged["timeout"] - prev.get("timeout", 0)
            if moved:
                self._m_migrated.inc(moved)
                self.migrations["sessions_migrated"] += moved
            if failed:
                self._m_migration_failed.inc(failed)
                self.migrations["failed"] += failed
            if timed_out:
                self._m_migration_timeout.inc(timed_out)
                self.migrations["timeout"] += timed_out
            replica.migration = merged
            replica.migrating = bool(counters.get("active", 0))
            for landed_fp, target in landed.items():
                if replica.migrated.get(landed_fp) == target:
                    continue
                replica.migrated[landed_fp] = target
                self._repoint_sessions(replica.id, landed_fp, target)
        # role rides every beat of a non-active replica (standby,
        # prefill, decode) and is ABSENT from an active one's note —
        # the first post-promotion beat flips the routing view back
        # to active by omission. Omission only counts on a note that
        # PARSED (a real beat always carries at least occ=): a
        # torn/empty read must keep the previous role, or one
        # half-written catalog record routes a poll interval of
        # traffic into a standby's 503s. An UNKNOWN role value (a
        # newer replica generation) routes as active: role is advice,
        # and degrading to mixed routing beats partitioning traffic.
        if fields:
            role = fields.get("role", ROLE_ACTIVE)
            replica.role = (
                role if role in _KNOWN_ROLES else ROLE_ACTIVE
            )
        if "cc" in fields:
            replica.compile_cache = fields["cc"]

    def _repoint_sessions(
        self, source_id: str, fp: int, target_id: str
    ) -> None:
        """Apply one migration landing: every sticky key pinned to
        the draining ``source_id`` whose recorded session fingerprint
        matches moves to the survivor NOW — the client's next turn
        lands where its KV already is, warm, instead of bouncing off
        the drainer's 503 or re-prefilling cold after deregister.
        A landing naming a target this gateway can't see (not yet
        polled, already gone) is skipped; the pin falls back to the
        ordinary drained-away re-pin path."""
        if target_id == source_id or target_id not in self._replicas:
            return
        for k, rid in self._sticky.items():
            if rid == source_id and self._session_fp.get(k) == fp:
                self._sticky[k] = target_id
                self.migrations["pins_repointed"] += 1

    def _fleet_tokens_reused(self) -> int:
        """Fleet-wide tokens_reused: live replicas' last-advertised
        counters plus what departed replicas took with them."""
        return sum(self._reuse_departed.values()) + sum(
            r.kv.get("tokens_reused", 0)
            for r in self._replicas.values()
        )

    def _fleet_productive_fraction(self) -> float:
        """Gauge body: the fleet ledger's headline number (0.0 until
        any ledger note has arrived — gauges can't carry None)."""
        fraction = goodput_mod.productive_fraction(
            goodput_mod.sum_stage_totals(
                [r.goodput for r in self._replicas.values()]
                + list(self._goodput_departed.values())
            )
        )
        return fraction if fraction is not None else 0.0

    def scale_event_report(self) -> List[Dict[str, Any]]:
        """Scale events stamped into the fleet ledger: each autoscaler
        launch/retire with — for launches — the time-to-first-routed-
        token, measured from the launch decision to the first 200 a
        generate/completions got from the new replica. None until the
        replica actually serves (the cold-start collapse item's
        yardstick: this number must fall release-over-release)."""
        if not self._autoscalers:
            return []
        events: List[Dict[str, Any]] = []
        for scaler in self._autoscalers:
            for event in getattr(scaler, "scale_log", ()):
                self._scale_event(events, event)
        return events

    def _scale_event(
        self, events: List[Dict[str, Any]], event: Dict[str, Any]
    ) -> None:
        entry = {
            "direction": event["direction"],
            "replica": event["replica"],
        }
        if "mode" in event:
            # how the launch happened: "promoted" (warm standby
            # flipped active) vs "cold" (full boot) — the split
            # the cold-start-collapse yardstick is judged on
            entry["mode"] = event["mode"]
        if "pool" in event:
            # which pool's autoscaler decided it (disaggregated
            # fleets size prefill and decode independently)
            entry["pool"] = event["pool"]
        if event["direction"] == "up":
            first_ok = self._first_ok.get(event["replica"])
            entry["ttfrt_s"] = (
                round(first_ok - event["at"], 3)
                if first_ok is not None
                and first_ok >= event["at"] else None
            )
        events.append(entry)

    def fleet_goodput(self) -> Dict[str, Any]:
        """The fleet device-time ledger: per-stage seconds summed
        over live AND departed replicas, productive fraction,
        dispatches/token, the per-replica breakdown, and scale-event
        TTFRT — the ``goodput`` block on ``/fleet`` and the body of
        the gateway's ``/v1/goodput``."""
        live = {
            rid: dict(r.goodput) for rid, r in self._replicas.items()
        }
        summary = goodput_mod.fleet_summary(
            list(live.values())
            + list(self._goodput_departed.values())
        )
        summary["replicas"] = {
            rid: {
                "productive_fraction": (
                    goodput_mod.productive_fraction(totals)
                ),
                "stages_s": {
                    s: round(totals.get(s, 0.0), 3)
                    for s in goodput_mod.STAGES
                },
            }
            for rid, totals in sorted(live.items())
        }
        summary["departed"] = {
            rid: {
                "productive_fraction": (
                    goodput_mod.productive_fraction(totals)
                ),
                "stages_s": {
                    s: round(totals.get(s, 0.0), 3)
                    for s in goodput_mod.STAGES
                },
            }
            for rid, totals in sorted(self._goodput_departed.items())
        }
        summary["scale_events"] = self.scale_event_report()
        return summary

    def _request_fingerprint(
        self, body: Dict[str, Any]
    ) -> Optional[int]:
        """The prefix fingerprint cache-aware routing scores against:
        computed from a single token row exactly the way replicas
        fingerprint their cached keys (kvtier/digest.py). Text
        prompts return None — the gateway has no tokenizer, so those
        requests keep plain sticky/least-loaded routing."""
        if not self.cache_routing:
            return None
        tokens = body.get("tokens")
        if (
            isinstance(tokens, list) and len(tokens) == 1
            and isinstance(tokens[0], list)
            and all(
                isinstance(t, int) for t in tokens[0][:FP_TOKENS]
            )
        ):
            try:
                return prefix_fingerprint(tokens[0])
            except (TypeError, ValueError, OverflowError):
                return None
        return None

    # -- routing --------------------------------------------------------

    def _pick(
        self,
        exclude: Iterable[str] = (),
        fp: Optional[int] = None,
        phase: Optional[str] = None,
    ) -> Optional[Replica]:
        """Least-loaded (dispatched + admission-queue-assigned);
        replica id breaks ties so the choice is deterministic under
        equal load. Counting only dispatched requests let a replica
        whose queued work hadn't landed yet look idle — the exact
        shape a mid-burst wedge hides behind.

        With a prefix fingerprint, a replica advertising it as warm
        is preferred — but only within ``cache_slack`` of the least
        load, so a warm-but-wedged replica never beats a healthy cold
        one; among warm candidates least-loaded still decides.

        Standby-role replicas are never candidates: they are warm
        capacity PARKED for promotion (fleet/standby.py), visible in
        the catalog and on /fleet but outside the routing set until
        their post-promotion heartbeat drops the role field.

        ``phase`` is the disaggregated fleet's soft preference:
        ``"decode"`` keeps generation off prefill-pool replicas,
        ``"prefill"`` keeps prefix seeding off decode-pool ones —
        mixed/active replicas qualify for both. SOFT by design: when
        the preferred subset is empty (a pool scaled to zero, or the
        whole pool is excluded by retries) the pick degrades to every
        serving candidate, so a disaggregated fleet losing one pool
        routes like a mixed fleet instead of 503ing."""
        excluded = set(exclude)
        candidates = [
            r for r in self._replicas.values()
            if r.id not in excluded and r.role != ROLE_STANDBY
        ]
        # a replica mid-evacuation (mg= active) takes no NEW work
        # while any alternative exists: it is leaving, and a fresh
        # session there would need migrating right back. Soft like
        # the phase preference — sole-survivor fleets still route.
        settled = [r for r in candidates if not r.migrating]
        candidates = settled or candidates
        if phase == "decode":
            preferred = [
                r for r in candidates if r.role != ROLE_PREFILL
            ]
            candidates = preferred or candidates
        elif phase == "prefill":
            preferred = [
                r for r in candidates if r.role != ROLE_DECODE
            ]
            candidates = preferred or candidates
        if not candidates:
            return None
        coldest = min(candidates, key=lambda r: (r.load, r.id))
        if fp is None:
            return coldest
        warm = [
            r for r in candidates
            if fp in r.digest
            and r.load <= coldest.load + self.cache_slack
        ]
        if warm:
            self._m_hint_hits.inc()
            self.hint_hits += 1
            return min(warm, key=lambda r: (r.load, r.id))
        if any(r.digest for r in candidates):
            # the hint existed and nobody (eligible) was warm — count
            # it only when digests are in play at all, so fleets that
            # never publish them don't log a miss per request
            self._m_hint_misses.inc()
            self.hint_misses += 1
        return coldest

    def _affinity_key(
        self, req: Request, body: Dict[str, Any]
    ) -> Optional[str]:
        if self.affinity == "none":
            return None
        session = body.get("session_id")
        if isinstance(session, (str, int)) and str(session):
            return f"s:{session}"
        header = req.headers.get("x-affinity-key", "")
        if header:
            return f"h:{header}"
        if self.affinity != "prefix":
            return None
        tokens = body.get("tokens")
        if (
            isinstance(tokens, list) and len(tokens) == 1
            and isinstance(tokens[0], list) and tokens[0]
        ):
            prefix = ",".join(map(str, tokens[0][:PREFIX_TOKENS]))
            return "p:" + hashlib.sha1(prefix.encode()).hexdigest()
        prompt = body.get("prompt")
        if isinstance(prompt, str) and prompt:
            return "p:" + hashlib.sha1(
                prompt[:PREFIX_CHARS].encode()
            ).hexdigest()
        return None

    def _route(
        self,
        key: Optional[str],
        exclude: Iterable[str] = (),
        fp: Optional[int] = None,
        phase: Optional[str] = None,
        dead: Iterable[str] = (),
    ) -> Optional[Replica]:
        """Sticky affinity first, cache-overlap-blended least-
        outstanding otherwise. A sticky target that LEFT the fleet
        (drained/crashed) re-pins and counts as drained_away; one
        that is merely excluded by this request's retry re-routes
        this request only — the pin (and the replica's warm prefix
        cache) survives a transient failure. A re-pin (or a fresh
        pick, or a retry's re-route) consults the request's prefix
        fingerprint, so a session whose replica drained lands on the
        warmest surviving replica instead of wherever least-loaded
        points.

        ``dead`` names replicas this request PROVED unreachable
        (transport failure on a handoff or proxy leg) that the
        catalog poll hasn't expired yet. A pin on one is invalidated
        and re-pinned NOW — treating it as a transient exclusion kept
        the stale pin alive for up to a poll interval, and every
        sticky retry in that window burned an attempt re-discovering
        the same dead replica."""
        excluded = set(exclude)
        dead_ids = set(dead)
        excluded |= dead_ids
        repin = True
        if key is not None:
            if fp is not None:
                # remember the session's fingerprint while it is
                # routed at all: the join a drain migration's mg=
                # landings repoint pins through
                self._session_fp[key] = fp
            pinned = self._sticky.get(key)
            if pinned is not None:
                replica = self._replicas.get(pinned)
                if replica is None or pinned in dead_ids:
                    self._m_drained.labels(pinned).inc()
                    self._sticky.pop(key, None)
                    self._session_fp.pop(key, None)
                elif pinned not in excluded:
                    self._sticky.move_to_end(key)
                    return replica
                else:
                    repin = False  # transient exclusion: keep the pin
        replica = self._pick(excluded, fp, phase)
        if replica is not None and key is not None and repin:
            self._sticky[key] = replica.id
            self._sticky.move_to_end(key)
            while len(self._sticky) > self.sticky_capacity:
                evicted_key, _rid = self._sticky.popitem(last=False)
                self._session_fp.pop(evicted_key, None)
                self._m_sticky_evicted.inc()
                self.sticky_evicted += 1
        return replica

    def _hedge_threshold(self, endpoint: str) -> Optional[float]:
        """Seconds after which a second dispatch is justified for
        ``endpoint``, or None while there's no basis to hedge on."""
        if not self.hedge or len(self._replicas) < 2:
            return None
        if self.hedge_after_ms is not None:
            return self.hedge_after_ms / 1e3
        pool = self._latencies.get(endpoint)
        if pool is None or len(pool) < HEDGE_MIN_SAMPLES:
            return None
        ordered = sorted(pool)
        idx = min(
            int(len(ordered) * self.hedge_quantile), len(ordered) - 1
        )
        return max(ordered[idx], self.hedge_min_ms / 1e3)

    # -- local handlers -------------------------------------------------

    def _retry_after(self) -> str:
        """Honest Retry-After (delta-seconds) for shed/drain/failure
        answers: derived from the admission queue's observed drain
        rate when replicas exist; with none, the catalog poll interval
        is the soonest anything can change."""
        if self._replicas:
            return str(self._admission.retry_after_s())
        return str(delta_seconds(self.poll_interval))

    async def _health(self, _req: Request) -> Response:
        if self.draining:
            return Response(
                503, b"draining\n",
                headers={"Retry-After": self._retry_after()},
            )
        if not self._replicas:
            return Response(
                503, b"no healthy replicas\n",
                headers={"Retry-After": self._retry_after()},
            )
        return Response(200, b"ok\n")

    async def _metrics(self, _req: Request) -> Response:
        body, content_type = exposition(self._registry)
        return Response(200, body, content_type=content_type)

    async def _traces(self, req: Request) -> Response:
        """Per-process trace surface: slowest-N + most-recent-N
        stitched timelines, JSON. ``?n=`` bounds either list."""
        return Response(
            200,
            self._tracer.snapshot_json(req.query),
            content_type="application/json",
        )

    async def _goodput(self, _req: Request) -> Response:
        """The fleet device-time ledger (same blob as ``/fleet``'s
        ``goodput`` block, standalone for scrapers and runbooks)."""
        return Response(
            200, json.dumps(self.fleet_goodput()).encode(),
            content_type="application/json",
        )

    async def _fleet_status(self, _req: Request) -> Response:
        body = json.dumps(
            {
                "service": self.service_name,
                "poll_interval": self.poll_interval,
                "empty_poll_threshold": self.empty_poll_threshold,
                "catalog_flaps_damped": self.flaps_damped,
                # staleness: how old the routing table's information
                # is — THE missing signal when diagnosing a flap
                # hold-down (a growing age means the catalog stopped
                # answering, not that replicas died)
                "catalog_poll_age_s": (
                    round(time.monotonic() - self._last_poll, 3)
                    if self._last_poll is not None else None
                ),
                "traces": (
                    self._tracer.fleet_summary()
                    if self.trace else None
                ),
                "draining": self.draining,
                # event-loop health: the same numbers as the
                # cp_loop_lag_ms gauge, for triage without a scrape
                "loop_lag_ms": {
                    "max": round(self._loop_probe.max_ms(), 2),
                    "p99": round(self._loop_probe.p99_ms(), 2),
                },
                # fleet-wide KV reuse: the goodput yardstick plus the
                # routing hint counters (docs/60 has the runbook rows)
                "kv": {
                    "cache_routing": self.cache_routing,
                    "cache_slack": self.cache_slack,
                    "tokens_reused": self._fleet_tokens_reused(),
                    "hint_hits": self.hint_hits,
                    "hint_misses": self.hint_misses,
                },
                # the fleet device-time ledger: where the fleet's
                # device-seconds went (goodput vs decomposed badput),
                # built from the gp= heartbeat notes — departed
                # replicas folded in, scale events TTFRT-stamped
                "goodput": self.fleet_goodput(),
                "sticky": {
                    "size": len(self._sticky),
                    "capacity": self.sticky_capacity,
                    "evicted": self.sticky_evicted,
                },
                "admission": self._admission.stats(),
                # warm-standby visibility (fleet/standby.py): which
                # healthy replicas are parked, promotable capacity
                "standby": {
                    "count": sum(
                        1 for r in self._replicas.values()
                        if r.role == ROLE_STANDBY
                    ),
                    "ids": sorted(
                        r.id for r in self._replicas.values()
                        if r.role == ROLE_STANDBY
                    ),
                },
                # disaggregated serving (docs/60): per-role pool
                # sizes and the KV-handoff counters
                "roles": {
                    role: sum(
                        1 for r in self._replicas.values()
                        if r.role == role
                    )
                    for role in _SERVING_ROLES + (ROLE_STANDBY,)
                },
                "handoff": dict(self.handoffs),
                # drain migration (docs/60 § drain runbook): sessions
                # moved to survivors over the handoff wire in reverse,
                # counted fallbacks, and the pins repointed off mg=
                # landings / X-CP-Migrated-To drain answers
                "migration": dict(self.migrations),
                "autoscaler": (
                    self._autoscalers[0].stats
                    if self._autoscalers else None
                ),
                "autoscalers": [
                    scaler.stats for scaler in self._autoscalers
                ],
                "pool": {
                    "max_idle": self._pool.max_idle,
                    "idle_ttl_s": self._pool.idle_ttl,
                    "max_uses": self._pool.max_uses,
                    "mux": self._pool.mux,
                },
                "replicas": [
                    {
                        "id": r.id,
                        "address": r.address,
                        "port": r.port,
                        "role": r.role,
                        "compile_cache": r.compile_cache or None,
                        "outstanding": r.outstanding,
                        "queued": r.queued,
                        "age_s": round(
                            time.monotonic() - r.first_seen, 1
                        ),
                        # digest size/staleness: how much of the
                        # replica's cache the gateway knows about,
                        # and how old that knowledge is
                        "kv": dict(r.kv),
                        "digest_fps": len(r.digest),
                        "digest_version": r.digest_version,
                        "digest_age_s": (
                            round(
                                time.monotonic() - r.digest_at, 3
                            )
                            if r.digest_at else None
                        ),
                        "pool": self._pool.stats(r.id),
                        "mux": self._pool.mux_stats(r.id),
                    }
                    for r in sorted(
                        self._replicas.values(), key=lambda r: r.id
                    )
                ],
            }
        ).encode()
        return Response(200, body, content_type="application/json")

    async def _model_info(self, req: Request) -> Response:
        return await self._proxy_buffered("model", "GET", "/v1/model", b"", None)

    # -- proxying -------------------------------------------------------

    def _api(self, endpoint: str, path: str):
        async def handler(req: Request) -> Response:
            t0 = time.perf_counter()
            body = req.body
            try:
                parsed = json.loads(body.decode() or "{}")
            except (ValueError, UnicodeDecodeError):
                parsed = {}  # the replica will 4xx it; just forward
            if not isinstance(parsed, dict):
                parsed = {}
            key = self._affinity_key(req, parsed)
            fp = self._request_fingerprint(parsed)
            # the single token row, for the disaggregated handoff's
            # replica-side POSTs; a non-None fp proves the shape
            row = parsed["tokens"][0] if fp is not None else None
            # mint (or adopt the client's) trace id and bind it for
            # the whole routing lifetime: spans recorded anywhere
            # downstream — admission, hedge legs, relays — attach to
            # this request without threading a handle through
            trace: Optional[tracing.Trace] = None
            token = None
            if self.trace:
                # adopt the client's id only when it is splice-safe
                # (tracing.safe_id): a hostile header must not ride
                # into the mux head template or echoed answers
                trace = self._tracer.start(
                    tracing.safe_id(req.headers.get("x-cp-trace")),
                    endpoint,
                )
                token = tracing.activate(trace)
            try:
                resp = await self._admitted(
                    endpoint, path, body, key, req,
                    stream=bool(parsed.get("stream")),
                    fp=fp,
                    tokens=row,
                )
            except asyncio.CancelledError:
                # client abandon: the server cancels the handler task
                # on disconnect. Not a gateway failure — file the
                # trace (still findable by id) with status 0, the
                # "no server verdict" convention, not a bogus 500
                if trace is not None:
                    trace.finish(0)
                    self._observe_trace(trace)
                raise
            except BaseException:
                if trace is not None:
                    trace.finish(500)
                    self._observe_trace(trace)
                raise
            finally:
                if token is not None:
                    tracing.deactivate(token)
            if trace is not None:
                # every answer — 200s, sheds, 504s, failures — carries
                # its trace id, so a client-reported failure is
                # findable in /v1/traces even when nothing dispatched
                resp.headers.setdefault(
                    tracing.TRACE_HEADER, trace.trace_id
                )
                if isinstance(resp, StreamingResponse):
                    # the relay owns the trace's tail: it adds the
                    # relay span, splices the replica digest off the
                    # final SSE frame, and finishes the trace at
                    # close. The head ships the breakdown known so
                    # far (TTFT is fully decided by this point).
                    resp.headers.setdefault(
                        tracing.DIGEST_HEADER, trace.digest()
                    )
                else:
                    trace.finish(resp.status)
                    self._observe_trace(trace)
                    resp.headers.setdefault(
                        tracing.DIGEST_HEADER, trace.digest()
                    )
            self._m_latency.labels(endpoint).observe(
                time.perf_counter() - t0
            )
            self._m_requests.labels(endpoint, str(resp.status)).inc()
            return resp

        return handler

    async def _admitted(
        self,
        endpoint: str,
        path: str,
        body: bytes,
        key: Optional[str],
        req: Request,
        *,
        stream: bool,
        fp: Optional[int] = None,
        tokens: Optional[List[int]] = None,
    ) -> Response:
        """Admission in front of routing: shed/expire before a replica
        slot is spent, then dispatch holding a ticket. A streaming
        response carries its ticket until the relay closes."""
        if self.draining:
            # graceful shutdown: new work bounces immediately; the
            # queued + in-flight work drain() is waiting on finishes
            return Response(
                503, b"gateway draining\n",
                headers={"Retry-After": self._retry_after()},
            )
        priority = parse_priority(req.headers.get("x-priority", ""))
        deadline_ms = req.headers.get("x-ttft-slo-ms", "")
        deadline_s: Optional[float] = None
        if deadline_ms:
            try:
                deadline_s = max(0.001, float(deadline_ms) / 1e3)
            except ValueError:
                deadline_s = None  # garbage header: server default
        # fold the queued request into its pinned replica's load
        # signal while it waits (see Replica.queued)
        pinned: Optional[Replica] = None
        if key is not None:
            pinned = self._replicas.get(self._sticky.get(key, ""))
            if pinned is not None:
                pinned.queued += 1
        trace = tracing.current_trace()
        try:
            ticket = await self._admission.admit(
                priority, key, deadline_s
            )
        except DeadlineExpired as exc:
            self._m_expired.inc()
            if trace is not None:
                # the request died IN the queue: its whole life was
                # queue wait, and the ledger must be able to say so
                end = tracing.now()
                trace.add_span(
                    "admission_queue_wait", end - exc.waited_s, end
                )
            return Response(
                504,
                f"admission deadline expired: {exc}\n".encode(),
                headers={"Retry-After": self._retry_after()},
            )
        except AdmissionError as exc:
            self._m_shed.labels(exc.label).inc()
            return Response(
                429,
                f"shed: {exc.reason}\n".encode(),
                headers={
                    "Retry-After": str(delta_seconds(exc.retry_after_s))
                },
            )
        finally:
            if pinned is not None:
                pinned.queued -= 1
        if trace is not None:
            # enqueued_at/granted_at are time.monotonic() stamps —
            # the same clock tracing runs on, so this span subtracts
            # cleanly against the upstream spans that follow
            trace.add_span(
                "admission_queue_wait",
                ticket.enqueued_at, ticket.granted_at,
            )
        self._m_admitted.labels(PRIORITY_NAMES[ticket.priority]).inc()
        released = False

        def release(ok: bool) -> None:
            nonlocal released
            if released:
                return
            released = True
            self._admission.release(ticket, completed=ok)

        # phase-aware routing: generation is decode-phase work — in a
        # disaggregated fleet it lands on the decode pool, with the
        # prefill pool seeding the KV prefix first (handoff below);
        # score/model stay phase-free
        phase = (
            "decode" if endpoint in ("generate", "completions")
            else None
        )
        dead: Set[str] = set()
        if phase == "decode" and fp is not None and tokens:
            dead = await self._disagg_prepare(key, fp, tokens)
        try:
            if stream:
                resp = await self._proxy_stream(
                    endpoint, path, body, key, fp, phase, dead
                )
            else:
                resp = await self._proxy_buffered(
                    endpoint, "POST", path, body, key, fp, phase, dead
                )
        except BaseException:
            release(False)
            raise
        if isinstance(resp, StreamingResponse):
            # the dispatch slot stays held while tokens stream; the
            # relay's close (completion, disconnect, upstream death)
            # releases it — both close paths are idempotent. A relay
            # the upstream killed mid-stream is NOT a completion for
            # the drain-rate window.
            inner_close = resp.close

            def close_with_release() -> None:
                try:
                    if inner_close is not None:
                        inner_close()
                finally:
                    release(
                        getattr(
                            resp, "upstream_intact", {}
                        ).get("ok", True)
                    )

            resp.close = close_with_release
        else:
            release(resp.status < 500)
        return resp

    async def _retry_pause(
        self,
        tried: Set[str],
        failed_ids: Iterable[str],
        attempt: int,
        backoff: float,
    ) -> float:
        """The ONE retry bookkeeping discipline: exclude the failed
        replicas, and — only when another attempt will actually
        happen — count the retry and pay the capped exponential
        backoff. Returns the advanced backoff."""
        retrying = attempt < self.retries
        for rid in failed_ids:
            tried.add(rid)
            if retrying:
                self._m_retried.labels(rid).inc()
        if retrying:
            await asyncio.sleep(self._jittered(backoff))
        return min(backoff * 2, self.retry_backoff_cap)

    async def _drain_bounce(
        self,
        key: Optional[str],
        replica_id: str,
        headers: Dict[str, str],
        tried: Set[str],
        attempt: int,
        backoff: float,
    ) -> float:
        """Retry bookkeeping for a retryable 503 that may be a
        DRAINING replica's migration-aware answer: when the response
        names the survivor the session already landed on
        (``X-CP-Migrated-To``), repoint the pin NOW — the retry
        reconnects warm instead of re-prefilling cold — and bill the
        bounce wait to the ``replica.kv_migrate`` trace stage so a
        TTFT violation blames the migration, not the survivor's
        prefill. Plain drain 503s take exactly the old path."""
        target = headers.get("x-cp-migrated-to", "")
        if target:
            self.migrations["drain_answers"] += 1
            if (
                key is not None
                and target in self._replicas
                and self._sticky.get(key) == replica_id
            ):
                self._sticky[key] = target
                self.migrations["pins_repointed"] += 1
        t0 = time.monotonic()
        backoff = await self._retry_pause(
            tried, {replica_id}, attempt, backoff
        )
        if target:
            trace = tracing.current_trace()
            if trace is not None:
                trace.add_span(
                    "replica.kv_migrate", t0, time.monotonic()
                )
        return backoff

    def _jittered(self, backoff: float) -> float:
        """Equal-jitter backoff (the fleet's shared shape,
        standby.equal_jitter): a deterministic floor plus a uniform
        random slice. A replica SIGKILLed under load fails every
        in-flight request in the same millisecond; without jitter the
        retries arrive at the surviving replicas as one synchronized
        storm, re-creating the spike that hedging and least-
        outstanding routing just absorbed."""
        if self.retry_jitter <= 0.0:
            return backoff
        return equal_jitter(backoff, self._rng, self.retry_jitter)

    def _failure_response(self, exc: Exception) -> Response:
        return Response(
            503,
            f"upstream failure: {exc}\n".encode(),
            headers={"Retry-After": self._retry_after()},
        )

    def _stamp_first_ok(self, replica: Replica) -> None:
        """First successful generation served by this replica: the
        other half of a scale event's time-to-first-routed-token."""
        if replica.first_ok_at is None:
            replica.first_ok_at = time.monotonic()
            self._first_ok.setdefault(
                replica.id, replica.first_ok_at
            )

    def _evict_replica_pool(self, replica_id: str) -> None:
        """A request to this replica just transport-failed: its other
        pooled connections can't be trusted either."""
        self._pool.evict(replica_id)

    async def _upstream_request(
        self,
        replica: Replica,
        method: str,
        path: str,
        body: bytes,
    ) -> Tuple[PooledConnection, int, Dict[str, str]]:
        """Acquire a connection (pooled or fresh), send one request,
        parse the response head. A REUSED connection that turns out
        stale (the server reaped it while idle) is discarded and the
        acquire repeats; the loop is bounded because each stale conn
        leaves the pool and a FRESH dial (reused=False) can never
        raise StaleConnection. The caller owns ``conn`` and must
        release/discard it after the body."""
        while True:
            try:
                with tracing.span("upstream_connect"):
                    conn = await self._pool.acquire(
                        replica, self.connect_timeout
                    )
            except UpstreamError:
                self._evict_replica_pool(replica.id)
                raise
            try:
                with tracing.span("upstream_ttfb"):
                    status, headers = await _send_on(
                        conn, method, path, body, self.request_timeout
                    )
            except StaleConnection as exc:
                self._pool.discard_stale(conn)
                log.debug("gateway: redialing stale connection: %s", exc)
                continue
            except UpstreamError:
                self._pool.discard(conn)
                self._evict_replica_pool(replica.id)
                raise
            except BaseException:
                # CancelledError (a losing hedge leg): close on the
                # way out, never pool a connection mid-request
                self._pool.discard(conn)
                raise
            return conn, status, headers

    async def _mux_request(
        self, replica: Replica, method: str, path: str, body: bytes
    ) -> Optional[MuxStream]:
        """Open one cp-mux stream to ``replica``; None means the
        replica doesn't speak mux (or mux is off) and the caller
        takes the classic pooled path. A warm shared connection that
        died between the acquire and this stream's send is redialed
        ONCE, mirroring the classic stale-conn discipline; the loop
        is bounded because a freshly dialed connection never raises
        StaleMuxConnection."""
        while True:
            try:
                with tracing.span("upstream_connect"):
                    mux = await self._pool.acquire_mux(
                        replica, self.connect_timeout
                    )
            except UpstreamError:
                self._evict_replica_pool(replica.id)
                raise
            if mux is None:
                return None
            try:
                # trace id rides the stream's HEADERS frame (pool.py
                # splices it into the cached head template)
                stream = await mux.open_stream(
                    method, path, body,
                    trace_id=tracing.current_trace_id() or None,
                )
            except StaleMuxConnection as exc:
                log.debug(
                    "gateway: redialing stale mux connection: %s", exc
                )
                continue
            except UpstreamError:
                self._evict_replica_pool(replica.id)
                raise
            self._m_mux_streams.labels(replica.id).inc()
            return stream

    def _cancel_stream(self, replica: Replica, stream: MuxStream) -> None:
        """Abort one stream with a CANCEL frame — the mux replacement
        for discarding a connection mid-request (hedge losers,
        abandoned clients, per-stream deadlines)."""
        if stream.cancel():
            self._m_mux_cancels.labels(replica.id).inc()
            self._m_conns_saved.labels(replica.id).inc()

    async def _mux_open_with_head(
        self, replica: Replica, method: str, path: str, body: bytes
    ) -> Optional[Tuple[MuxStream, int, Dict[str, str]]]:
        """Open a mux stream and await its response head, absorbing
        ONE stale-connection redial: a warm shared connection the
        replica reaped while idle fails the stream with zero response
        bytes (StaleMuxConnection), and resending on a fresh
        connection is as safe as the classic pooled redial — no
        routing retry is consumed. Error semantics otherwise follow
        the stream/connection split: a per-stream failure
        (MuxStreamError) CANCELs only this stream; a connection-level
        failure already failed every in-flight stream exactly once,
        so the eviction here is idempotent bookkeeping. None means
        the replica doesn't speak mux."""
        stream = await self._mux_request(replica, method, path, body)
        if stream is None:
            return None
        for retry in (True, False):
            try:
                with tracing.span("upstream_ttfb"):
                    status, headers = await stream.response_head(
                        self.request_timeout
                    )
                return stream, status, headers
            except StaleMuxConnection as exc:
                self._evict_replica_pool(replica.id)
                if not retry:
                    raise
                log.debug(
                    "gateway: redialing stale mux connection: %s", exc
                )
                stream = await self._mux_request(
                    replica, method, path, body
                )
                if stream is None:
                    raise UpstreamError(str(exc)) from None
            except MuxStreamError:
                self._cancel_stream(replica, stream)
                raise
            except UpstreamError:
                self._evict_replica_pool(replica.id)
                raise
            except BaseException:
                # CancelledError (a losing hedge leg / teardown): the
                # CANCEL frame replaces the old connection discard
                self._cancel_stream(replica, stream)
                raise
        raise AssertionError("unreachable")  # pragma: no cover

    async def _mux_fetch_buffered(
        self, replica: Replica, method: str, path: str, body: bytes
    ) -> Optional[Tuple[int, Dict[str, str], bytes]]:
        """One buffered exchange over a mux stream (None: no mux)."""
        opened = await self._mux_open_with_head(
            replica, method, path, body
        )
        if opened is None:
            return None
        stream, status, headers = opened
        try:
            with tracing.span("upstream_body"):
                payload = await stream.read_body(
                    self.request_timeout, MAX_UPSTREAM_BODY
                )
        except MuxStreamError:
            self._cancel_stream(replica, stream)
            raise
        except UpstreamError:
            self._evict_replica_pool(replica.id)
            raise
        except BaseException:
            self._cancel_stream(replica, stream)
            raise
        return status, headers, payload

    async def _fetch_from(
        self,
        endpoint: str,
        replica: Replica,
        method: str,
        path: str,
        body: bytes,
    ) -> Tuple[int, Dict[str, str], bytes]:
        """One buffered round trip to one replica, with routing
        accounting. Raises UpstreamError on transport failure.
        Prefers a mux stream on the replica's shared connection; on
        the classic path the connection returns to the pool only
        after the body was fully read on an intact, length-framed
        exchange."""
        self._m_routed.labels(replica.id).inc()
        replica.outstanding += 1
        t0 = time.perf_counter()
        try:
            fetched = await self._mux_fetch_buffered(
                replica, method, path, body
            )
            if fetched is not None:
                status, headers, payload = fetched
            else:
                conn, status, headers = await self._upstream_request(
                    replica, method, path, body
                )
                try:
                    with tracing.span("upstream_body"):
                        payload = await _read_body(
                            conn.reader, headers, self.request_timeout
                        )
                except UpstreamError:
                    self._pool.discard(conn)
                    self._evict_replica_pool(replica.id)
                    raise
                except BaseException:
                    # a cancelled leg may leave unread response bytes —
                    # that connection must never serve another request
                    self._pool.discard(conn)
                    raise
                if _reusable(headers):
                    self._pool.release(conn)
                else:
                    self._pool.discard(conn)
        finally:
            replica.outstanding -= 1
        if status == 200:
            self._latencies.setdefault(
                endpoint, deque(maxlen=512)
            ).append(time.perf_counter() - t0)
            if endpoint in ("generate", "completions"):
                self._stamp_first_ok(replica)
        return status, headers, payload

    async def _fetch_with_hedge(
        self,
        endpoint: str,
        replica: Replica,
        method: str,
        path: str,
        body: bytes,
        tried: Set[str],
        fp: Optional[int] = None,
        phase: Optional[str] = None,
    ) -> Tuple[int, Dict[str, str], bytes, Replica]:
        """Dispatch to ``replica``; if the response is still not back
        at the hedge threshold, race a second replica. First success
        wins; the loser is cancelled (closing its connection). The
        returned replica is the one whose response was taken, so the
        caller blames retries/exclusions on the right instance; a
        raised UpstreamError carries ``failed_ids`` naming every
        replica that transport-failed in the race."""
        primary = asyncio.ensure_future(
            self._fetch_from(endpoint, replica, method, path, body)
        )
        threshold = self._hedge_threshold(endpoint)
        if threshold is None:
            status, headers, payload = await primary
            return status, headers, payload, replica
        done, _ = await asyncio.wait({primary}, timeout=threshold)
        if done:
            return (*primary.result(), replica)
        hedge_replica = self._pick(tried | {replica.id}, fp, phase)
        if hedge_replica is None:
            status, headers, payload = await primary
            return status, headers, payload, replica
        self._m_hedged.labels(replica.id).inc()
        log.debug(
            "gateway: hedging %s after %.0fms on %s",
            path, threshold * 1e3, hedge_replica.id,
        )
        hedge = asyncio.ensure_future(
            self._fetch_from(
                endpoint, hedge_replica, method, path, body
            )
        )
        owners = {primary: replica, hedge: hedge_replica}
        pending = {primary, hedge}
        fallback: Optional[Tuple[int, Dict[str, str], bytes, Replica]] = None
        failed_ids: Set[str] = set()
        error: Optional[BaseException] = None
        try:
            while pending:
                done, pending = await asyncio.wait(
                    pending, return_when=asyncio.FIRST_COMPLETED
                )
                for task in done:
                    try:
                        status, headers, payload = task.result()
                    except Exception as exc:
                        # a transport-failed leg is excluded from
                        # future attempts even when the OTHER leg's
                        # response ends up being the one taken
                        failed_ids.add(owners[task].id)
                        tried.add(owners[task].id)
                        error = exc
                        continue
                    if status not in RETRYABLE_STATUSES or not pending:
                        return status, headers, payload, owners[task]
                    # a leg that answered a retryable 503 is excluded
                    # from future attempts too, even if the OTHER
                    # leg's answer wins this race
                    tried.add(owners[task].id)
                    fallback = (status, headers, payload, owners[task])
            if fallback is not None:
                return fallback
            assert error is not None
            error.failed_ids = failed_ids  # type: ignore[attr-defined]
            raise error
        finally:
            for task in (primary, hedge):
                if not task.done():
                    task.cancel()
                    try:
                        await task
                    except asyncio.CancelledError:
                        pass
                    except Exception as exc:
                        # the losing leg's transport error is expected
                        # (we closed its connection); log it so a
                        # systematic failure is still visible
                        log.debug(
                            "gateway: cancelled race leg failed: %s", exc
                        )

    # -- disaggregated prefill/decode handoff ---------------------------

    def _role_members(self, role: str) -> List[Replica]:
        return [
            r for r in self._replicas.values() if r.role == role
        ]

    async def _disagg_prepare(
        self, key: Optional[str], fp: int, row: List[int]
    ) -> Set[str]:
        """Phase-split dispatch: before a generation lands on the
        decode pool, run its prompt through the prefill pool and pull
        the resulting KV prefix onto the decode target replica-to-
        replica (serve.py's /v1/prefill + /v1/kv/pull, the cp-mux/1
        stream in kvtier/handoff.py). The generation that follows
        readmits the prefix through the SAME ``reuse_admission``
        protocol a local spill takes — byte parity by construction —
        so the decode replica never pays the cold prefill that would
        otherwise block its slot engine between decode windows.

        Best-effort by design, the degradation ladder (docs/60):
        either pool empty, the decode target already digest-warm, or
        ANY leg failing (transport, non-200, digest mismatch inside
        the pull) → return and let the routed replica prefill
        locally. Never raises; never surfaces to the client.

        Returns replica ids a leg PROVED unreachable, so the caller's
        routing retry starts with them excluded and their sticky pins
        invalidated (see ``_route``'s ``dead``)."""
        dead: Set[str] = set()
        if not self._role_members(ROLE_PREFILL) or not (
            self._role_members(ROLE_DECODE)
        ):
            # not a disaggregated fleet (or a whole pool died):
            # mixed routing handles everything
            return dead
        # pin the decode target FIRST — the pull must land on the
        # replica the generation will route to, and pinning here is
        # what makes the follow-up _route calls agree with it
        decode = self._route(key, (), fp, phase="decode")
        if decode is None or decode.role == ROLE_PREFILL:
            return dead
        if fp in decode.digest:
            # digest-warm multiturn follow-up: the target already
            # advertises this prefix — route straight to it
            self.handoffs["skipped_warm"] += 1
            return dead
        members = [
            r for r in self._role_members(ROLE_PREFILL)
            if r.id != decode.id
        ]
        if not members:
            return dead
        prefill = min(members, key=lambda r: (r.load, r.id))
        seed = json.dumps({"tokens": [row]}).encode()
        pull = json.dumps(
            {"tokens": [row], "from": prefill.authority}
        ).encode()
        t0 = time.perf_counter()
        moved: Optional[int] = None
        # one named trace stage for the whole transfer: the TTFT cost
        # of disaggregation must be attributable, not smeared into
        # upstream_ttfb (docs/90 § replica.kv_handoff)
        with tracing.span("replica.kv_handoff"):
            # blame a transport failure on whichever leg was in
            # flight: the seed runs against the prefill replica, the
            # pull against the decode target
            leg = prefill
            try:
                status, _, _ = await self._fetch_from(
                    "prefill", prefill, "POST", PREFILL_PATH, seed
                )
                if status == 200:
                    leg = decode
                    status, _, payload = await self._fetch_from(
                        "kv_pull", decode, "POST", KV_PULL_PATH, pull
                    )
                    if status == 200:
                        try:
                            moved = int(
                                json.loads(payload.decode())
                                .get("bytes", 0)
                            )
                        except (ValueError, AttributeError,
                                UnicodeDecodeError):
                            moved = 0
            except UpstreamError as exc:
                dead.add(leg.id)
                log.warning("gateway: kv handoff failed: %s", exc)
        if moved is None:
            self._m_handoff_failed.inc()
            self.handoffs["failed"] += 1
            return dead
        handoff_ms = (time.perf_counter() - t0) * 1e3
        self._m_handoffs.inc()
        self._m_handoff_bytes.inc(moved)
        self._m_handoff_ms.observe(handoff_ms)
        self.handoffs["total"] += 1
        self.handoffs["bytes"] += moved
        self.handoffs["ms_sum"] += handoff_ms
        log.debug(
            "gateway: kv handoff %s -> %s: %d bytes in %.1fms",
            prefill.id, decode.id, moved, handoff_ms,
        )
        return dead

    async def _proxy_buffered(
        self,
        endpoint: str,
        method: str,
        path: str,
        body: bytes,
        key: Optional[str],
        fp: Optional[int] = None,
        phase: Optional[str] = None,
        dead: Optional[Set[str]] = None,
    ) -> Response:
        # replicas a failed handoff already proved unreachable start
        # excluded AND invalidate their sticky pin (see _route)
        dead_ids: Set[str] = set(dead or ())
        tried: Set[str] = set(dead_ids)
        backoff = self.retry_backoff
        last: Optional[Response] = None
        for attempt in range(self.retries + 1):
            replica = self._route(key, tried, fp, phase, dead_ids)
            if replica is None:
                break
            try:
                status, headers, payload, served_by = (
                    await self._fetch_with_hedge(
                        endpoint, replica, method, path, body, tried,
                        fp, phase,
                    )
                )
            except UpstreamError as exc:
                log.warning("gateway: %s failed: %s", endpoint, exc)
                last = self._failure_response(exc)
                failed = (
                    getattr(exc, "failed_ids", None) or {replica.id}
                )
                # a transport failure is PROOF of death for the pin's
                # purposes — later attempts must re-pin, not wait out
                # the catalog poll
                dead_ids |= set(failed)
                backoff = await self._retry_pause(
                    tried, failed, attempt, backoff,
                )
                continue
            if status in RETRYABLE_STATUSES and attempt < self.retries:
                # blame the replica whose response this actually is —
                # under hedging that may be the hedge, not the primary
                last = self._relay(status, headers, payload)
                backoff = await self._drain_bounce(
                    key, served_by.id, headers, tried, attempt,
                    backoff,
                )
                continue
            self._stitch_upstream(headers)
            return self._relay(status, headers, payload)
        return last or Response(
            503, b"no healthy replicas\n",
            headers={"Retry-After": self._retry_after()},
        )

    def _stitch_upstream(self, headers: Dict[str, str]) -> None:
        """Splice the replica's span digest (if the response carried
        one) into the current trace as ``replica.*`` children, aligned
        at the moment this gateway dispatched upstream — the stitched
        timeline without a second RPC."""
        trace = tracing.current_trace()
        if trace is None:
            return
        digest = headers.get("x-cp-span-digest", "")
        if not digest:
            return
        base = trace.last_span_start("upstream_ttfb")
        trace.add_child_digest(
            digest, base if base is not None else trace.started
        )

    def _observe_trace(self, trace: "tracing.Trace") -> None:
        """Mirror a finished trace's spans into the per-stage
        histogram — the aggregate face of the same decomposition."""
        for stage, start, end, _meta in trace.spans:
            self._m_stage.labels(stage).observe(max(end - start, 0.0))

    @staticmethod
    def _relay(
        status: int, headers: Dict[str, str], payload: bytes
    ) -> Response:
        extra = {}
        if "retry-after" in headers:
            extra["Retry-After"] = headers["retry-after"]
        return Response(
            status,
            payload,
            content_type=headers.get(
                "content-type", "text/plain; charset=utf-8"
            ),
            headers=extra,
        )

    async def _proxy_stream(
        self,
        endpoint: str,
        path: str,
        body: bytes,
        key: Optional[str],
        fp: Optional[int] = None,
        phase: Optional[str] = None,
        dead: Optional[Set[str]] = None,
    ) -> Response:
        """SSE relay. Retries/re-routing apply only while nothing has
        been sent downstream; once the upstream stream starts, the
        gateway forwards bytes verbatim until EOF and mirrors client
        disconnects upstream (closing the connection sets the
        replica's cancel path at the next chunk boundary)."""
        dead_ids: Set[str] = set(dead or ())
        tried: Set[str] = set(dead_ids)
        backoff = self.retry_backoff
        last: Optional[Response] = None
        for attempt in range(self.retries + 1):
            replica = self._route(key, tried, fp, phase, dead_ids)
            if replica is None:
                break
            self._m_routed.labels(replica.id).inc()
            # count the stream as outstanding from the CONNECT on, not
            # from first byte: a burst of concurrent streams must not
            # all tie-break onto one replica while none has started
            replica.outstanding += 1
            held = True
            try:
                try:
                    opened = await self._mux_open_with_head(
                        replica, "POST", path, body
                    )
                except UpstreamError as exc:
                    log.warning(
                        "gateway: %s stream failed: %s", endpoint, exc
                    )
                    last = self._failure_response(exc)
                    dead_ids.add(replica.id)  # proven unreachable
                    backoff = await self._retry_pause(
                        tried, {replica.id}, attempt, backoff
                    )
                    continue
                if opened is not None:
                    # mux: this SSE relay is one stream among many on
                    # the replica's shared connection — it no longer
                    # pins a socket for its lifetime, and a client
                    # that hangs up costs a CANCEL frame
                    stream, status, headers = opened
                    if "text/event-stream" not in headers.get(
                        "content-type", ""
                    ):
                        # not a stream: an error body — buffer, relay,
                        # retry the retryable statuses
                        try:
                            payload = await stream.read_body(
                                self.request_timeout, MAX_UPSTREAM_BODY
                            )
                        except UpstreamError as exc:
                            if isinstance(exc, MuxStreamError):
                                self._cancel_stream(replica, stream)
                            else:
                                self._evict_replica_pool(replica.id)
                            log.warning(
                                "gateway: %s body read failed: %s",
                                endpoint, exc,
                            )
                            last = self._failure_response(exc)
                            backoff = await self._retry_pause(
                                tried, {replica.id}, attempt, backoff
                            )
                            continue
                        except BaseException:
                            self._cancel_stream(replica, stream)
                            raise
                        if (
                            status in RETRYABLE_STATUSES
                            and attempt < self.retries
                        ):
                            last = self._relay(status, headers, payload)
                            backoff = await self._drain_bounce(
                                key, replica.id, headers, tried,
                                attempt, backoff,
                            )
                            continue
                        return self._relay(status, headers, payload)
                    held = False  # ownership moves to the relay
                    if status == 200:
                        self._stamp_first_ok(replica)
                    return self._relay_mux_stream(replica, stream, status)
                try:
                    conn, status, headers = await self._upstream_request(
                        replica, "POST", path, body
                    )
                except UpstreamError as exc:
                    log.warning(
                        "gateway: %s stream failed: %s", endpoint, exc
                    )
                    last = self._failure_response(exc)
                    dead_ids.add(replica.id)  # proven unreachable
                    backoff = await self._retry_pause(
                        tried, {replica.id}, attempt, backoff
                    )
                    continue
                content_type = headers.get("content-type", "")
                if "text/event-stream" not in content_type:
                    # not a stream: a 422/503/500 error body (or a
                    # server without --slots) — buffer and relay,
                    # retrying the retryable statuses like the
                    # buffered path
                    try:
                        payload = await _read_body(
                            conn.reader, headers, self.request_timeout
                        )
                    except UpstreamError as exc:
                        self._pool.discard(conn)
                        self._evict_replica_pool(replica.id)
                        log.warning(
                            "gateway: %s body read failed: %s",
                            endpoint, exc,
                        )
                        last = self._failure_response(exc)
                        backoff = await self._retry_pause(
                            tried, {replica.id}, attempt, backoff
                        )
                        continue
                    except BaseException:
                        self._pool.discard(conn)
                        raise
                    if _reusable(headers):
                        self._pool.release(conn)
                    else:
                        self._pool.discard(conn)
                    if (
                        status in RETRYABLE_STATUSES
                        and attempt < self.retries
                    ):
                        last = self._relay(status, headers, payload)
                        backoff = await self._drain_bounce(
                            key, replica.id, headers, tried,
                            attempt, backoff,
                        )
                        continue
                    return self._relay(status, headers, payload)
                held = False  # ownership moves to the relay's close()
                if status == 200:
                    self._stamp_first_ok(replica)
                return self._relay_stream(replica, conn, status)
            finally:
                if held:
                    replica.outstanding -= 1
        return last or Response(
            503, b"no healthy replicas\n",
            headers={"Retry-After": self._retry_after()},
        )

    def _finish_stream_trace(
        self,
        trace: Optional["tracing.Trace"],
        relay_t0: float,
        tail: bytearray,
        status: int,
        intact: bool,
    ) -> None:
        """Shared relay-close tail for both stream transports: record
        the relay span, splice the replica digest off the final SSE
        ``done`` frame (the stream's version of the digest header),
        finish the trace, feed the stage histogram."""
        if trace is None:
            return
        trace.add_span("relay", relay_t0, tracing.now())
        digest = _tail_digest(bytes(tail))
        if digest:
            base = trace.last_span_start("upstream_ttfb")
            trace.add_child_digest(
                digest, base if base is not None else trace.started
            )
        trace.finish(status if intact else 0)
        self._observe_trace(trace)

    def _relay_stream(
        self,
        replica: Replica,
        conn: PooledConnection,
        status: int,
    ) -> StreamingResponse:
        """Relay an upstream SSE stream; the caller's outstanding
        count transfers here and is released by close(). Streams are
        close-delimited, so the connection never returns to the pool
        — close() discards it."""
        closed = [False]
        # whether the relay ended on an intact upstream (clean EOF vs
        # transport death): read by the admission-ticket release so a
        # fleet whose streams keep dying doesn't feed the drain-rate
        # window with phantom completions
        intact = {"ok": True}
        trace = tracing.current_trace()
        relay_t0 = tracing.now()
        tail = bytearray()

        def close() -> None:
            # idempotent: generator-finally AND the response's close
            # callback both fire on some paths
            if closed[0]:
                return
            closed[0] = True
            replica.outstanding -= 1
            self._pool.discard(conn)
            self._finish_stream_trace(
                trace, relay_t0, tail, status, intact["ok"]
            )

        async def chunks():
            try:
                while True:
                    chunk = await timed_read(
                        conn.reader,
                        conn.reader.read(65536),
                        self.request_timeout,
                    )
                    if not chunk:
                        return
                    if trace is not None:
                        _keep_tail(tail, chunk)
                    yield chunk
            except (OSError, asyncio.TimeoutError):
                # upstream died mid-stream; downstream sees EOF
                intact["ok"] = False
                return
            finally:
                close()

        resp = StreamingResponse(chunks(), status=status, close=close)
        resp.upstream_intact = intact  # type: ignore[attr-defined]
        return resp

    def _relay_mux_stream(
        self,
        replica: Replica,
        stream: MuxStream,
        status: int,
    ) -> StreamingResponse:
        """Relay an upstream SSE stream carried as a mux stream. The
        caller's outstanding count transfers here and is released by
        close(). Where the HTTP/1.1 relay discarded its (close-
        delimited) connection on every close, this one frees only the
        stream: an abandoned client turns into a CANCEL frame and the
        shared connection keeps serving its co-resident streams —
        both paths count into conns_saved_by_mux."""
        closed = [False]
        intact = {"ok": True}
        trace = tracing.current_trace()
        relay_t0 = tracing.now()
        tail = bytearray()

        def close() -> None:
            # idempotent: generator-finally AND the response's close
            # callback both fire on some paths
            if closed[0]:
                return
            closed[0] = True
            replica.outstanding -= 1
            if stream.cancel():
                # the downstream client abandoned mid-stream: CANCEL
                # frees the stream id upstream, nothing is torn down
                self._m_mux_cancels.labels(replica.id).inc()
                self._m_conns_saved.labels(replica.id).inc()
            elif intact["ok"]:
                # completed cleanly: the close-delimited HTTP/1.1
                # relay would have burned this connection instead
                self._m_conns_saved.labels(replica.id).inc()
            self._finish_stream_trace(
                trace, relay_t0, tail, status, intact["ok"]
            )

        async def chunks():
            try:
                while True:
                    chunk = await stream.read_chunk(self.request_timeout)
                    if not chunk:
                        return
                    if trace is not None:
                        _keep_tail(tail, chunk)
                    yield chunk
            except MuxStreamError:
                # this stream died (deadline, server-side abort); the
                # connection is fine — downstream sees EOF
                intact["ok"] = False
                return
            except UpstreamError:
                # the shared connection died mid-relay
                intact["ok"] = False
                self._evict_replica_pool(replica.id)
                return
            finally:
                close()

        resp = StreamingResponse(chunks(), status=status, close=close)
        resp.upstream_intact = intact  # type: ignore[attr-defined]
        return resp


def main() -> int:
    """Run a standalone gateway:
    ``python -m containerpilot_tpu_torch.fleet --catalog file:/shared/catalog``
    """
    import argparse
    import logging as logging_mod
    import signal as signal_mod

    from ..discovery.factory import new_backend

    parser = argparse.ArgumentParser(
        description="inference fleet gateway"
    )
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=8800)
    parser.add_argument(
        "--catalog", required=True,
        help="discovery backend URI, as the supervisor's 'consul' "
        "config key: 'file:/shared/catalog' or 'consul:8500'",
    )
    parser.add_argument("--service", default="inference")
    parser.add_argument("--tag", default="")
    parser.add_argument("--poll-interval", type=float, default=1.0)
    parser.add_argument("--retries", type=int, default=2)
    parser.add_argument(
        "--retry-jitter", type=float, default=0.5,
        help="fraction of each retry backoff randomized (0 disables; "
        "desynchronizes retry storms after a replica dies under load)",
    )
    parser.add_argument(
        "--empty-poll-threshold", type=int, default=3,
        help="consecutive empty catalog polls before a previously "
        "non-empty routing table is dropped (flap hold-down)",
    )
    parser.add_argument(
        "--affinity", choices=AFFINITY_MODES, default="session"
    )
    parser.add_argument(
        "--cache-routing", default=True,
        action=argparse.BooleanOptionalAction,
        help="cache-contents-aware routing: when a request has no "
        "live sticky pin, prefer a replica whose advertised prefix "
        "digest contains the request's fingerprint (--no-cache-"
        "routing keeps pure sticky + least-outstanding)",
    )
    parser.add_argument(
        "--cache-slack", type=int, default=2,
        help="extra load a cache-warm replica may carry over the "
        "least-loaded candidate and still win the pick (0 = warmth "
        "only ever breaks exact load ties)",
    )
    parser.add_argument(
        "--sticky-capacity", type=int, default=STICKY_CAPACITY,
        help="LRU bound on sticky-affinity pins; evictions count on "
        "/metrics (sticky_evicted)",
    )
    parser.add_argument(
        "--hedge-after-ms", type=float, default=None,
        help="fixed hedge deadline; default learns the tail quantile",
    )
    parser.add_argument("--no-hedge", action="store_true")
    parser.add_argument(
        "--pool-max-idle", type=int, default=8,
        help="idle keep-alive connections kept per replica "
        "(0 disables reuse: every request dials)",
    )
    parser.add_argument(
        "--pool-idle-ttl", type=float, default=30.0,
        help="seconds an idle pooled connection stays reusable",
    )
    parser.add_argument(
        "--no-pool", action="store_true",
        help="shorthand for --pool-max-idle 0",
    )
    parser.add_argument(
        "--mux", default=True, action=argparse.BooleanOptionalAction,
        help="carry replica traffic as interleaved cp-mux/1 streams "
        "on one warm connection per replica (--no-mux forces the "
        "classic one-request-per-connection pooled path; replicas "
        "that decline the upgrade fall back per-replica either way)",
    )
    parser.add_argument(
        "--trace", default=True, action=argparse.BooleanOptionalAction,
        help="per-request cross-hop tracing (X-CP-Trace propagation, "
        "/v1/traces, cp_request_stage_seconds): on by default and "
        "effectively free (bench-pinned); --no-trace is the bench's "
        "A/B control",
    )
    parser.add_argument(
        "--admission-queue-depth", type=int, default=256,
        help="bounded admission queue in front of routing; a full "
        "queue sheds new work with 429 + Retry-After",
    )
    parser.add_argument(
        "--admission-high-water", type=int, default=None,
        help="queue depth past which BATCH-priority requests shed "
        "(default: half the queue)",
    )
    parser.add_argument(
        "--admission-deadline-ms", type=float, default=None,
        help="TTFT budget for queued work: a request still queued "
        "this long is 504'd without dispatching (default: none; "
        "clients can pass X-TTFT-SLO-Ms per request)",
    )
    parser.add_argument(
        "--per-replica-inflight", type=int, default=64,
        help="dispatch-slot capacity contributed per healthy replica",
    )
    parser.add_argument(
        "--session-rate", type=float, default=0.0,
        help="per-session token-bucket rate (requests/s; 0 disables)",
    )
    parser.add_argument(
        "--session-burst", type=float, default=None,
        help="per-session bucket burst (default: 2x rate)",
    )
    parser.add_argument(
        "--drain-window", type=float, default=30.0,
        help="seconds SIGTERM waits for queued + in-flight requests "
        "before the gateway exits",
    )
    args = parser.parse_args()

    logging_mod.basicConfig(
        level=logging_mod.INFO, format="%(asctime)s %(name)s %(message)s"
    )
    backend = new_backend(args.catalog)
    if backend is None:
        raise SystemExit("--catalog resolved to no discovery backend")
    gateway = FleetGateway(
        backend, args.service, args.host, args.port,
        tag=args.tag, poll_interval=args.poll_interval,
        retries=args.retries, retry_jitter=args.retry_jitter,
        empty_poll_threshold=args.empty_poll_threshold,
        affinity=args.affinity,
        cache_routing=args.cache_routing,
        cache_slack=args.cache_slack,
        sticky_capacity=args.sticky_capacity,
        hedge=not args.no_hedge, hedge_after_ms=args.hedge_after_ms,
        pool_max_idle=0 if args.no_pool else args.pool_max_idle,
        pool_idle_ttl=args.pool_idle_ttl,
        mux=args.mux,
        trace=args.trace,
        admission=dict(
            max_queue_depth=args.admission_queue_depth,
            high_water=args.admission_high_water,
            deadline_s=(
                args.admission_deadline_ms / 1e3
                if args.admission_deadline_ms is not None else None
            ),
            per_replica_inflight=args.per_replica_inflight,
            session_rate=args.session_rate,
            session_burst=args.session_burst,
        ),
    )

    async def serve() -> None:
        await gateway.run()
        stop = asyncio.Event()
        loop = asyncio.get_event_loop()
        for sig in (signal_mod.SIGTERM, signal_mod.SIGINT):
            loop.add_signal_handler(sig, stop.set)
        await stop.wait()
        # graceful: new work bounces with 503 + Retry-After while
        # queued + in-flight requests finish under the drain window
        await gateway.drain(args.drain_window)
        await gateway.stop()

    asyncio.run(serve())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
