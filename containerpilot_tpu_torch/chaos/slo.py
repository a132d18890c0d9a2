"""SLO accounting and the goodput metric for chaos scenarios (the port's
own copy of ``containerpilot_tpu/chaos/slo.py``).

Raw QPS is the wrong yardstick for a fleet under fire: a gateway that
answers every request with a fast 503 has great QPS and zero value.
Following the ML-fleet-efficiency framing (PAPERS.md: "ML Productivity
Goodput"), the harness scores **goodput** — useful work that met its
SLOs per unit wall time:

- **TTFT** (time to first token): request start to the first response
  byte (buffered) or first SSE data event (streams).
- **TPOT** (time per output token): residual stream time divided by
  the tokens after the first — the decode-rate half of the SLO.
- A request is **good** when it returned 200, met both SLO bounds,
  and was not truncated by a transport fault. Abandoned streams are
  the client's choice, not a failure: they are good if the events
  delivered before the hangup met TTFT.
- A request is **shed** when admission control refused it honestly —
  a final 429 (overload/session shed) or 504 (queued past its TTFT
  deadline) carrying a Retry-After. Sheds are the overload design
  WORKING, not the fleet failing: they are never good, but they are
  counted apart from 5xx failures and excluded from the failure
  ledger. ``goodput_fraction_admitted`` judges serving quality over
  the requests the fleet accepted **on first contact** (no shed, no
  client retry): their latency is bounded by the admission deadline
  plus service time, so the metric isolates the fleet's serving
  discipline from the (wall-clock-noisy) shed-retry dance, which is
  already accounted under ``sheds``/``client_retries``.

``goodput_rps`` = good requests / wall seconds; ``goodput_fraction``
= good / issued. 5xx counts are tracked separately because several
invariants pin them to exactly zero.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from ..telemetry.tracing import dominant_stage


@dataclass
class SLO:
    """Per-request latency bounds a scenario scores against. The
    defaults fit the tiny CPU-lab model the harness boots: its decode
    is milliseconds per token, so an entire quick scenario clears
    them unless a fault actually bites."""

    ttft_s: float = 2.0
    tpot_s: float = 0.5


@dataclass
class RequestRecord:
    """Outcome of one trace request, as the load generator observed it."""

    index: int
    session_id: str
    started_s: float
    finished_s: float
    status: int = 0
    ttft_s: Optional[float] = None
    tokens_out: int = 0
    stream: bool = False
    abandoned: bool = False
    #: transport-level failure talking to the GATEWAY (connection
    #: refused/reset): counted as bad, distinctly from a 5xx answer
    error: str = ""
    #: a stream that started but ended without its terminal event and
    #: without the client hanging up (upstream died mid-relay)
    truncated: bool = False
    #: final answer was an honest overload refusal (429/504 with
    #: Retry-After): counted apart from failures
    shed: bool = False
    #: the last response carried a Retry-After header
    retry_after_quoted: bool = False
    #: Retry-After-honoring re-sends the client performed
    client_retries: int = 0
    #: ANY attempt answered a non-shed 5xx (e.g. a 503 later retried
    #: to a 200): still client-VISIBLE, so zero-5xx invariants count
    #: it — polite client retries must not mask a gateway regression
    saw_5xx: bool = False
    #: trace id the gateway stamped on the final answer (X-CP-Trace):
    #: the handle that finds this request in /v1/traces and in
    #: trace-id-correlated logs, refusals included
    trace_id: str = ""
    #: per-stage seconds from the final answer's span digest
    #: (admission_queue_wait, upstream_ttfb, replica.decode, ...) —
    #: Retry-After parking is folded into admission_queue_wait by the
    #: client, since both are admission-imposed wait
    stages: Dict[str, float] = field(default_factory=dict)

    def tpot(self) -> Optional[float]:
        if self.ttft_s is None or self.tokens_out <= 1:
            return None
        span = (self.finished_s - self.started_s) - self.ttft_s
        return max(span, 0.0) / (self.tokens_out - 1)

    def is_good(self, slo: SLO) -> bool:
        if self.error or self.truncated or self.shed:
            return False
        if self.status != 200:
            return False
        if self.ttft_s is None or self.ttft_s > slo.ttft_s:
            return False
        if self.abandoned:
            # the client hung up by choice: judge only TTFT — a TPOT
            # over the tiny delivered window is noise, not decode rate
            return True
        tpot = self.tpot()
        return tpot is None or tpot <= slo.tpot_s

    def violation_class(self, slo: SLO) -> Optional[str]:
        """Which SLO this request violated — the triage ledger's
        grouping key — or None for good requests and honest sheds.
        One class per record, checked in failure-severity order (a
        transport error that ALSO missed TTFT is a transport error)."""
        if self.shed or self.is_good(slo):
            return None
        if self.error:
            return "transport"
        if self.truncated:
            return "truncated"
        if self.status != 200:
            return "5xx" if 500 <= self.status <= 599 else "bad_status"
        if self.ttft_s is None or self.ttft_s > slo.ttft_s:
            return "ttft"
        return "tpot"


def percentile(values: List[float], q: float) -> Optional[float]:
    """Nearest-rank percentile, deterministic and dependency-free."""
    if not values:
        return None
    ordered = sorted(values)
    idx = min(int(q * len(ordered)), len(ordered) - 1)
    return ordered[idx]


@dataclass
class ScenarioScore:
    """Aggregated scenario outcome; ``as_dict`` is the JSON report."""

    records: List[RequestRecord]
    wall_s: float
    slo: SLO = field(default_factory=SLO)

    def as_dict(self) -> Dict[str, Any]:
        records = self.records
        good = [r for r in records if r.is_good(self.slo)]
        sheds = [r for r in records if r.shed]
        # first-contact admissions: no shed, no Retry-After retry —
        # the set whose latency the fleet fully controls
        first_contact = [
            r for r in records
            if not r.shed and r.client_retries == 0
        ]
        good_first = [r for r in first_contact if r.is_good(self.slo)]
        # latency percentiles describe SERVING, so a shed's
        # millisecond-fast refusal must not drag them down
        ttfts = [
            r.ttft_s
            for r in records
            if r.ttft_s is not None and not r.shed
        ]
        tpots = [t for r in records if (t := r.tpot()) is not None]
        statuses: Dict[str, int] = {}
        for r in records:
            key = str(r.status) if not r.error else "error"
            statuses[key] = statuses.get(key, 0) + 1
        wall = max(self.wall_s, 1e-9)
        return {
            "requests": len(records),
            "good": len(good),
            "goodput_rps": round(len(good) / wall, 3),
            "goodput_fraction": round(
                len(good) / len(records), 4
            ) if records else None,
            # serving quality over first-contact admissions: the
            # number burst invariants gate on while sheds absorb the
            # overload
            "goodput_fraction_admitted": round(
                len(good_first) / len(first_contact), 4
            ) if first_contact else None,
            "sheds": len(sheds),
            "shed_429": sum(1 for r in sheds if r.status == 429),
            "shed_504": sum(1 for r in sheds if r.status == 504),
            "client_retries": sum(r.client_retries for r in records),
            "wall_s": round(self.wall_s, 3),
            "slo": {"ttft_s": self.slo.ttft_s, "tpot_s": self.slo.tpot_s},
            "ttft_ms": {
                "p50": _ms(percentile(ttfts, 0.50)),
                "p95": _ms(percentile(ttfts, 0.95)),
                "p99": _ms(percentile(ttfts, 0.99)),
            },
            "tpot_ms": {
                "p50": _ms(percentile(tpots, 0.50)),
                "p95": _ms(percentile(tpots, 0.95)),
                "p99": _ms(percentile(tpots, 0.99)),
            },
            "statuses": dict(sorted(statuses.items())),
            # sheds (an honest 504 at the admission deadline) are the
            # overload defense working; 5xx here means FAILURE — and a
            # 5xx ANY attempt saw counts even when a polite retry
            # turned the final answer into a 200
            "count_5xx": sum(
                1 for r in records
                if r.saw_5xx
                or (500 <= r.status <= 599 and not r.shed)
            ),
            "transport_errors": sum(1 for r in records if r.error),
            "truncated_streams": sum(1 for r in records if r.truncated),
            "abandoned_streams": sum(1 for r in records if r.abandoned),
            "tokens_out": sum(r.tokens_out for r in records),
            # triage ledger: the first few non-good requests with
            # enough detail to replay them (trace index + session)
            # AND to blame them — the gateway trace id, the per-stage
            # latency breakdown off the span digest, and the stage
            # that dominated ("goodput dropped" becomes "goodput
            # dropped HERE")
            "failures": [
                {
                    "index": r.index,
                    "session": r.session_id,
                    "status": r.status,
                    "error": r.error,
                    "ttft_ms": _ms(r.ttft_s),
                    "truncated": r.truncated,
                    "class": r.violation_class(self.slo),
                    "trace": r.trace_id,
                    "stages_ms": {
                        stage: _ms(dur)
                        for stage, dur in sorted(r.stages.items())
                    },
                    "dominant_stage": dominant_stage(r.stages),
                }
                for r in records
                if not r.is_good(self.slo)
                and not r.abandoned
                and not r.shed
            ][:8],
            # the aggregate face of the same blame: per violation
            # class, the stage that ate the violated requests' time
            "stage_attribution": self._stage_attribution(),
        }

    def _stage_attribution(self) -> Dict[str, Dict[str, Any]]:
        """Per violation class: how many requests, the summed
        per-stage seconds across them, and the DOMINANT stage (the
        refinement discipline lives in tracing.dominant_stage: nested
        ``replica.*`` spans refine their upstream window rather than
        double-count it). The scenario report names this stage, and
        scenario specs can pin it (``expect_dominant_stage``)."""
        buckets: Dict[str, List[RequestRecord]] = {}
        for record in self.records:
            cls = record.violation_class(self.slo)
            if cls is not None:
                buckets.setdefault(cls, []).append(record)
        out: Dict[str, Dict[str, Any]] = {}
        for cls, violated in sorted(buckets.items()):
            totals: Dict[str, float] = {}
            traced = 0
            for record in violated:
                if record.stages:
                    traced += 1
                for stage, dur in record.stages.items():
                    totals[stage] = totals.get(stage, 0.0) + dur
            out[cls] = {
                "count": len(violated),
                "with_stage_data": traced,
                "dominant": dominant_stage(totals),
                "stages_ms": {
                    stage: _ms(dur)
                    for stage, dur in sorted(totals.items())
                },
            }
        return out


def _ms(seconds: Optional[float]) -> Optional[float]:
    return None if seconds is None else round(seconds * 1e3, 2)
