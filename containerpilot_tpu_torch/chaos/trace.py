"""Trace-driven workload generation for the chaos harness (the port's
own copy of ``containerpilot_tpu/chaos/trace.py``: the same seed gives
the same trace, request for request).

Scenario diversity used to be whatever each test constructed by hand:
uniform arrivals, one prompt shape, no cancellations. Real multi-tenant
serving traffic looks nothing like that, and the failure modes the
fleet must survive (retry storms, hedges firing into a burst, a drain
racing a long-tail generation) only show up under realistic load. This
module generates that load deterministically:

- **Multi-tenant chat sessions with shared prefixes.** Each tenant has
  a system-prompt prefix and each session extends it; successive turns
  of a session share the session prefix (what prefix caches and sticky
  affinity exist for). Requests carry ``session_id`` so the gateway's
  affinity path is exercised, not bypassed.
- **Bursty Poisson arrivals.** A two-state modulated Poisson process
  (quiet/burst, exponential dwell times): inter-arrival gaps are
  exponential at ``mean_rps`` in the quiet state and ``mean_rps *
  burst_factor`` inside bursts. Fleet-killing load is bursty load; a
  constant-rate generator never synchronizes retries.
- **Long-tail lengths.** Prompt and output lengths are lognormal
  (capped), so a few requests decode for much longer than the median —
  the rows a drain or kill is most likely to catch in flight.
- **Abandoned streams.** A fraction of streaming requests hang up
  mid-stream after a few events, driving the replica's cancel path and
  the gateway's mid-stream disconnect relay.

Everything derives from one ``random.Random(seed)``: the same seed
yields byte-identical traces (arrival times, token ids, per-request
seeds), so every chaos run is reproducible and every regression is
replayable.
"""
from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Any, Dict, List, Optional


@dataclass(frozen=True)
class TraceConfig:
    """Knobs for one generated trace. Defaults fit the tiny CPU-lab
    model (vocab 64, max_len 64) the scenario harness boots."""

    seed: int = 0
    duration_s: float = 4.0
    mean_rps: float = 10.0
    burst_factor: float = 4.0
    #: mean dwell (seconds) in the quiet / burst arrival states
    quiet_dwell_s: float = 1.0
    burst_dwell_s: float = 0.4
    tenants: int = 3
    sessions_per_tenant: int = 3
    #: lognormal prompt/output length parameters (median, sigma)
    prompt_median: int = 8
    prompt_sigma: float = 0.6
    output_median: int = 6
    output_sigma: float = 0.5
    #: hard caps so a tail sample can't exceed the model's max_len
    max_prompt: int = 24
    max_output: int = 16
    #: prompt lengths snap UP to a multiple of this. Static-shape
    #: serving compiles one prefill program per distinct prompt
    #: length; quantizing keeps a scenario's compile set bounded (the
    #: harness pre-warms each bucket) while the lognormal tail still
    #: spreads requests across buckets. 0 disables snapping.
    prompt_quantum: int = 8
    #: shared-prefix structure: tenant prefix + per-session extension
    tenant_prefix: int = 4
    session_prefix: int = 4
    stream_fraction: float = 0.25
    #: of the streaming requests, how many hang up mid-stream
    abandon_fraction: float = 0.3
    #: fraction of requests tagged batch priority (X-Priority: batch)
    #: — the work admission control sheds FIRST in a burst. 0 draws
    #: nothing from the rng, so existing traces stay byte-identical.
    batch_fraction: float = 0.0
    vocab: int = 64
    #: multi-turn chat mode: each session is a CONVERSATION — turn
    #: k+1's prompt is turn k's prompt plus a simulated assistant
    #: reply plus fresh user tokens, so successive turns share an
    #: ever-growing prefix (what the KV spill tier and cache-aware
    #: routing exist for). False draws nothing from the rng, so
    #: pre-existing traces replay byte-identically.
    multiturn: bool = False
    turns_per_session: int = 4
    #: mean exponential think time between a turn's arrival and the
    #: next turn of the same session
    think_time_s: float = 0.35
    #: hard floor under every think gap (the exponential puts heavy
    #: mass near zero, where turn k+1 would arrive before turn k even
    #: completes — real users read the answer first)
    think_floor_s: float = 0.0
    #: first-turn prompt floor: at least this many ids, so the shared
    #: prefix clears the reuse threshold (serve_prefix.MIN_REUSE)
    #: from turn 2 on
    first_turn_min: int = 16
    #: simulated assistant-reply ids appended to the history per turn
    reply_median: int = 4


@dataclass
class TraceRequest:
    """One request in a trace: everything the load generator needs to
    issue it and everything the scorer needs to judge it."""

    index: int
    at_s: float
    session_id: str
    tenant: int
    tokens: List[int]
    max_new_tokens: int
    seed: int
    stream: bool = False
    #: for streams: hang up after this many SSE data events (None =
    #: read to completion)
    abandon_after_events: Optional[int] = None
    in_burst: bool = False
    #: admission priority class ("interactive" | "batch"), sent as
    #: the X-Priority header
    priority: str = "interactive"

    def payload(self) -> Dict[str, Any]:
        body: Dict[str, Any] = {
            "tokens": [self.tokens],
            "max_new_tokens": self.max_new_tokens,
            "seed": self.seed,
            "session_id": self.session_id,
        }
        if self.stream:
            body["stream"] = True
        return body


def _lognormal_len(
    rng: random.Random, median: int, sigma: float, lo: int, hi: int
) -> int:
    """A capped lognormal sample: median * e^(sigma * N(0,1))."""
    value = int(round(median * rng.lognormvariate(0.0, sigma)))
    return max(lo, min(hi, value))


def generate_trace(cfg: TraceConfig) -> List[TraceRequest]:
    """Generate the full request list for one scenario run, sorted by
    arrival time. Pure function of ``cfg`` (seed included)."""
    rng = random.Random(cfg.seed)
    # per-tenant and per-session shared prefixes, fixed for the trace
    tenant_prefixes = [
        [rng.randrange(1, cfg.vocab) for _ in range(cfg.tenant_prefix)]
        for _ in range(cfg.tenants)
    ]
    session_prefixes: Dict[str, List[int]] = {}
    for tenant in range(cfg.tenants):
        for s in range(cfg.sessions_per_tenant):
            session_prefixes[f"t{tenant}-s{s}"] = tenant_prefixes[
                tenant
            ] + [rng.randrange(1, cfg.vocab) for _ in range(cfg.session_prefix)]

    if cfg.multiturn:
        return _generate_multiturn(cfg, rng, session_prefixes)

    requests: List[TraceRequest] = []
    now = 0.0
    in_burst = False
    state_until = rng.expovariate(1.0 / cfg.quiet_dwell_s)
    index = 0
    while now < cfg.duration_s:
        rate = cfg.mean_rps * (cfg.burst_factor if in_burst else 1.0)
        now += rng.expovariate(rate)
        while now > state_until:
            in_burst = not in_burst
            dwell = cfg.burst_dwell_s if in_burst else cfg.quiet_dwell_s
            state_until += rng.expovariate(1.0 / dwell)
        if now >= cfg.duration_s:
            break
        tenant = rng.randrange(cfg.tenants)
        session = f"t{tenant}-s{rng.randrange(cfg.sessions_per_tenant)}"
        prefix = session_prefixes[session]
        fresh = _lognormal_len(
            rng, cfg.prompt_median, cfg.prompt_sigma,
            1, max(1, cfg.max_prompt - len(prefix)),
        )
        total = len(prefix) + fresh
        if cfg.prompt_quantum > 0:
            q = cfg.prompt_quantum
            total = min(-(-total // q) * q, cfg.max_prompt)
            total = max(total, len(prefix) + 1)
        tokens = prefix + [
            rng.randrange(1, cfg.vocab)
            for _ in range(total - len(prefix))
        ]
        max_new = _lognormal_len(
            rng, cfg.output_median, cfg.output_sigma, 1, cfg.max_output
        )
        stream = rng.random() < cfg.stream_fraction
        abandon: Optional[int] = None
        if stream and rng.random() < cfg.abandon_fraction:
            abandon = 1 + rng.randrange(2)
        # guarded draw: batch_fraction == 0 consumes no randomness,
        # so pre-existing scenario traces replay byte-identically
        priority = "interactive"
        if cfg.batch_fraction > 0 and rng.random() < cfg.batch_fraction:
            priority = "batch"
        requests.append(
            TraceRequest(
                index=index,
                at_s=round(now, 6),
                session_id=session,
                tenant=tenant,
                tokens=tokens,
                max_new_tokens=max_new,
                seed=cfg.seed * 100003 + index,
                stream=stream,
                abandon_after_events=abandon,
                in_burst=in_burst,
                priority=priority,
            )
        )
        index += 1
    return requests


def _generate_multiturn(
    cfg: TraceConfig,
    rng: random.Random,
    session_prefixes: Dict[str, List[int]],
) -> List[TraceRequest]:
    """Multi-turn chat sessions: each turn re-sends the whole
    conversation so far (prior prompt + a simulated assistant reply)
    plus fresh user tokens, the regime where prefix KV reuse pays.
    The simulated reply STANDS IN for the model's actual output — the
    replica never checks that history matches what it generated, and
    the trace must be a pure function of the seed. Session starts
    spread over the first ``duration_s``; turns follow their
    predecessor by an exponential think time. Prompt growth stops at
    ``max_prompt`` (the conversation is truncated, like a real
    context-window limit); quantization pads with EXTRA user ids so
    the prefix-of-its-successor property always holds."""
    requests: List[TraceRequest] = []
    index = 0
    for session in sorted(session_prefixes):
        tenant = int(session[1:].split("-", 1)[0])
        history = list(session_prefixes[session])
        # first turn: pad with user ids up to the reuse floor, then
        # quantize UP (appending keeps every prefix shared)
        first = max(
            cfg.first_turn_min,
            len(history) + 1,
        )
        if cfg.prompt_quantum > 0:
            q = cfg.prompt_quantum
            first = min(-(-first // q) * q, cfg.max_prompt)
        while len(history) < first:
            history.append(rng.randrange(1, cfg.vocab))
        at_s = rng.uniform(0.0, cfg.duration_s)
        for _turn in range(cfg.turns_per_session):
            max_new = _lognormal_len(
                rng, cfg.output_median, cfg.output_sigma,
                1, cfg.max_output,
            )
            stream = rng.random() < cfg.stream_fraction
            abandon: Optional[int] = None
            if stream and rng.random() < cfg.abandon_fraction:
                abandon = 1 + rng.randrange(2)
            priority = "interactive"
            if (
                cfg.batch_fraction > 0
                and rng.random() < cfg.batch_fraction
            ):
                priority = "batch"
            requests.append(
                TraceRequest(
                    index=index,
                    at_s=round(at_s, 6),
                    session_id=session,
                    tenant=tenant,
                    tokens=list(history),
                    max_new_tokens=max_new,
                    seed=cfg.seed * 100003 + index,
                    stream=stream,
                    abandon_after_events=abandon,
                    priority=priority,
                )
            )
            index += 1
            # grow the conversation: simulated reply + next user turn
            reply = _lognormal_len(
                rng, cfg.reply_median, cfg.output_sigma, 1,
                cfg.max_output,
            )
            user = _lognormal_len(
                rng, cfg.prompt_median, cfg.prompt_sigma, 1,
                cfg.max_prompt,
            )
            total = len(history) + reply + user
            if cfg.prompt_quantum > 0:
                q = cfg.prompt_quantum
                total = -(-total // q) * q
            if total > cfg.max_prompt:
                break  # context window full: the conversation ends
            while len(history) < total:
                history.append(rng.randrange(1, cfg.vocab))
            at_s += cfg.think_floor_s + rng.expovariate(
                1.0 / cfg.think_time_s
            )
    requests.sort(key=lambda r: (r.at_s, r.index))
    # re-index in arrival order so index stays the replay handle;
    # per-request seeds were already assigned deterministically
    for i, req in enumerate(requests):
        req.index = i
    return requests


def trace_summary(requests: List[TraceRequest]) -> Dict[str, Any]:
    """Shape of a trace for reports and determinism checks."""
    if not requests:
        return {
            "requests": 0, "streams": 0, "batch": 0, "abandons": 0,
            "burst_requests": 0, "sessions": 0,
            "max_prompt_len": 0, "max_new_total": 0,
        }
    return {
        "requests": len(requests),
        "streams": sum(1 for r in requests if r.stream),
        "batch": sum(1 for r in requests if r.priority == "batch"),
        "abandons": sum(
            1 for r in requests if r.abandon_after_events is not None
        ),
        "burst_requests": sum(1 for r in requests if r.in_burst),
        "sessions": len({r.session_id for r in requests}),
        "max_prompt_len": max(len(r.tokens) for r in requests),
        "max_new_total": sum(r.max_new_tokens for r in requests),
    }
