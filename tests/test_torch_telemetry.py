"""The port's telemetry (telemetry/tracing.py, telemetry/goodput.py,
utils/prom.py, analysis/loopcheck.py) against the JAX package's: mirrors
of tests/test_tracing.py:21-360 and tests/test_goodput.py:61-416 run on
the port's copies, and the same inputs give the same digests, notes,
payload keys and Prometheus exposition in both packages."""
import asyncio
import http.client
import json
import urllib.error
import urllib.request

import numpy as np
import pytest

from containerpilot_tpu.telemetry import goodput as ref_goodput
from containerpilot_tpu.telemetry import tracing as ref_tracing
from containerpilot_tpu_torch.telemetry import goodput, tracing
from containerpilot_tpu_torch.telemetry.goodput import (
    NOTE_FIELDS,
    STAGES,
    DeviceTimeLedger,
    find_scheduling_gaps,
    merge_note_max,
    parse_note,
    productive_fraction,
    sum_stage_totals,
)
from containerpilot_tpu_torch.utils import prom

# -- tracing: recorder retention ---------------------------------------


def test_recent_ring_evicts_oldest():
    rec = tracing.TraceRecorder("t", recent=3, slowest=2)
    ids = []
    for _ in range(5):
        trace = rec.start(endpoint="e")
        ids.append(trace.trace_id)
        trace.finish(200)
    assert rec.recorded == 5
    assert [t.trace_id for t in rec.recent()] == ids[-1:-4:-1]


def test_slowest_board_keeps_the_slow_ones():
    rec = tracing.TraceRecorder("t", recent=2, slowest=2)
    durations = {}
    for ms in (5, 50, 1, 20):
        trace = rec.start(endpoint="e")
        trace.started -= ms / 1e3
        trace.finish(200)
        durations[trace.trace_id] = ms
    assert [durations[t.trace_id] for t in rec.slowest()] == [50, 20]
    assert [durations[t.trace_id] for t in rec.recent()] == [20, 1]


def test_finish_is_idempotent_and_records_once():
    rec = tracing.TraceRecorder("t")
    trace = rec.start(endpoint="e")
    trace.finish(429)
    trace.finish(200)
    assert rec.recorded == 1
    assert rec.recent()[0].status == 429
    assert rec.find(trace.trace_id)


def test_refused_trace_is_findable_with_zero_spans():
    rec = tracing.TraceRecorder("replica")
    trace = rec.start(trace_id="cafe0123cafe0123", endpoint="generate")
    trace.finish(503)
    found = rec.find("cafe0123cafe0123")
    assert found and found[0].spans == []


# -- tracing: spans and context ----------------------------------------


def test_span_cap_bounds_memory():
    trace = tracing.TraceRecorder("t").start(endpoint="e")
    for _ in range(tracing.MAX_SPANS * 2):
        trace.add_span("s", 0.0, 1.0)
    assert len(trace.spans) == tracing.MAX_SPANS


def test_contextvar_isolation_across_concurrent_tasks(run):
    rec = tracing.TraceRecorder("t")

    async def worker(name, trace):
        token = tracing.activate(trace)
        try:
            assert tracing.current_trace_id() == trace.trace_id
            with tracing.span(f"stage_{name}"):
                await asyncio.sleep(0.01)
            with tracing.span(f"stage_{name}_2"):
                await asyncio.sleep(0.005)
        finally:
            tracing.deactivate(token)

    async def scenario():
        t_a, t_b = rec.start(endpoint="a"), rec.start(endpoint="b")
        await asyncio.gather(asyncio.ensure_future(worker("a", t_a)),
                             asyncio.ensure_future(worker("b", t_b)))
        return t_a, t_b

    t_a, t_b = run(scenario())
    assert {s[0] for s in t_a.spans} == {"stage_a", "stage_a_2"}
    assert {s[0] for s in t_b.spans} == {"stage_b", "stage_b_2"}


def test_module_span_is_noop_without_active_trace():
    with tracing.span("anything"):
        pass


def test_cancelled_span_records_nothing(run):
    trace = tracing.TraceRecorder("t").start(endpoint="e")

    async def loser():
        with tracing.span("upstream_ttfb"):
            await asyncio.sleep(30)

    async def scenario():
        token = tracing.activate(trace)
        try:
            task = asyncio.ensure_future(loser())
            await asyncio.sleep(0.01)
            task.cancel()
            try:
                await task
            except asyncio.CancelledError:
                pass
        finally:
            tracing.deactivate(token)

    run(scenario())
    assert trace.spans == []
    with pytest.raises(RuntimeError):
        with trace.span("upstream_ttfb"):
            raise RuntimeError("upstream died")
    assert [s[0] for s in trace.spans] == ["upstream_ttfb"]


def test_safe_id_rejects_splice_hostile_ids():
    assert tracing.safe_id("cafe0123cafe0123") == "cafe0123cafe0123"
    assert tracing.safe_id("client-Req_42") == "client-Req_42"
    for hostile in (
        None, "", "a" * (tracing.MAX_ID_LEN + 1),
        'a"},"path":"/v1/score', "id with spaces", "id\r\nInjected: 1",
        "id;semi", "id~tilde",
    ):
        assert tracing.safe_id(hostile) is None
        assert ref_tracing.safe_id(hostile) is None


def test_snapshot_json_shared_handler_body():
    rec = tracing.TraceRecorder("t")
    for _ in range(3):
        rec.start(endpoint="e").finish(200)
    assert len(json.loads(rec.snapshot_json({}))["recent"]) == 3
    assert len(json.loads(rec.snapshot_json({"n": ["1"]}))["recent"]) == 1
    assert len(json.loads(rec.snapshot_json({"n": ["-5x"]}))["recent"]) == 3


# -- tracing: the digest wire format -----------------------------------


def test_digest_roundtrip():
    trace = tracing.TraceRecorder("replica").start(endpoint="generate")
    base = trace.started
    trace.add_span("prefill", base + 0.001, base + 0.004)
    trace.add_span("decode", base + 0.004, base + 0.050, rounds=7)
    parsed = tracing.parse_digest(trace.digest())
    assert [p[0] for p in parsed] == ["prefill", "decode"]
    assert abs(parsed[0][1] - 0.001) < 1e-4
    assert abs(parsed[1][2] - 0.046) < 1e-4


def test_parse_digest_tolerates_garbage():
    assert tracing.parse_digest("") == []
    assert tracing.parse_digest("no-tildes-here") == []
    assert tracing.parse_digest("a~x~y;b~1.0~2.0;~3~4") == [
        ("b", 0.001, 0.002)
    ]
    flood = ";".join("s~1~1" for _ in range(10_000))
    assert len(tracing.parse_digest(flood)) == tracing.MAX_DIGEST_SPANS


def test_child_digest_is_spliced_with_prefix_and_alignment():
    trace = tracing.TraceRecorder("gateway").start(endpoint="generate")
    dispatch_at = trace.started + 0.010
    trace.add_span("upstream_ttfb", dispatch_at, dispatch_at + 0.100)
    trace.add_child_digest("prefill~2.000~5.000", base=dispatch_at)
    stage, start, end, _meta = trace.spans[-1]
    assert stage == "replica.prefill"
    assert abs(start - (dispatch_at + 0.002)) < 1e-6
    assert abs((end - start) - 0.005) < 1e-6


def test_dominant_stage_top_level_refinement_and_empty():
    assert tracing.dominant_stage(
        {"admission_queue_wait": 1.2, "upstream_connect": 0.01,
         "upstream_ttfb": 0.3}) == "admission_queue_wait"
    assert tracing.dominant_stage(
        {"admission_queue_wait": 0.1, "upstream_ttfb": 2.0,
         "replica.prefill": 0.2, "replica.decode": 1.7}
    ) == "replica.decode"
    assert tracing.dominant_stage(
        {"slot_queue_wait": 0.5, "decode": 0.1}) == "slot_queue_wait"
    assert tracing.dominant_stage({}) is None
    assert tracing.dominant_stage({"x": 0.0}) is None


def test_add_engine_spans_is_bounded_and_batched():
    rec = tracing.TraceRecorder("replica")
    trace = rec.start(endpoint="generate")
    timings = {"enqueued": 100.0, "admitted": 100.2,
               "prefill_done": 100.5, "done": 190.0, "rounds": 100_000}
    tracing.add_engine_spans(trace, timings)
    assert [s[0] for s in trace.spans] == [
        "slot_queue_wait", "prefill", "decode"]
    assert trace.spans[-1][3] == {"rounds": 100_000}
    t_kv = rec.start(endpoint="generate")
    tracing.add_engine_spans(t_kv, dict(timings, kv=0.1))
    stages = {s[0]: s for s in t_kv.spans}
    assert set(stages) == {"slot_queue_wait", "kv", "prefill", "decode"}
    assert stages["kv"][2] == pytest.approx(100.3)
    assert stages["prefill"][1] == stages["kv"][2]
    t_clamp = rec.start(endpoint="generate")
    tracing.add_engine_spans(t_clamp, dict(timings, kv=99.0))
    stages = {s[0]: s for s in t_clamp.spans}
    assert stages["prefill"][1] == stages["prefill"][2] == 100.5
    t2 = rec.start(endpoint="generate")
    tracing.add_engine_spans(t2, {"enqueued": 1.0})
    assert t2.spans == []


def test_add_engine_spans_abandoned_mid_decode_accounts_to_now():
    trace = tracing.TraceRecorder("replica").start(endpoint="generate")
    start = tracing.now()
    tracing.add_engine_spans(trace, {
        "enqueued": start - 0.5, "admitted": start - 0.45,
        "prefill_done": start - 0.4})
    stages = {s[0]: s for s in trace.spans}
    assert set(stages) == {"slot_queue_wait", "prefill", "decode"}
    _, d_start, d_end, _ = stages["decode"]
    assert d_start == start - 0.4 and d_start <= d_end <= tracing.now()


def test_tracing_wire_formats_equal_reference():
    """The same spans give the same digest string, the same parse, the
    same engine spans and the same dominant stage in both packages; a
    digest from either splices into the other."""
    timings = {"enqueued": 10.0, "admitted": 10.25, "prefill_done": 10.5,
               "done": 12.75, "rounds": 9, "kv": 0.125}
    digests = []
    for mod in (tracing, ref_tracing):
        trace = mod.TraceRecorder("replica").start(
            trace_id="cafe0123cafe0123", endpoint="completions")
        trace.started = 9.5
        mod.add_engine_spans(trace, timings)
        trace.add_span("stream_relay", 10.5, 12.8, events=3)
        trace.finish(200)
        entry = trace.as_dict()
        digests.append((trace.digest(), entry, trace.stage_totals()))
    (d_port, e_port, t_port), (d_ref, e_ref, t_ref) = digests
    assert d_port == d_ref
    assert {k: v for k, v in e_port.items() if k != "duration_ms"} == {
        k: v for k, v in e_ref.items() if k != "duration_ms"}
    assert t_port == t_ref
    assert tracing.parse_digest(d_ref) == ref_tracing.parse_digest(d_port)
    assert tracing.dominant_stage(t_port) == ref_tracing.dominant_stage(t_ref)
    assert tracing.encode_digest([("s", 0.0012345, 1.5)]) == \
        ref_tracing.encode_digest([("s", 0.0012345, 1.5)])
    gw = ref_tracing.TraceRecorder("gateway").start(endpoint="generate")
    gw.add_child_digest(d_port, base=gw.started)
    assert [s[0] for s in gw.spans] == [
        "replica.slot_queue_wait", "replica.kv", "replica.prefill",
        "replica.decode", "replica.stream_relay"]
    rec_p, rec_r = tracing.TraceRecorder("x"), ref_tracing.TraceRecorder("x")
    assert set(rec_p.snapshot()) == set(rec_r.snapshot())
    assert set(rec_p.fleet_summary()) == set(rec_r.fleet_summary())


def test_keepalive_request_carries_active_trace_header(run):
    """A sync call made while a traced request is active carries its
    X-CP-Trace (the port's utils/httpclient.py)."""
    import contextvars

    from containerpilot_tpu_torch.utils.http import (
        HTTPServer,
        Response,
    )
    from containerpilot_tpu_torch.utils.httpclient import keepalive_request

    seen = {}

    async def scenario():
        server = HTTPServer()

        async def handler(req):
            seen.update(req.headers)
            return Response(200, b"ok\n")

        server.route("GET", "/probe", handler)
        await server.start_tcp("127.0.0.1", 0)
        port = server.bound_port
        trace = tracing.TraceRecorder("test").start(
            trace_id="feed0123feed0123")
        token = tracing.activate(trace)

        def call():
            return keepalive_request(
                lambda: None, [].append,
                lambda: http.client.HTTPConnection("127.0.0.1", port,
                                                   timeout=10),
                "GET", "/probe")

        ctx = contextvars.copy_context()
        try:
            status, _ = await asyncio.get_running_loop().run_in_executor(
                None, ctx.run, call)
        finally:
            tracing.deactivate(token)
        await server.stop()
        return status

    assert run(scenario()) == 200
    assert seen.get("x-cp-trace") == "feed0123feed0123"


# -- goodput: the state machine (synthetic clock) -----------------------


def test_ledger_transitions_sum_to_wall_time():
    led = DeviceTimeLedger(now=100.0)
    led.enter("compile_warmup", now=101.5)
    led.enter("idle", now=104.0)
    led.enter("prefill", now=104.5)
    led.enter("decode", now=105.25)
    led.engine_idle(now=107.0)
    totals = led.totals(now=110.0)
    assert sum(totals.values()) == pytest.approx(10.0, abs=1e-9)
    assert totals["boot"] == pytest.approx(1.5)
    assert totals["compile_warmup"] == pytest.approx(2.5)
    assert totals["prefill"] == pytest.approx(0.75)
    assert totals["decode"] == pytest.approx(1.75)
    assert totals["idle"] == pytest.approx(3.5)
    snap = led.snapshot(now=110.0)
    assert snap["uptime_s"] == pytest.approx(10.0)
    assert set(snap["stages_s"]) == set(STAGES)


def test_ledger_engine_idle_cannot_cut_boot_short():
    led = DeviceTimeLedger(now=0.0)
    led.engine_idle(now=1.0)
    assert led.totals(now=2.0)["boot"] == pytest.approx(2.0)
    led.enter("prefill", now=2.0)
    led.enter("decode", now=3.0)
    led.engine_idle(now=4.0)
    totals = led.totals(now=5.0)
    assert totals["idle"] == pytest.approx(1.0)
    assert totals["decode"] == pytest.approx(1.0)


def test_ledger_override_owns_attribution():
    led = DeviceTimeLedger(now=0.0)
    led.set_override("compile_warmup", now=1.0)
    led.enter("prefill", now=2.0)
    led.enter("decode", now=3.0)
    led.engine_idle(now=4.0)
    led.clear_override(now=5.0)
    totals = led.totals(now=5.0)
    assert totals["boot"] == pytest.approx(1.0)
    assert totals["compile_warmup"] == pytest.approx(4.0)
    assert totals["prefill"] == totals["decode"] == 0.0
    assert led.totals(now=7.0)["idle"] == pytest.approx(2.0)
    assert led.first_productive_at is None
    led.enter("prefill", now=8.0)
    assert led.first_productive_at == 8.0
    led.set_override("drain", now=9.0)
    led.enter("decode", now=9.5)
    led.clear_override(now=11.0)
    assert led.totals(now=11.0)["drain"] == pytest.approx(2.0)


def test_ledger_kv_carve_clamps_to_open_segment():
    led = DeviceTimeLedger(now=0.0)
    led.enter("prefill", now=1.0)
    led.carve("kv_readmit", 0.3, now=1.5)
    led.enter("decode", now=2.0)
    totals = led.totals(now=2.0)
    assert totals["kv_readmit"] == pytest.approx(0.3)
    assert totals["prefill"] == pytest.approx(0.7)
    led2 = DeviceTimeLedger(now=0.0)
    led2.enter("prefill", now=1.0)
    led2.carve("kv_readmit", 99.0, now=1.4)
    totals2 = led2.totals(now=1.4)
    assert totals2["kv_readmit"] == pytest.approx(0.4)
    assert sum(totals2.values()) == pytest.approx(1.4)


def test_ledger_freeze_stops_the_clock():
    led = DeviceTimeLedger(now=0.0)
    led.enter("idle", now=1.0)
    led.freeze(now=3.0)
    assert sum(led.totals(now=50.0).values()) == pytest.approx(3.0)
    assert led.snapshot(now=50.0)["uptime_s"] == pytest.approx(3.0)
    led.enter("decode", now=10.0)
    led.engine_idle(now=20.0)
    led.carve("kv_readmit", 5.0, now=30.0)
    led.clear_override(now=40.0)
    assert sum(led.totals(now=50.0).values()) == pytest.approx(3.0)
    assert led.totals(now=50.0)["decode"] == 0.0


def test_ledger_rejects_unknown_stage():
    led = DeviceTimeLedger(now=0.0)
    for call in (lambda: led.enter("lunch"),
                 lambda: led.set_override("lunch"),
                 lambda: led.carve("lunch", 1.0)):
        with pytest.raises(ValueError):
            call()


def test_note_roundtrip_and_torn_note_merge():
    led = DeviceTimeLedger(now=0.0)
    led.enter("compile_warmup", now=2.0)
    led.enter("idle", now=5.0)
    note = led.note(dispatches=12, tokens_out=340, now=6.0)
    assert "=" not in note
    parsed = parse_note(note)
    assert parsed["boot"] == pytest.approx(2.0)
    assert parsed["compile_warmup"] == pytest.approx(3.0)
    assert (parsed["dispatches"], parsed["tokens_out"]) == (12, 340)
    torn = parse_note("2.000,3.0")
    assert torn["compile_warmup"] == pytest.approx(3.0)
    assert torn["idle"] == 0.0
    assert parse_note("abc")["boot"] == 0.0
    assert parse_note(None)["boot"] == 0.0
    assert parse_note("1.0,nan,5.0")["compile_warmup"] == 0.0
    assert parse_note("1.0,inf")["compile_warmup"] == 0.0
    merged = merge_note_max(parsed, torn)
    assert merged["idle"] == pytest.approx(1.0)
    assert set(merged) == set(NOTE_FIELDS)


def test_fleet_summation_and_productive_fraction():
    a = {"boot": 1.0, "idle": 2.0, "prefill": 1.0, "decode": 2.0,
         "dispatches": 10, "tokens_out": 100}
    b = {"compile_warmup": 4.0, "decode": 2.0, "dispatches": 30,
         "tokens_out": 60}
    totals = sum_stage_totals([a, b])
    assert totals["decode"] == pytest.approx(4.0)
    assert productive_fraction(totals) == pytest.approx(5 / 12, abs=1e-3)
    assert productive_fraction({}) is None
    summary = goodput.fleet_summary([a, b])
    assert summary == ref_goodput.fleet_summary([a, b])
    assert summary["dispatches_per_token"] == pytest.approx(0.25)


def test_scheduling_gap_flags_queue_wait_over_idle():
    rec = tracing.TraceRecorder("replica")
    queued = rec.start(endpoint="generate")
    queued.add_span("slot_queue_wait", 100.0, 101.0)
    queued.add_span("decode", 101.0, 101.1)
    busy = rec.start(endpoint="generate")
    busy.add_span("slot_queue_wait", 200.0, 201.0)
    busy.add_span("decode", 201.0, 201.1)
    fast = rec.start(endpoint="generate")
    fast.add_span("decode", 300.0, 301.0)
    gaps = find_scheduling_gaps([queued, busy, fast],
                                [(100.4, 100.9), (150.0, 160.0)])
    assert len(gaps) == 1 and gaps[0]["trace_id"] == queued.trace_id
    assert gaps[0]["idle_overlap_ms"] == pytest.approx(500.0, abs=1.0)
    assert find_scheduling_gaps([queued], []) == []


def test_goodput_wire_formats_equal_reference():
    """One synthetic history through both ledgers: equal snapshots,
    notes and /v1/goodput payload keys."""
    ledgers = []
    for mod in (goodput, ref_goodput):
        led = mod.DeviceTimeLedger(now=0.0)
        led.set_override("compile_warmup", now=0.5)
        led.clear_override(now=2.0)
        led.enter("idle", now=2.0)
        led.enter("prefill", now=3.0)
        led.carve("kv_readmit", 0.25, now=3.5)
        led.enter("decode", now=3.5)
        led.engine_idle(now=7.25)
        ledgers.append(led)
    port, ref = ledgers
    assert port.snapshot(now=9.0) == ref.snapshot(now=9.0)
    assert port.note(5, 77, now=9.0) == ref.note(5, 77, now=9.0)
    assert goodput.NOTE_FIELDS == ref_goodput.NOTE_FIELDS
    assert goodput.STAGES == ref_goodput.STAGES
    payload = goodput.goodput_payload(
        port, tracing.TraceRecorder("replica"), 5, 77, role="replica",
        ready=True, draining=False)
    ref_payload = ref_goodput.goodput_payload(
        ref, ref_tracing.TraceRecorder("replica"), 5, 77, role="replica",
        ready=True, draining=False)
    assert set(payload) == set(ref_payload)


# -- the slot engine's ledger stamps and the server's surface ------------


def _tiny_model(max_len=64):
    import jax
    import jax.numpy as jnp

    from containerpilot_tpu.models import transformer as jtf
    from containerpilot_tpu_torch import bridge
    from containerpilot_tpu_torch.models import transformer as ttf

    base = dict(vocab_size=64, d_model=32, n_heads=2, n_layers=1, d_ff=64,
                max_seq_len=max_len, dtype="float32")
    jcfg = jtf.TransformerConfig(**{**base, "dtype": jnp.float32})
    jp = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    tp = bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                "cpu")
    return ttf.TransformerConfig(**bridge.config_kwargs(base)), tp


def test_engine_ledger_stamps_are_bounded_not_per_token():
    """However many tokens a request decodes, the engine's ledger
    transitions are a small constant per request (tests/test_goodput.py
    :386)."""
    from containerpilot_tpu_torch.workload.serve_slots import SlotEngine

    cfg, params = _tiny_model(max_len=128)
    led = DeviceTimeLedger()
    engine = SlotEngine(cfg, params, 128, slots=2, chunk=8, ledger=led)
    try:
        engine.submit([1, 2, 3, 4], max_new=2).result(timeout=120)
        before = led.transitions
        tokens_before = engine.tokens_out
        engine.submit([1, 2, 3, 4], max_new=96).result(timeout=120)
        assert engine.tokens_out - tokens_before >= 90
        assert led.transitions - before <= 8
        assert engine.dispatches / engine.tokens_out < 0.5
        totals = led.totals()
        assert totals["prefill"] > 0.0 and totals["decode"] > 0.0
    finally:
        engine.stop()


def _get(port, path, timeout=30):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=timeout) as resp:
            return resp.status, resp.read().decode(), dict(resp.headers)
    except urllib.error.HTTPError as exc:
        return exc.code, exc.read().decode(), dict(exc.headers)


def _post(port, path, payload, timeout=120, headers=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, resp.read().decode(), dict(resp.headers)
    except urllib.error.HTTPError as exc:
        return exc.code, exc.read().decode(), dict(exc.headers)


def test_server_goodput_surface_and_accounting(run):
    """/v1/goodput sums to uptime within 2%, compile_warmup is stamped
    before /health turns 200, /metrics carries the ledger's gauges, the
    note parses, drain attributes and stop freezes the ledger
    (tests/test_goodput.py:416); plus /v1/traces holds the request's
    slot_queue_wait, prefill and decode spans under the caller's id."""
    from containerpilot_tpu_torch.workload.serve import InferenceServer

    cfg, params = _tiny_model()
    server = InferenceServer(cfg, params, "127.0.0.1", 0, max_len=64,
                             slots=2, slot_chunk=4, device="cpu")

    async def scenario():
        loop = asyncio.get_running_loop()
        await server.run()
        snap = server.ledger.snapshot()
        assert snap["stages_s"]["compile_warmup"] > 0.0
        assert snap["stage"] in ("idle", "prefill", "decode")
        status, body, headers = await loop.run_in_executor(
            None, lambda: _post(
                server.port, "/v1/generate",
                {"tokens": [[1, 2, 3, 4]], "max_new_tokens": 8},
                headers={"X-CP-Trace": "beef0000beef0000"}))
        assert status == 200
        assert headers["X-CP-Trace"] == "beef0000beef0000"
        stages = [s for s, _o, _d in tracing.parse_digest(
            headers["X-CP-Span-Digest"])]
        assert stages == ["slot_queue_wait", "prefill", "decode"]
        status, body, _ = await loop.run_in_executor(
            None, _get, server.port, "/v1/goodput")
        assert status == 200
        gp = json.loads(body)
        assert gp["role"] == "replica"
        assert set(gp["stages_s"]) == set(STAGES)
        assert sum(gp["stages_s"].values()) == pytest.approx(
            gp["uptime_s"], rel=0.02, abs=0.02)
        assert gp["stages_s"]["prefill"] > 0.0
        assert gp["productive_fraction"] > 0.0
        assert gp["tokens_out"] >= 8
        assert gp["dispatches"] == server.slot_engine.stats["dispatches"]
        assert gp["dispatches_per_token"] is not None
        assert isinstance(gp["scheduling_gaps"], list)
        status, metrics, _ = await loop.run_in_executor(
            None, _get, server.port, "/metrics")
        for stage in STAGES:
            assert f'cp_device_seconds_total{{stage="{stage}"}}' in metrics
        assert "cp_decode_dispatches_total" in metrics
        assert "cp_tokens_out_total" in metrics
        status, body, _ = await loop.run_in_executor(
            None, _get, server.port, "/v1/traces")
        traces = json.loads(body)
        mine = [t for t in traces["recent"]
                if t["trace_id"] == "beef0000beef0000"]
        assert traces["role"] == "replica" and len(mine) == 1
        assert [s["stage"] for s in mine[0]["spans"]] == stages
        parsed = parse_note(server.goodput_note())
        assert parsed["compile_warmup"] > 0.0
        assert parsed["tokens_out"] >= 8
        server.enter_maintenance()
        await asyncio.sleep(0.05)
        assert server.ledger.stage == "drain"
        status, _, headers = await loop.run_in_executor(
            None, _get, server.port, "/health")
        assert status == 503 and headers["Retry-After"] == "1"
        status, _, headers = await loop.run_in_executor(
            None, lambda: _post(server.port, "/v1/generate",
                                {"tokens": [[1, 2]]},
                                headers={"X-CP-Trace": "dead0000dead0000"}))
        assert status == 503 and headers["X-CP-Trace"] == "dead0000dead0000"
        status, body, _ = await loop.run_in_executor(
            None, _get, server.port, "/v1/model")
        assert status == 200 and json.loads(body)["draining"] is True
        server.exit_maintenance()
        assert server.ledger.totals()["drain"] > 0.0
        await server.stop()
        final = sum(server.ledger.totals().values())
        await asyncio.sleep(0.05)
        assert sum(server.ledger.totals().values()) == pytest.approx(final)

    run(scenario(), timeout=120)


# -- the Prometheus exposition ------------------------------------------


def _exercise(mod_counter, mod_gauge, mod_histogram, registry):
    reqs = mod_counter("containerpilot_serve_requests",
                       "requests served, by endpoint and status code",
                       ["endpoint", "code"], registry=registry)
    lat = mod_histogram("containerpilot_serve_request_seconds",
                        "request wall time, by endpoint", ["endpoint"],
                        registry=registry,
                        buckets=(.005, .02, .05, .1, .25, .5, 1, 2.5, 5,
                                 10, 30, 60))
    toks = mod_counter("containerpilot_serve_generated_tokens",
                       "tokens returned by generate/completions "
                       "(post-trim)", registry=registry)
    gauge = mod_gauge("cp_odd", 'help with "quotes", \\ and\nnewline',
                      ["stage"], registry=registry)
    reqs.labels("generate", "200").inc()
    reqs.labels("generate", "200").inc()
    reqs.labels("completions", "422").inc()
    for value in (0.001, 0.02, 0.3, 7.0, 99.0):
        lat.labels("generate").observe(value)
    toks.inc(10)
    gauge.labels('a"b\\c').set(1.23456789e-7)
    gauge.labels("big").set_function(lambda: 12345678901234.0)


def _mask_created(text):
    return "\n".join(
        line.rsplit(" ", 1)[0] if "_created" in line
        and not line.startswith("#") else line
        for line in text.splitlines())


def test_exposition_matches_prometheus_client():
    """The port's registry writes what prometheus_client writes for the
    same metrics (``_created`` timestamps aside), and the client's
    parser reads the same families, types, labels and values."""
    import prometheus_client
    from prometheus_client.parser import text_string_to_metric_families

    ref_registry = prometheus_client.CollectorRegistry()
    _exercise(prometheus_client.Counter, prometheus_client.Gauge,
              prometheus_client.Histogram, ref_registry)
    port_registry = prom.Registry()
    _exercise(prom.Counter, prom.Gauge, prom.Histogram, port_registry)
    ref_text = prometheus_client.generate_latest(ref_registry).decode()
    body, ctype = prom.exposition(port_registry)
    assert ctype == "text/plain; version=0.0.4"
    assert _mask_created(body.decode()) == _mask_created(ref_text)

    def families(text):
        return [(f.name, f.type, f.documentation,
                 [(s.name, s.labels, s.value) for s in f.samples
                  if not s.name.endswith("_created")])
                for f in text_string_to_metric_families(text)]

    assert families(body.decode()) == families(ref_text)
    with pytest.raises(ValueError):
        prom.Counter("containerpilot_serve_requests", "x",
                     registry=port_registry)


def test_build_info_and_loop_lag_gauges(run):
    from containerpilot_tpu_torch.analysis.loopcheck import LoopLagProbe

    registry = prom.Registry()
    prom.ensure_build_info(registry, "replica")
    prom.ensure_build_info(registry, "replica")  # a second one: no-op
    probe = LoopLagProbe(interval_s=0.01)

    async def scenario():
        probe.start()
        await asyncio.sleep(0.1)
        probe.stop()

    run(scenario())
    prom.ensure_loop_lag_gauge(registry, probe)
    body = prom.exposition(registry)[0].decode()
    assert 'cp_build_info{role="replica",version="0.7.0"} 1.0' in body
    assert 'cp_loop_lag_ms{stat="max"}' in body
    assert 'cp_loop_lag_ms{stat="p99"}' in body
    assert probe.beats >= 3 and probe.snapshot()["heartbeats"] == probe.beats
