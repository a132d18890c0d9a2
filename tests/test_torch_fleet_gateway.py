"""The port's fleet gateway against the reference's.

``test_gateway_case`` runs the stub-server cases of
``tests/test_fleet.py`` (routing units, retries, hedging, the connection
pool, cp-mux/1, members) once on each package (``tests/torch_twins.py``):
the same stubs, seeds and assertions, so status codes, which stub served,
``Retry-After``, ``/fleet`` and counters agree. The reference's mux
client drops its upgraded socket's ``StreamWriter``, which CPython 3.12
closes on collection, so its cases run with the writer held; the port's
client keeps it. ``test_dead_mux_conn_fails_streams_once_each_arming_retry``
is left out: its second request reaches the doomed replica only if it
arrives before the first is dispatched, and on both packages it often
does not (then least-outstanding routing sends it to the healthy stub).

``test_same_surfaces_on_a_stub_fleet`` drives both gateways through one
request sequence and compares the answers, ``/fleet`` and ``/metrics``
directly. The integration tests put the port's gateway in front of torch
``InferenceServer`` replicas (greedy tokens equal JAX ``generate`` on
the bridged params, a drain mid-traffic costs no 5xx, a prefill/decode
pair hands the KV off once) and in front of a JAX and a torch replica.
"""
import asyncio
import json
import re
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_twins
from torch_twins import keep_mux_writer  # noqa: F401 (a fixture)
from containerpilot_tpu.models import decode as jdecode
from containerpilot_tpu.models import transformer as jtf
from containerpilot_tpu.workload.serve import InferenceServer as JaxServer
from containerpilot_tpu_torch import bridge
from containerpilot_tpu_torch.discovery import (
    FileCatalogBackend,
    ServiceRegistration,
)
from containerpilot_tpu_torch.fleet import FleetGateway, FleetMember
from containerpilot_tpu_torch.models import transformer as ttf
from containerpilot_tpu_torch.utils.http import HTTPServer, Response
from containerpilot_tpu_torch.workload.serve import InferenceServer

CASES = (
    "test_least_outstanding_pick_is_deterministic",
    "test_sticky_affinity_and_drained_away_accounting",
    "test_affinity_key_extraction_modes",
    "test_cache_aware_pick_prefers_warm_within_slack",
    "test_request_fingerprint_token_rows_only",
    "test_sticky_lru_bound_and_eviction_counter",
    "test_apply_notes_updates_kv_state_tolerantly",
    "test_pick_excludes_standby_role",
    "test_apply_notes_parses_role_and_compile_cache",
    "test_standby_member_note_and_gateway_capacity",
    "test_fleet_tokens_reused_survives_replica_departure",
    "test_hedge_threshold_is_learned_per_endpoint",
    "test_gateway_retries_on_a_different_replica",
    "test_gateway_exhausted_retries_surface_503_with_retry_after",
    "test_gateway_hedges_slow_replica_and_takes_the_fast_result",
    "test_gateway_pool_reuses_connections_across_requests",
    "test_gateway_pool_evicts_on_deregister",
    "test_gateway_pool_redials_stale_connection_transparently",
    "test_hedge_legs_take_distinct_connections",
    "test_content_length_parsed_strictly",
    "test_replica_dying_after_status_line_is_retried",
    "test_malformed_content_length_is_retried",
    "test_filecatalog_listing_survives_torn_and_leftover_records",
    "test_member_heartbeats_and_ttl_expiry",
    "test_member_drains_via_control_plane",
    "test_mux_hedge_loser_cancelled_not_torn_down",
    "test_mux_cold_burst_shares_one_dial",
    "test_mux_stale_connection_redialed_transparently",
    "test_mux_sse_abandon_cancels_stream_keeps_connection",
    "test_member_heartbeat_survives_transient_exception",
)

BASE = dict(vocab_size=64, d_model=32, n_heads=2, n_layers=1, d_ff=64,
            max_seq_len=64, dtype="float32")
MAX_LEN = 64
PROMPT = [1, 2, 3, 4, 5]
MAX_NEW = 12
#: a prompt long enough for the prefix cache (MIN_REUSE) to hand off
LONG = [(7 * i + 3) % 61 + 1 for i in range(24)]
#: what a KV handoff needs on both replicas of the pair
SPLIT = dict(prefix_cache_entries=4, kv_spill_bytes=1 << 20)


@pytest.fixture(scope="module")
def twins():
    return {pkg: torch_twins.load("test_fleet", pkg)
            for pkg in torch_twins.PACKAGES}


@pytest.mark.parametrize("package", torch_twins.PACKAGES)
@pytest.mark.parametrize("case", CASES)
def test_gateway_case(case, package, twins, run, tmp_path, keep_mux_writer):
    fn = getattr(twins[package], case)
    fn(**torch_twins.case_args(fn, {"run": run, "tmp_path": tmp_path}))


# -- one request sequence through both gateways ---------------------------


def _post(port, path, payload, timeout=60, headers=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, resp.read().decode(), dict(resp.headers)
    except urllib.error.HTTPError as exc:
        return exc.code, exc.read().decode(), dict(exc.headers)


def _get(port, path, timeout=30):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=timeout) as resp:
        return resp.read().decode()


def _shape(value):
    """A JSON value's key structure: dict keys recursively, list shapes
    by their first element, leaves by type."""
    if isinstance(value, dict):
        return {k: _shape(v) for k, v in value.items()}
    if isinstance(value, list):
        return [_shape(value[0])] if value else []
    return type(value).__name__


def _families(text):
    return dict(re.findall(r"^# TYPE (\S+) (\S+)$", text, re.M))


def _samples(text, prefix):
    """Sample lines of the gateway's own families, times left out."""
    out = []
    for line in text.splitlines():
        if not line.startswith(prefix) or "_created" in line:
            continue
        if "_seconds" in line or "_ms" in line:  # wall times differ
            line = line.rsplit(" ", 1)[0]
        out.append(line)
    return sorted(out)


def _stub_fleet_run(package, catalog_dir):
    """Two stub replicas (one healthy, one always 503) behind the given
    package's gateway: answers, /fleet and /metrics."""
    if package == "jax":
        from containerpilot_tpu.discovery import (
            FileCatalogBackend as Backend,
            ServiceRegistration as Registration,
        )
        from containerpilot_tpu.fleet import FleetGateway as Gateway
        from containerpilot_tpu.utils.http import (
            HTTPServer as Server,
            Response as Resp,
        )
    else:
        Backend, Registration = FileCatalogBackend, ServiceRegistration
        Gateway, Server, Resp = FleetGateway, HTTPServer, Response

    def stub(name, status):
        async def generate(req):
            body = json.loads(req.body.decode() or "{}")
            return Resp(status, json.dumps(
                {"tokens": [[len(body.get("tokens", [[]])[0]), 7]],
                 "served_by": name}).encode(),
                headers={"Retry-After": "1"} if status == 503 else None)

        server = Server()
        server.route("POST", "/v1/generate", generate)
        return server

    async def scenario():
        loop = asyncio.get_running_loop()
        good, bad = stub("good", 200), stub("bad", 503)
        await good.start_tcp("127.0.0.1", 0)
        await bad.start_tcp("127.0.0.1", 0)
        backend = Backend(catalog_dir)
        for name, server in (("a-good", good), ("b-bad", bad)):
            backend.service_register(Registration(
                id=name, name="svc", port=server.bound_port, ttl=60,
                address="127.0.0.1"), status="passing")
        gateway = Gateway(backend, "svc", "127.0.0.1", 0, poll_interval=0.05,
                          hedge=False, retry_backoff=0.01, retry_jitter=0.0,
                          mux=False)
        await gateway.run()
        try:
            for _ in range(200):
                if gateway.replica_count == 2:
                    break
                await asyncio.sleep(0.05)
            answers = []
            for i in range(6):
                status, text, headers = await loop.run_in_executor(
                    None, _post, gateway.port, "/v1/generate",
                    {"tokens": [[1] * (i + 1)], "max_new_tokens": 2,
                     "session_id": f"s{i % 2}"})
                answers.append((status, json.loads(text)))
            # only the failing stub left: the retries run out into a 503
            backend.service_deregister("a-good")
            for _ in range(200):
                if gateway.replica_count == 1:
                    break
                await asyncio.sleep(0.05)
            status, text, headers = await loop.run_in_executor(
                None, _post, gateway.port, "/v1/generate",
                {"tokens": [[1, 2]], "max_new_tokens": 2})
            answers.append((status, headers.get("Retry-After")))
            fleet = json.loads(await loop.run_in_executor(
                None, _get, gateway.port, "/fleet"))
            metrics = await loop.run_in_executor(
                None, _get, gateway.port, "/metrics")
        finally:
            await gateway.stop()
            await good.stop()
            await bad.stop()
        return answers, fleet, metrics

    return asyncio.run(asyncio.wait_for(scenario(), 60))


def test_same_surfaces_on_a_stub_fleet(tmp_path, keep_mux_writer):
    runs = {pkg: _stub_fleet_run(pkg, str(tmp_path / pkg))
            for pkg in torch_twins.PACKAGES}
    (ref_answers, ref_fleet, ref_metrics) = runs["jax"]
    (answers, fleet, metrics) = runs["torch"]
    assert answers == ref_answers
    assert [a[0] for a in answers[:6]] == [200] * 6
    assert answers[-1][0] == 503 and answers[-1][1] is not None
    assert _shape(fleet) == _shape(ref_fleet)
    ref_rows = {r["id"]: r for r in ref_fleet["replicas"]}
    for row in fleet["replicas"]:
        assert row["id"] in ref_rows
        for key in ("role", "healthy", "outstanding", "pool", "mux"):
            if key in row:
                assert row[key] == ref_rows[row["id"]][key], key
    assert _families(metrics) == _families(ref_metrics)
    assert (_samples(metrics, "containerpilot_gateway_")
            == _samples(ref_metrics, "containerpilot_gateway_"))


# -- the port's gateway in front of real replicas -------------------------


def _jax_model():
    jcfg = jtf.TransformerConfig(**{**BASE, "dtype": jnp.float32})
    jp = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    tp = bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                "cpu")
    tcfg = ttf.TransformerConfig(**bridge.config_kwargs(BASE))
    return jcfg, jp, tcfg, tp


def _want(jcfg, jp, prompt, max_new):
    return np.asarray(jdecode.generate(
        jp, jnp.asarray([prompt], jnp.int32), jcfg,
        max_new_tokens=max(16, max_new), max_len=MAX_LEN,
    )).tolist()[0][:max_new]


def _served(server):
    return (server._server.requests_served
            + server._server.mux_streams_served)


async def _until(pred, what, tries=300):
    for _ in range(tries):
        if pred():
            return
        await asyncio.sleep(0.05)
    raise AssertionError(f"timed out waiting for {what}")


async def _call(port, path, payload):
    return await asyncio.get_running_loop().run_in_executor(
        None, _post, port, path, payload)


async def _fetch(port, path):
    return json.loads(await asyncio.get_running_loop().run_in_executor(
        None, _get, port, path))


def test_port_gateway_fronts_torch_replicas(run, tmp_path):
    jcfg, jp, tcfg, tp = _jax_model()
    want = _want(jcfg, jp, PROMPT, MAX_NEW)
    want_long = _want(jcfg, jp, LONG, 8)

    def replica(**kw):
        return InferenceServer(tcfg, tp, "127.0.0.1", 0, MAX_LEN, slots=2,
                               slot_chunk=4, device="cpu", **kw)

    async def scenario():
        backend = FileCatalogBackend(str(tmp_path / "catalog"))
        servers, members = [], []

        async def join(server, rid):
            await server.run()
            member = FleetMember(server, backend, "inference", ttl=5,
                                 heartbeat_interval=0.1, instance_id=rid)
            await member.start()
            servers.append(server)
            members.append(member)
            return member

        await join(replica(), "torch-1")
        await join(replica(), "torch-2")
        gateway = FleetGateway(backend, "inference", "127.0.0.1", 0,
                               poll_interval=0.05, hedge=False,
                               retry_backoff=0.01)
        await gateway.run()
        out = {}
        try:
            await _until(lambda: gateway.replica_count == 2, "2 replicas")
            body = {"tokens": [PROMPT], "max_new_tokens": MAX_NEW}
            first = await asyncio.gather(*(
                _call(gateway.port, "/v1/generate",
                      dict(body, session_id=f"s{i}")) for i in range(6)))
            out["first"] = [(s, json.loads(t)) for s, t, _h in first]
            before = _served(servers[1])
            # drain torch-1 while traffic runs: zero 5xx
            traffic = asyncio.gather(*(
                _call(gateway.port, "/v1/generate",
                      dict(body, session_id=f"d{i}")) for i in range(12)))
            await asyncio.sleep(0.05)
            await members[0].drain(timeout=30.0)
            await members[0].stop(deregister=True)
            out["drain"] = [(s, json.loads(t) if s == 200 else t)
                            for s, t, _h in await traffic]
            out["survivor_served"] = _served(servers[1]) - before
            await _until(lambda: gateway.replica_count == 1, "the drain")
            # a prefill/decode pair: one handoff, the same tokens
            await servers[0].stop()
            await join(replica(role="prefill", **SPLIT), "pf-1")
            await members[1].stop(deregister=True)
            await servers[1].stop()
            await join(replica(role="decode", **SPLIT), "dc-1")
            await _until(lambda: set(gateway._replicas) == {"pf-1", "dc-1"}
                         and {r.role for r in gateway._replicas.values()}
                         == {"prefill", "decode"}, "the split fleet")
            status, text, _h = await _call(
                gateway.port, "/v1/generate",
                {"tokens": [LONG], "max_new_tokens": 8})
            out["split"] = (status, json.loads(text) if status == 200
                            else text)
            out["handoffs"] = dict(gateway.handoffs)
            out["fleet"] = await _fetch(gateway.port, "/fleet")
        finally:
            await gateway.stop()
            for member in members:
                await member.stop()
            for server in servers[2:]:
                await server.stop()
        return out

    out = run(scenario(), timeout=240)
    for status, answer in out["first"]:
        assert status == 200 and answer["tokens"] == [want]
    assert out["survivor_served"] >= 1  # the drain moved traffic over
    for status, answer in out["drain"]:
        assert status == 200, answer
        assert answer["tokens"] == [want]
    status, answer = out["split"]
    assert status == 200, answer
    assert answer["tokens"] == [want_long]
    assert out["handoffs"]["total"] == 1, out["handoffs"]
    assert out["handoffs"]["failed"] == 0
    assert out["handoffs"]["bytes"] > 0
    roles = {r["id"]: r["role"] for r in out["fleet"]["replicas"]}
    assert roles == {"pf-1": "prefill", "dc-1": "decode"}


def test_port_gateway_fronts_jax_and_torch_replicas(run, tmp_path):
    """The reverse of tests/test_torch_gateway.py: the port's gateway
    routes greedy requests to a JAX and a torch replica over cp-mux/1
    (the port's client keeps its writer: no fixture needed), and both
    answer the JAX tokens."""
    jcfg, jp, tcfg, tp = _jax_model()
    want = _want(jcfg, jp, PROMPT, MAX_NEW)

    async def scenario():
        backend = FileCatalogBackend(str(tmp_path / "catalog"))
        jax_server = JaxServer(jcfg, jp, "127.0.0.1", 0, max_len=MAX_LEN,
                               slots=2, slot_chunk=4)
        torch_server = InferenceServer(tcfg, tp, "127.0.0.1", 0, MAX_LEN,
                                       slots=2, slot_chunk=4, device="cpu")
        await jax_server.run()
        await torch_server.run()
        members = [
            FleetMember(jax_server, backend, "inference", ttl=5,
                        heartbeat_interval=0.1, instance_id="jax-1"),
            FleetMember(torch_server, backend, "inference", ttl=5,
                        heartbeat_interval=0.1, instance_id="torch-1"),
        ]
        for member in members:
            await member.start()
        gateway = FleetGateway(backend, "inference", "127.0.0.1", 0,
                               poll_interval=0.05, hedge=False,
                               retry_backoff=0.01)
        await gateway.run()
        answers = []
        try:
            await _until(lambda: gateway.replica_count == 2, "2 replicas")
            for _ in range(10):
                answers += await asyncio.gather(*(
                    _call(gateway.port, "/v1/generate",
                          {"tokens": [PROMPT], "max_new_tokens": MAX_NEW})
                    for _ in range(6)))
                if min(jax_server._server.mux_streams_served,
                       torch_server._server.mux_streams_served) > 0:
                    break
            streams = (jax_server._server.mux_streams_served,
                       torch_server._server.mux_streams_served)
            fleet = await _fetch(gateway.port, "/fleet")
        finally:
            await gateway.stop()
            for member in members:
                await member.stop()
            await jax_server.stop()
            await torch_server.stop()
        return answers, streams, fleet

    answers, streams, fleet = run(scenario(), timeout=240)
    for status, text, _headers in answers:
        assert status == 200, text
        assert json.loads(text)["tokens"] == [want]
    assert min(streams) >= 1, streams
    for row in fleet["replicas"]:
        assert row["mux"]["connected"] is True, row
        assert row["mux"]["unsupported"] is False, row


def test_chip_smoke_gateway_families_are_the_references(run):
    """chip_smoke.py holds the port's gateway on the card to the family
    list GATEWAY_FAMILIES; it must be the reference gateway's."""
    import chip_smoke
    from containerpilot_tpu.discovery import NoopBackend
    from containerpilot_tpu.fleet import FleetGateway as RefGateway
    from containerpilot_tpu.utils.prom import exposition

    async def families():
        gateway = RefGateway(NoopBackend(), "svc", "127.0.0.1", 0)
        await gateway.run()
        try:
            return _families(exposition(gateway.registry)[0].decode())
        finally:
            await gateway.stop()

    ref = {f for f in run(families()) if not f.endswith("_created")}
    assert chip_smoke.GATEWAY_FAMILIES == ref
