"""KV handoff, drain migration and weight transfer between a JAX replica
and a torch replica on the same params (through ``bridge.py``), both
with a slot engine, a prefix cache and a spill tier. A prompt prefilled
on one is pulled by the other (``/v1/kv/pull``), both ways: the puller
readmits it once and its greedy tokens equal a local prefill's in both
packages. ``/v1/weights`` fetched both ways rebuilds bit-equal params. A
draining torch replica migrates its cached session to the JAX survivor,
and its refusal names the survivor in ``X-CP-Migrated-To``. A torch
standby answers 503 until promoted, 200 after.

The servers run on one event loop in a thread for the whole module, so
the JAX replica warms once. The reference's mux client drops the
upgraded connection's ``StreamWriter``, which CPython 3.12 closes on
collection (ROADMAP.md queue 3); the fixture holds it, as
``tests/test_torch_gateway.py``'s ``keep_mux_writer`` does, so the test
exercises the torch replica rather than that defect."""
import asyncio
import json
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from containerpilot_tpu.discovery import FileCatalogBackend as RefCatalog
from containerpilot_tpu.fleet import FleetMember as RefMember
from containerpilot_tpu.fleet import pool as ref_pool
from containerpilot_tpu.fleet import standby as ref_standby
from containerpilot_tpu.kvtier.digest import (
    parse_migration_note as ref_parse_mg,
)
from containerpilot_tpu.models import decode as jdecode
from containerpilot_tpu.models import transformer as jtf
from containerpilot_tpu.workload.serve import (
    InferenceServer as JaxServer,
)
from containerpilot_tpu_torch import bridge
from containerpilot_tpu_torch.discovery import FileCatalogBackend
from containerpilot_tpu_torch.fleet import FleetMember
from containerpilot_tpu_torch.fleet import standby
from containerpilot_tpu_torch.kvtier.digest import prefix_fingerprint
from containerpilot_tpu_torch.models import decode as tdecode
from containerpilot_tpu_torch.models import transformer as ttf
from containerpilot_tpu_torch.workload.serve import InferenceServer

BASE = dict(vocab_size=64, d_model=32, n_heads=2, n_layers=1, d_ff=64,
            max_seq_len=64, dtype="float32")
MAX_LEN = 64
MAX_NEW = 8
SERVE = dict(slots=2, slot_chunk=4, prefix_cache_entries=2,
             kv_spill_bytes=1 << 20)


def _row(seed):
    return [int(t) for t in
            np.random.default_rng(seed).integers(1, 64, size=32)]


def _post(port, path, payload=None, timeout=120):
    data = json.dumps(payload).encode() if payload is not None else b""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=data, method="POST",
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, resp.read().decode(), dict(resp.headers)
    except urllib.error.HTTPError as exc:
        return exc.code, exc.read().decode(), dict(exc.headers)


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=60) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as exc:
        return exc.code, exc.read().decode()


def _model(port):
    return json.loads(_get(port, "/v1/model")[1])


def _readmitted(port):
    return _model(port)["prefix_cache"]["readmitted"]


def _generate(port, row):
    status, text, _ = _post(port, "/v1/generate",
                            {"tokens": [row], "max_new_tokens": MAX_NEW})
    assert status == 200, text
    return json.loads(text)["tokens"][0]


class _Fleet:
    """The module's servers, living on one event loop in a thread."""

    def __init__(self):
        jcfg = jtf.TransformerConfig(**{**BASE, "dtype": jnp.float32})
        self.jcfg = jcfg
        self.jp = jtf.init_params(jax.random.PRNGKey(0), jcfg)
        self.tp = bridge.params_from_jax(
            jax.tree_util.tree_map(np.asarray, self.jp), "cpu")
        self.tcfg = ttf.TransformerConfig(**bridge.config_kwargs(BASE))
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever,
                                       daemon=True)
        self.thread.start()
        self.servers = []
        self.jax = self.call(self.start(JaxServer(
            jcfg, self.jp, "127.0.0.1", 0, max_len=MAX_LEN, **SERVE)))
        self.torch = self.call(self.start(self.torch_server()))

    def torch_server(self, **kw):
        return InferenceServer(self.tcfg, self.tp, "127.0.0.1", 0,
                               MAX_LEN, device="cpu", **{**SERVE, **kw})

    async def start(self, server):
        await server.run()
        self.servers.append(server)
        return server

    def call(self, coro, timeout=120):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(
            timeout)

    def want(self, row):
        """A local prefill's greedy tokens in each package."""
        jax_out = np.asarray(jdecode.generate(
            self.jp, jnp.asarray([row], jnp.int32), self.jcfg,
            max_new_tokens=MAX_NEW, max_len=MAX_LEN))[0].tolist()
        torch_out = tdecode.generate(
            self.tp, torch.tensor([row]), self.tcfg, max_new_tokens=MAX_NEW,
            max_len=MAX_LEN)[0].tolist()
        assert jax_out == torch_out
        return torch_out

    def close(self):
        async def stop_all():
            for server in reversed(self.servers):
                await server.stop()

        self.call(stop_all())
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(timeout=10)


@pytest.fixture(scope="module")
def fleet():
    mp = pytest.MonkeyPatch()
    adopt = ref_pool.MuxConnection.adopt

    def adopt_and_keep(self, reader, writer):
        self._kept_writer = writer
        return adopt(self, reader, writer)

    mp.setattr(ref_pool.MuxConnection, "adopt", adopt_and_keep)
    f = _Fleet()
    try:
        yield f
    finally:
        f.close()
        mp.undo()


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_kv_pull_readmits_and_decodes_like_a_local_prefill(
        fleet, direction):
    src, dst = ((fleet.jax, fleet.torch) if direction == "jax_to_torch"
                else (fleet.torch, fleet.jax))
    row = _row(1 if direction == "jax_to_torch" else 2)
    status, text, _ = _post(src.port, "/v1/prefill", {"tokens": [row]})
    assert status == 200 and json.loads(text) == {
        "ok": True, "cached": True, "tokens_prefilled": len(row)}
    before = _readmitted(dst.port)
    status, text, _ = _post(dst.port, "/v1/kv/pull", {
        "tokens": [row], "from": f"127.0.0.1:{src.port}"})
    assert status == 200, text
    # k and v of one full-length row (float32) plus the int32 pos
    assert json.loads(text)["bytes"] == 2 * 1 * MAX_LEN * 2 * 16 * 4 + 4
    assert _model(dst.port)["kv_spill"]["entries"] >= 1
    assert _generate(dst.port, row) == fleet.want(row)
    assert _readmitted(dst.port) == before + 1
    assert _generate(src.port, row) == fleet.want(row)


def test_kv_pull_failures_cache_nothing(fleet):
    row = _row(3)  # prefilled nowhere
    spill = _model(fleet.torch.port)["kv_spill"]
    status, _text, _ = _post(fleet.torch.port, "/v1/kv/pull", {
        "tokens": [row], "from": f"127.0.0.1:{fleet.jax.port}"})
    assert status == 502
    assert _model(fleet.torch.port)["kv_spill"]["spilled"] == (
        spill["spilled"])
    assert _post(fleet.torch.port, "/v1/kv", {"tokens": [row]})[0] == 404
    assert _post(fleet.torch.port, "/v1/kv/pull", {
        "tokens": [row], "from": "nowhere"})[0] == 422
    assert _post(fleet.torch.port, "/v1/kv?chunk=x",
                 {"tokens": [row]})[0] == 422
    plain = fleet.call(fleet.start(fleet.torch_server(kv_spill_bytes=0)))
    assert _post(plain.port, "/v1/kv/pull", {
        "tokens": [row], "from": f"127.0.0.1:{fleet.jax.port}"})[0] == 409


def test_model_info_kv_spill_schema_is_the_references(fleet):
    jax_info, torch_info = _model(fleet.jax.port), _model(fleet.torch.port)
    assert set(jax_info) <= set(torch_info)
    assert jax_info["kv_spill"].keys() == torch_info["kv_spill"].keys()
    assert jax_info["prefix_cache"].keys() == (
        torch_info["prefix_cache"].keys())


def test_weights_fetched_both_ways_rebuild_bit_equal(fleet):
    fetched = fleet.call(standby.fetch_params(
        "127.0.0.1", fleet.jax.port, fleet.tp))
    assert fetched is not None
    for (name, a), (_n, b) in zip(standby.param_leaves(fetched),
                                  standby.param_leaves(fleet.tp)):
        assert a.dtype == b.dtype and torch.equal(a, b), name
    back = fleet.call(ref_standby.fetch_params(
        "127.0.0.1", fleet.torch.port, fleet.jp))
    assert back is not None
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(fleet.jp)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # resuming mid-stream: the same manifest, then the chunks from K on
    with urllib.request.urlopen(
            f"http://127.0.0.1:{fleet.torch.port}/v1/weights?chunk=1",
            timeout=60) as resp:
        raw = resp.read()
    n = int.from_bytes(raw[:8], "big")
    manifest = json.loads(raw[8:8 + n])
    assert manifest == standby.weights_manifest(fleet.tp)
    assert len(raw) - 8 - n == sum(c["len"] for c in manifest["chunks"][1:])
    assert _get(fleet.torch.port, "/v1/weights?chunk=-1")[0] == 422


def test_draining_torch_replica_migrates_session_to_jax_survivor(
        fleet, tmp_path):
    root = str(tmp_path / "catalog")
    row = _row(4)
    drainer = fleet.call(fleet.start(fleet.torch_server()))
    assert _generate(drainer.port, row) == fleet.want(row)  # cached

    async def scenario():
        survivor = RefMember(fleet.jax, RefCatalog(root), "inference",
                             ttl=5, heartbeat_interval=0.05,
                             instance_id="jax-1")
        member = FleetMember(drainer, FileCatalogBackend(root),
                             "inference", ttl=5, heartbeat_interval=0.05,
                             instance_id="torch-2", migrate_window=30.0)
        await survivor.start()
        await member.start()
        try:
            for _ in range(200):
                if len(RefCatalog(root).instances("inference")) == 2:
                    break
                await asyncio.sleep(0.05)
            drained = await member.drain(timeout=10.0)
        finally:
            await member.stop(deregister=False)
            await survivor.stop()
        return drained

    before = _readmitted(fleet.jax.port)
    assert fleet.call(scenario(), timeout=120) is True
    counters, landed = ref_parse_mg(drainer.migrate_note())
    assert counters["done"] == counters["total"] == 1
    assert landed == {prefix_fingerprint(row): "jax-1"}
    status, _text, headers = _post(drainer.port, "/v1/generate",
                                   {"tokens": [row], "max_new_tokens": 4})
    headers = {k.lower(): v for k, v in headers.items()}
    assert status == 503
    assert headers["x-cp-migrated-to"] == "jax-1"
    assert int(headers["retry-after"]) >= 1
    report = json.loads(_post(drainer.port, "/v1/migrate", {})[1])
    assert report["landed"] == {f"{prefix_fingerprint(row):08x}": "jax-1"}
    assert _generate(fleet.jax.port, row) == fleet.want(row)
    assert _readmitted(fleet.jax.port) == before + 1


def test_standby_refuses_until_promoted(fleet):
    server = fleet.call(fleet.start(fleet.torch_server(role="standby")))
    body = {"tokens": [[1, 2, 3]], "max_new_tokens": 4}
    health = _get(server.port, "/health")
    refused = _post(server.port, "/v1/generate", body)
    assert health[0] == 503 and "standby" in health[1]
    assert refused[0] == 503 and "standby" in refused[1]
    assert {k.lower(): v for k, v in refused[2].items()}["retry-after"]
    assert _post(server.port, "/v1/score", {"tokens": [[1, 2, 3, 4]]})[0] \
        == 200
    server.enter_maintenance()
    assert _post(server.port, "/v3/standby/promote")[0] == 409
    server.exit_maintenance()
    first = _post(server.port, "/v3/standby/promote")
    assert first[0] == 200 and json.loads(first[1])["promoted"]
    assert _post(server.port, "/v3/standby/promote")[0] == 409
    assert _post(server.port, "/v1/generate", body)[0] == 200
    assert _get(server.port, "/health")[0] == 200
