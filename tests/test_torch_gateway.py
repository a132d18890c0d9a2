"""A torch replica behind the reference fleet gateway, beside a JAX
replica on the same params (tests/test_fleet.py:304-383's wiring: both
registered in a FileCatalogBackend by the reference FleetMember). The
gateway routes greedy requests to both over cp-mux/1, then with the
torch replica on ``mux=False`` over its HTTP/1.1 fallback; every answer
carries the same tokens, and the gateway's trace of a request the torch
replica served splices that replica's ``replica.*`` spans.

The reference gateway's mux dial drops the upgraded connection's
``StreamWriter``; on CPython 3.12 ``StreamWriter.__del__`` then closes
the socket (ROADMAP.md queue 3). The ``keep_mux_writer`` fixture holds
the writer for this file's gateway, so the test exercises the torch
replica rather than that defect; the port's own client keeps it."""
import asyncio
import json
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from containerpilot_tpu.discovery import FileCatalogBackend
from containerpilot_tpu.fleet import FleetGateway, FleetMember
from containerpilot_tpu.fleet import pool as ref_pool
from containerpilot_tpu.models import decode as jdecode
from containerpilot_tpu.models import transformer as jtf
from containerpilot_tpu.workload.serve import (
    InferenceServer as JaxServer,
)
from containerpilot_tpu_torch import bridge
from containerpilot_tpu_torch.models import transformer as ttf
from containerpilot_tpu_torch.workload.serve import InferenceServer

BASE = dict(vocab_size=64, d_model=32, n_heads=2, n_layers=1, d_ff=64,
            max_seq_len=64, dtype="float32")
MAX_LEN = 64
PROMPT = [1, 2, 3, 4, 5]
MAX_NEW = 12


@pytest.fixture
def keep_mux_writer(monkeypatch):
    adopt = ref_pool.MuxConnection.adopt

    def adopt_and_keep(self, reader, writer):
        self._kept_writer = writer
        return adopt(self, reader, writer)

    monkeypatch.setattr(ref_pool.MuxConnection, "adopt", adopt_and_keep)


def _post(port, path, payload, timeout=120):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, resp.read().decode(), dict(resp.headers)
    except urllib.error.HTTPError as exc:
        return exc.code, exc.read().decode(), dict(exc.headers)


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=60) as resp:
        return json.loads(resp.read().decode())


async def _burst(loop, port, n):
    return await asyncio.gather(*(
        loop.run_in_executor(None, _post, port, "/v1/generate",
                             {"tokens": [PROMPT], "max_new_tokens": MAX_NEW})
        for _ in range(n)))


def test_gateway_routes_to_torch_replica_over_mux_and_http11(
        run, tmp_path, keep_mux_writer):
    jcfg = jtf.TransformerConfig(**{**BASE, "dtype": jnp.float32})
    jp = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    tp = bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                "cpu")
    tcfg = ttf.TransformerConfig(**bridge.config_kwargs(BASE))
    want = np.asarray(jdecode.generate(
        jp, jnp.asarray([PROMPT], jnp.int32), jcfg, max_new_tokens=16,
        max_len=MAX_LEN)).tolist()[0][:MAX_NEW]
    backend = FileCatalogBackend(str(tmp_path / "catalog"))

    def torch_replica(mux):
        return InferenceServer(tcfg, tp, "127.0.0.1", 0, MAX_LEN, slots=2,
                               slot_chunk=4, device="cpu", mux=mux)

    async def until(pred, what, tries=200):
        for _ in range(tries):
            if pred():
                return
            await asyncio.sleep(0.05)
        raise AssertionError(f"timed out waiting for {what}")

    async def route_until_served(loop, gateway, served):
        """Bursts through the gateway until ``served()`` (what the
        replicas under test answered) is positive -> every answer's
        (status, text, headers)."""
        answers = []
        for _ in range(10):
            answers += await _burst(loop, gateway.port, 6)
            if served() > 0:
                break
        return answers

    async def get(port, path):
        return await asyncio.get_running_loop().run_in_executor(
            None, _get, port, path)

    async def scenario():
        loop = asyncio.get_running_loop()
        jax_server = JaxServer(jcfg, jp, "127.0.0.1", 0, max_len=MAX_LEN,
                               slots=2, slot_chunk=4)
        torch_mux = torch_replica(True)
        await jax_server.run()
        await torch_mux.run()
        members = [
            FleetMember(jax_server, backend, "inference", ttl=5,
                        heartbeat_interval=0.1, instance_id="jax-1"),
            FleetMember(torch_mux, backend, "inference", ttl=5,
                        heartbeat_interval=0.1, instance_id="torch-1"),
        ]
        for member in members:
            await member.start()
        gateway = FleetGateway(backend, "inference", "127.0.0.1", 0,
                               poll_interval=0.1, hedge=False,
                               retry_backoff=0.01)
        await gateway.run()
        out = {}
        try:
            await until(lambda: gateway.replica_count == 2, "2 replicas")
            out["mux_answers"] = await route_until_served(
                loop, gateway, lambda: min(
                    torch_mux._server.mux_streams_served,
                    jax_server._server.mux_streams_served))
            out["mux_torch_streams"] = torch_mux._server.mux_streams_served
            out["mux_jax_streams"] = jax_server._server.mux_streams_served
            fleet = await get(gateway.port, "/fleet")
            out["fleet_mux"] = {r["id"]: r["mux"]
                                for r in fleet["replicas"]}
            replica_ids = {
                t["trace_id"]
                for t in (await get(torch_mux.port, "/v1/traces"))["recent"]
                if t["endpoint"] == "generate"}
            gw_traces = (await get(gateway.port, "/v1/traces"))["recent"]
            out["spliced"] = [
                [s["stage"] for s in t["spans"]] for t in gw_traces
                if t["trace_id"] in replica_ids]
            # the torch replica again, now plain HTTP/1.1
            await members[1].stop()
            await torch_mux.stop()
            torch_plain = torch_replica(False)
            await torch_plain.run()
            members[1] = FleetMember(torch_plain, backend, "inference",
                                     ttl=5, heartbeat_interval=0.1,
                                     instance_id="torch-2")
            await members[1].start()
            await until(lambda: set(gateway._replicas) == {"jax-1",
                                                           "torch-2"},
                        "the plain torch replica")
            out["plain_answers"] = await route_until_served(
                loop, gateway, lambda: torch_plain._server.requests_served)
            out["plain_torch"] = (torch_plain._server.requests_served,
                                  torch_plain._server.mux_connections)
            fleet = await get(gateway.port, "/fleet")
            out["fleet_plain"] = {r["id"]: r["mux"]
                                  for r in fleet["replicas"]}
            await torch_plain.stop()
        finally:
            await gateway.stop()
            for member in members:
                await member.stop()
            await jax_server.stop()
        return out

    out = run(scenario(), timeout=600)
    for key in ("mux_answers", "plain_answers"):
        assert out[key]
        for status, text, _headers in out[key]:
            assert status == 200, text
            assert json.loads(text)["tokens"] == [want]
    assert out["mux_torch_streams"] >= 1 and out["mux_jax_streams"] >= 1
    assert out["fleet_mux"]["torch-1"]["connected"] is True
    assert out["fleet_mux"]["torch-1"]["unsupported"] is False
    assert out["spliced"], "no gateway trace of a torch-served request"
    for stages in out["spliced"]:
        replica = [s for s in stages if s.startswith("replica.")]
        assert replica[:3] == ["replica.slot_queue_wait", "replica.prefill",
                               "replica.decode"], stages
    served, mux_conns = out["plain_torch"]
    assert served >= 2 and mux_conns == 0  # the declined probe, then work
    assert out["fleet_plain"]["torch-2"]["unsupported"] is True
