"""The chaos harness's seams in the port, held to the reference's.

``InferenceServer.chaos_hook`` is awaited inside a request's in-flight
window (so a request parked in an injected delay holds off a drain) and
at warm-up inside the ``compile_warmup`` attribution (so a slow boot
shows as compile badput); ``InferenceServer.abort()`` drops the listener
and every live connection with no drain. Each case runs on a JAX and a
torch replica of the same tiny model. The loopcheck cases of
``tests/test_analysis.py`` (``LoopLagProbe``, ``TaskWatchdog``) run once
on each package (``tests/torch_twins.py``)."""
import asyncio
import json
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_twins
from containerpilot_tpu.discovery import FileCatalogBackend as JaxBackend
from containerpilot_tpu.fleet import FleetMember as JaxMember
from containerpilot_tpu.models import transformer as jtf
from containerpilot_tpu.workload.serve import InferenceServer as JaxServer
from containerpilot_tpu_torch import bridge
from containerpilot_tpu_torch.discovery import FileCatalogBackend
from containerpilot_tpu_torch.fleet import FleetMember
from containerpilot_tpu_torch.models import transformer as ttf
from containerpilot_tpu_torch.workload.serve import InferenceServer

BASE = dict(vocab_size=64, d_model=32, n_heads=2, n_layers=1, d_ff=64,
            max_seq_len=64, dtype="float32")
LOOPCHECK_CASES = (
    "test_loopcheck_records_injected_stall",
    "test_loopcheck_clean_loop_reports_near_zero",
    "test_loopcheck_probe_stop_is_idempotent",
    "test_loopcheck_watchdog_captures_leaked_exception",
    "test_loopcheck_watchdog_ignores_handled_and_cancelled",
)


@pytest.fixture(scope="module")
def models():
    jcfg = jtf.TransformerConfig(**{**BASE, "dtype": jnp.float32})
    jp = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    tp = bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                "cpu")
    return {"jax": (jcfg, jp),
            "torch": (ttf.TransformerConfig(**bridge.config_kwargs(BASE)),
                      tp)}


def _server(package, models):
    cfg, params = models[package]
    if package == "jax":
        return JaxServer(cfg, params, "127.0.0.1", 0, max_len=64, slots=2,
                         slot_chunk=4)
    return InferenceServer(cfg, params, "127.0.0.1", 0, 64, slots=2,
                           slot_chunk=4, device="cpu")


def _post(port, payload, timeout=30):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/generate",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, json.loads(resp.read().decode())


@pytest.mark.parametrize("package", torch_twins.PACKAGES)
def test_slow_boot_parks_warmup_as_compile_badput(package, models, run):
    """tests/test_standby.py:390's case on either replica: an injected
    slow boot delays ready AND lands in compile_warmup."""

    async def scenario():
        server = _server(package, models)

        async def hook(endpoint):
            if endpoint == "warmup":
                await asyncio.sleep(0.4)

        server.chaos_hook = hook
        t0 = time.monotonic()
        await server.run()
        boot_s = time.monotonic() - t0
        totals = server.ledger.totals()
        await server.stop()
        return boot_s, totals

    boot_s, totals = run(scenario(), timeout=120)
    assert boot_s >= 0.4
    assert totals["compile_warmup"] >= 0.4


@pytest.mark.parametrize("package", torch_twins.PACKAGES)
def test_delayed_generate_holds_off_a_drain(package, models, run,
                                            tmp_path):
    """A generate parked in the hook is in flight: the member's drain
    waits it out, and the request still answers 200."""

    async def scenario():
        loop = asyncio.get_running_loop()
        server = _server(package, models)
        await server.run()
        backend = (JaxBackend if package == "jax" else FileCatalogBackend)(
            str(tmp_path))
        member = (JaxMember if package == "jax" else FleetMember)(
            server, backend, "inference", ttl=5, heartbeat_interval=0.1,
            instance_id="r-1")
        await member.start()
        endpoints = []

        async def hook(endpoint):
            endpoints.append(endpoint)
            if endpoint == "generate":
                await asyncio.sleep(0.6)

        server.chaos_hook = hook
        request = loop.run_in_executor(
            None, _post, server.port,
            {"tokens": [[1, 2, 3]], "max_new_tokens": 4})
        for _ in range(200):
            if endpoints:
                break
            await asyncio.sleep(0.01)
        t0 = time.monotonic()
        idle = await member.drain(timeout=10.0)
        drain_s = time.monotonic() - t0
        status, body = await request
        await member.stop(deregister=True)
        await server.stop()
        return endpoints, idle, drain_s, status, body

    endpoints, idle, drain_s, status, body = run(scenario(), timeout=120)
    assert endpoints == ["generate"]
    assert idle is True
    assert drain_s >= 0.4  # the parked request held the drain
    assert status == 200 and len(body["tokens"][0]) == 4


@pytest.mark.parametrize("package", torch_twins.PACKAGES)
def test_abort_drops_live_connections(package, models, run):
    """abort() is SIGKILL for the replica: a request in flight gets no
    answer (its connection drops), and the port stops accepting."""

    async def scenario():
        loop = asyncio.get_running_loop()
        server = _server(package, models)
        await server.run()
        port = server.port
        entered = asyncio.Event()

        async def hook(endpoint):
            entered.set()
            await asyncio.sleep(5.0)

        server.chaos_hook = hook
        request = loop.run_in_executor(
            None, _post, port, {"tokens": [[1, 2, 3]], "max_new_tokens": 4})
        await asyncio.wait_for(entered.wait(), 10)
        t0 = time.monotonic()
        await server.abort()
        try:
            await request
            outcome = "answered"
        except (urllib.error.URLError, ConnectionError, OSError) as exc:
            outcome = type(exc).__name__
        dropped_s = time.monotonic() - t0
        try:
            await asyncio.open_connection("127.0.0.1", port)
            refused = False
        except OSError:
            refused = True
        return outcome, dropped_s, refused, server.ready

    outcome, dropped_s, refused, ready = run(scenario(), timeout=120)
    assert outcome != "answered"
    assert dropped_s < 4.0  # dropped, not drained past the hook's sleep
    assert refused is True
    assert ready is False


@pytest.fixture(scope="module")
def analysis_twins():
    return {pkg: torch_twins.load(
        "test_analysis", pkg, drop_imports=("containerpilot_tpu.analysis",))
        for pkg in torch_twins.PACKAGES}


@pytest.mark.parametrize("package", torch_twins.PACKAGES)
@pytest.mark.parametrize("case", LOOPCHECK_CASES)
def test_loopcheck_case(case, package, analysis_twins, run):
    fn = getattr(analysis_twins[package], case)
    fn(**torch_twins.case_args(fn, {"run": run}))
