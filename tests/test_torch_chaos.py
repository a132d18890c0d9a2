"""The port's chaos harness against the reference's.

``test_chaos_case`` runs the unit cases of ``tests/test_chaos.py``
(trace generation, the SLO scorer, the gateway's hold-down and retry
jitter, ``ChaosProxy``, ``FlakyBackend``, the client's Retry-After
discipline) once on each package (``tests/torch_twins.py``). On top of
them: the port's trace for a seed equals the reference's request for
request for every scenario; the two scorers give the same score on the
same records; two scenarios run on the port's replicas on the CPU and
clear the scenario's own bars as ``tests/test_chaos.py`` states them
(``kill_spare`` through the chaos CLI in a subprocess, which also pins
that the CLI loads no jax, no ``prometheus_client``, no ``json5`` and
nothing of the JAX package, and ``kill_under_burst_promoted`` in this
process); and the gateway CLI (``python -m
containerpilot_tpu_torch.fleet``) serves ``/fleet`` and ``/metrics``
from a file catalog with the same imports pinned and CUDA left
uninitialized."""
import asyncio
import dataclasses
import json
import os
import random
import signal
import socket
import subprocess
import sys
import time
import urllib.request

import pytest
import torch

import torch_twins
from torch_twins import keep_mux_writer  # noqa: F401 (a fixture)
from containerpilot_tpu import chaos as ref_chaos
from containerpilot_tpu_torch import chaos
from containerpilot_tpu_torch.chaos import scenarios as port_scenarios
from containerpilot_tpu_torch.discovery import (
    FileCatalogBackend,
    ServiceRegistration,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CASES = (
    "test_trace_is_deterministic_under_a_seed",
    "test_trace_has_the_advertised_structure",
    "test_slo_scorer_goodput_and_failure_ledger",
    "test_tpot_math",
    "test_holddown_damps_transient_empty_polls",
    "test_holddown_window_resets_on_healthy_poll",
    "test_flaky_backend_budget_is_per_poll_cycle",
    "test_retry_jitter_bounded_and_seeded",
    "test_all_replicas_down_fast_503_then_recovery",
    "test_chaos_proxy_resets_mid_response",
    "test_member_advertises_override_port",
    "test_slo_scorer_counts_sheds_apart_from_failures",
    "test_client_honors_retry_after_then_succeeds",
    "test_client_marks_final_shed_and_never_retries_504",
    "test_trace_batch_priority_is_seeded_and_optional",
    "test_multiturn_trace_grows_shared_prefixes",
)

#: every module a CLI of the port must not load
FORBIDDEN = ("jax", "jaxlib", "json5", "prometheus_client",
             "containerpilot_tpu")

#: run a CLI's ``main`` (argv after the script), then report its exit
#: code, any forbidden module it loaded and whether CUDA was touched
PROBE = (
    "import json, runpy, sys\n"
    "module, argv = sys.argv[1], sys.argv[2:]\n"
    "sys.argv = [module, *argv]\n"
    "rc = 0\n"
    "try:\n"
    "    runpy.run_module(module, run_name='__main__')\n"
    "except SystemExit as exc:\n"
    "    rc = exc.code\n"
    "import torch\n"
    f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
    "print(json.dumps({'rc': rc, 'bad': bad,\n"
    "                  'cuda': torch.cuda.is_initialized()}))\n"
)


@pytest.fixture(scope="module")
def twins():
    return {pkg: torch_twins.load("test_chaos", pkg)
            for pkg in torch_twins.PACKAGES}


@pytest.mark.parametrize("package", torch_twins.PACKAGES)
@pytest.mark.parametrize("case", CASES)
def test_chaos_case(case, package, twins, run, tmp_path, keep_mux_writer):
    fn = getattr(twins[package], case)
    fn(**torch_twins.case_args(fn, {"run": run, "tmp_path": tmp_path}))


def test_same_scenario_registry_and_traces():
    assert list(chaos.SCENARIOS) == list(ref_chaos.SCENARIOS)
    for name, spec in chaos.SCENARIOS.items():
        ref_spec = ref_chaos.SCENARIOS[name]
        assert dataclasses.asdict(spec.trace) == dataclasses.asdict(
            ref_spec.trace), name
        assert spec.faults == tuple(
            chaos.Fault(**dataclasses.asdict(f)) for f in ref_spec.faults)
        for seed in (0, 5, 7):
            port = chaos.generate_trace(
                dataclasses.replace(spec.trace, seed=seed))
            ref = ref_chaos.generate_trace(
                dataclasses.replace(ref_spec.trace, seed=seed))
            assert ([dataclasses.asdict(r) for r in port]
                    == [dataclasses.asdict(r) for r in ref]), (name, seed)
            assert chaos.trace_summary(port) == ref_chaos.trace_summary(ref)


def _records(module, seed):
    """Seeded records covering every outcome the scorer tells apart."""
    rng = random.Random(seed)
    out = []
    for i in range(200):
        kind = rng.choice(["ok", "ok", "ok", "slow", "5xx", "err", "shed",
                           "trunc", "abandon"])
        start = rng.uniform(0.0, 5.0)
        out.append(module.RequestRecord(
            i, f"s{i % 7}", start, start + rng.uniform(0.05, 3.0),
            status={"5xx": 503, "err": 0, "shed": 429}.get(kind, 200),
            ttft_s=(rng.uniform(0.01, 2.0)
                    if kind not in ("5xx", "err", "shed") else None),
            tokens_out=rng.randint(0, 16),
            stream=kind in ("trunc", "abandon") or rng.random() < 0.3,
            abandoned=kind == "abandon", error="Reset" if kind == "err"
            else "", truncated=kind == "trunc", shed=kind == "shed",
            retry_after_quoted=kind == "shed",
            client_retries=rng.randint(0, 2) if kind == "shed" else 0,
            saw_5xx=kind == "5xx"))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_same_score_on_the_same_records(seed):
    for slo_kw in ({}, {"ttft_s": 0.5, "tpot_s": 0.1}):
        port = chaos.ScenarioScore(_records(chaos, seed), 5.0,
                                   chaos.SLO(**slo_kw)).as_dict()
        ref = ref_chaos.ScenarioScore(_records(ref_chaos, seed), 5.0,
                                      ref_chaos.SLO(**slo_kw)).as_dict()
        assert port == ref


def _checked(report):
    """``tests/test_chaos.py``'s ``_run_scenario_checked`` bars."""
    assert report["passed"], json.dumps(report["checks"], indent=2)
    assert report["score"]["count_5xx"] == 0
    assert report["score"]["transport_errors"] == 0
    check_names = {c["name"] for c in report["checks"]}
    assert "loop_lag" in check_names
    assert report["loop_lag_max_ms"] == report["loop"]["lag_max_ms"]
    assert report["loop"]["heartbeats"] > 0
    assert report["loop"]["task_exceptions"] == []
    ledger = report["goodput_ledger"]
    assert set(ledger["stages_s"]) == {
        "boot", "compile_warmup", "idle", "prefill", "decode",
        "kv_readmit", "drain",
    }
    assert ledger["device_seconds"] == pytest.approx(
        sum(ledger["stages_s"].values()), abs=0.05)
    assert ledger["per_replica"]
    for entry in ledger["per_replica"].values():
        assert set(entry) == {"departed", "productive_fraction", "stages_s"}
    json.dumps(report)
    return report


def _env():
    return dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu",
                OMP_NUM_THREADS="1")


def test_chaos_cli_kill_spare_on_the_port(tmp_path):
    out = tmp_path / "report.json"
    done = subprocess.run(
        [sys.executable, "-c", PROBE, "containerpilot_tpu_torch.chaos",
         "--scenario", "kill_spare", "--seed", "5", "--device", "cpu",
         "--json", str(out)],
        cwd=REPO, env=_env(), capture_output=True, text=True, timeout=120)
    result = json.loads(done.stdout.strip().splitlines()[-1])
    assert result == {"rc": 0, "bad": [], "cuda": False}, done.stderr[-3000:]
    payload = json.loads(out.read_text())
    assert payload["passed"] is True
    report = _checked(payload["scenarios"][0])
    assert report["gateway"]["replicas_at_end"] == 2
    spec = chaos.SCENARIOS["kill_spare"]
    assert report["trace"] == ref_chaos.trace_summary(
        ref_chaos.generate_trace(dataclasses.replace(spec.trace, seed=5)))


def test_chaos_cli_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    done = subprocess.run(
        [sys.executable, "-m", "containerpilot_tpu_torch.chaos",
         "--scenario", "kill_spare"],
        cwd=REPO, env=_env(), capture_output=True, text=True, timeout=120)
    assert done.returncode != 0
    assert "CUDA is not available" in done.stderr


def test_port_scenario_kill_under_burst_promoted(tmp_path):
    report = _checked(asyncio.run(asyncio.wait_for(
        port_scenarios.run_scenario_async(
            chaos.SCENARIOS["kill_under_burst_promoted"], str(tmp_path),
            seed=5, device="cpu"),
        120)))
    scaler = report["autoscaler"]
    assert scaler["standby"]["promotions"] >= 1
    assert scaler["replicas"] == scaler["min_replicas"] == 2
    events = report["goodput_ledger"]["scale_events"]
    promoted = [e for e in events
                if e["direction"] == "up" and e.get("mode") == "promoted"]
    assert promoted
    finite = [e["ttfrt_s"] for e in promoted if e.get("ttfrt_s") is not None]
    assert finite and max(finite) <= 2.0
    check_names = {c["name"] for c in report["checks"]}
    assert "promoted_ttfrt_bound" in check_names
    assert "standby_promotions" in check_names
    assert report["fault_counts"].get("slow_boot") == 1


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _fetch(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=5) as resp:
        return resp.read().decode()


def test_gateway_cli_serves_a_file_catalog(tmp_path):
    """``python -m containerpilot_tpu_torch.fleet --catalog file:DIR``
    takes the reference CLI's flags, finds a registered replica, answers
    ``/fleet`` and ``/metrics``, drains on SIGTERM and exits 0, with no
    forbidden module loaded and CUDA untouched."""
    catalog = tmp_path / "catalog"
    backend = FileCatalogBackend(str(catalog))
    backend.service_register(ServiceRegistration(
        id="r-1", name="inference", port=_free_port(), ttl=60,
        address="127.0.0.1"), status="passing")
    port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-c", PROBE, "containerpilot_tpu_torch.fleet",
         "--catalog", f"file:{catalog}", "--host", "127.0.0.1",
         "--port", str(port), "--poll-interval", "0.1", "--no-hedge",
         "--retries", "1", "--affinity", "session", "--no-mux",
         "--admission-queue-depth", "8", "--drain-window", "2"],
        cwd=REPO, env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.monotonic() + 60
        fleet = None
        while time.monotonic() < deadline:
            try:
                fleet = json.loads(_fetch(port, "/fleet"))
                if fleet["replicas"]:
                    break
            except OSError:
                pass
            assert proc.poll() is None, proc.communicate()[1][-3000:]
            time.sleep(0.1)
        assert fleet and [r["id"] for r in fleet["replicas"]] == ["r-1"]
        metrics = _fetch(port, "/metrics")
        assert "containerpilot_gateway_healthy_replicas 1.0" in metrics
        assert 'cp_build_info{role="gateway"' in metrics
        proc.send_signal(signal.SIGTERM)
        stdout, stderr = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    result = json.loads(stdout.strip().splitlines()[-1])
    assert result == {"rc": 0, "bad": [], "cuda": False}, stderr[-3000:]
