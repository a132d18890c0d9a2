"""The capstone mirror for the port: supervised multi-process training
e2e with the port's ranks (``tests/torch_capstone_worker.py``) under the
reference supervisor, crashed and resumed.

N supervisor instances (the real CLI, real configs) each run one worker
job. The workers rendezvous through a live catalog server
(``-catalog-server``, the supervisor's own daemon) as a
``torch.distributed`` world over gloo on the CPU (dp2 at N=2, dp2 x tp2
at N=4), checkpoint every step in lockstep on one shared directory, and
one worker crashes mid-run. Its peers lose a rank and exit non-zero (a
gloo error, or the step watchdog for a silent wait); every supervisor
applies its restart budget; the reincarnated world re-rendezvouses and
resumes from the latest checkpoint.

Asserted, as ``tests/test_capstone.py:153-160`` asserts for the
reference: every supervisor exits 0, the crash fired, every worker
resumed (``resumed_from`` > 0) with the same final loss (1e-5), the loss
(1e-4) and the params digest (rel 1e-5) equal a one-process run of the
same schedule, and the catalog timeline shows the crashing worker
passing, gone and back. The workers pace their steps to
``MIN_STEP_S`` (the reference's steps take that long to compile and
run) and the health check takes a 1-second TTL, so the crash leaves a
gap the catalog can see within seconds.
"""
import json
import os
import socket
import subprocess
import sys
import threading
import time

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_capstone_worker.py")

STEPS = 6
CRASH_STEP = 2
GLOBAL_BATCH = 8
MIN_STEP_S = 1.0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _sub_env() -> dict:
    return dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
                JAX_PLATFORMS="cpu")


def _wait_http(url: str, deadline_s: float = 30) -> None:
    import urllib.request

    deadline = time.monotonic() + deadline_s
    while True:
        try:
            urllib.request.urlopen(url, timeout=1)
            return
        except Exception:
            if time.monotonic() > deadline:
                raise TimeoutError(f"never reachable: {url}")
            time.sleep(0.2)


def _supervisor_config(tmp_path, idx, catalog_port, coord_port, job_port,
                       crash_idx, n_procs, tp):
    ckpt = tmp_path / "ckpt"  # ONE shared checkpoint dir for the world
    heartbeat = tmp_path / f"heartbeat{idx}"
    exec_argv = [
        sys.executable, WORKER,
        "--process-id", str(idx),
        "--num-processes", str(n_procs),
        "--catalog", f"127.0.0.1:{catalog_port}",
        "--coordinator-port", str(coord_port),
        "--steps", str(STEPS),
        "--global-batch", str(GLOBAL_BATCH),
        "--checkpoint-dir", str(ckpt),
        "--out", str(tmp_path / f"out{idx}.json"),
        "--step-timeout", "20",
        "--startup-timeout", "60",
        "--heartbeat-file", str(heartbeat),
        "--min-step-s", str(MIN_STEP_S),
        "--tp", str(tp),
    ]
    if idx == crash_idx:
        exec_argv += ["--crash-step", str(CRASH_STEP),
                      "--crash-sentinel", str(tmp_path / "crash-sentinel")]
    config = {
        "consul": f"127.0.0.1:{catalog_port}",
        "stopTimeout": "5s",
        "logging": {"level": "INFO", "format": "default",
                    "output": "stdout"},
        "jobs": [{
            "name": f"trainer{idx}",
            "exec": exec_argv,
            # the injected crash, peers' exits, rendezvous races, the
            # rerun and the already-complete no-ops
            "restarts": 4 + max(0, n_procs - 2),
            "port": job_port,
            "interfaces": ["static:127.0.0.1"],
            # progress-based health: passing only while the per-step
            # heartbeat file is under 2 s old, so a crash lapses the TTL
            "health": {
                "exec": ["/bin/sh", "-c",
                         f'test -f "{heartbeat}" && '
                         f'test "$(( $(date +%s) - '
                         f'$(stat -c %Y "{heartbeat}") ))" -lt 2'],
                "interval": 1, "ttl": 1,
            },
        }],
    }
    path = tmp_path / f"host{idx}.json5"
    path.write_text(json.dumps(config))
    return str(path)


@pytest.mark.parametrize(
    "n_procs,tp,crash_idx", [(2, 0, 0), (4, 2, 1)],
    ids=["coordinator-crash", "dp2xtp2-worker-crash"],
)
def test_supervised_torch_ranks_crash_and_resume(tmp_path, n_procs, tp,
                                                 crash_idx):
    """crash_idx=0 kills the process HOSTING the rendezvous store: the
    reincarnated rank 0 clears the stale ``torch-coordinator``
    registration and re-registers, and the peer's restart finds it. The
    dp2 x tp2 variant crashes rank 1 of four, so tensor parallelism and
    the lockstep checkpoint cross the crash."""
    from containerpilot_tpu.discovery.consul import ConsulBackend

    catalog_port, coord_port = _free_port(), _free_port()
    job_ports = tuple(_free_port() for _ in range(n_procs))
    env = _sub_env()
    catalog = subprocess.Popen(
        [sys.executable, "-m", "containerpilot_tpu",
         "-catalog-server", f"127.0.0.1:{catalog_port}"],
        cwd=REPO, env=env, stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL)
    supervisors, logs, timeline = [], [], []
    stop_poll = threading.Event()
    try:
        _wait_http(f"http://127.0.0.1:{catalog_port}/v1/health/service/none")
        for idx in range(n_procs):
            cfg_path = _supervisor_config(
                tmp_path, idx, catalog_port, coord_port, job_ports[idx],
                crash_idx, n_procs, tp)
            log_fh = open(tmp_path / f"sup{idx}.log", "w")
            logs.append(log_fh)
            supervisors.append(subprocess.Popen(
                [sys.executable, "-m", "containerpilot_tpu", "-config",
                 cfg_path], cwd=REPO, env=env, stdout=log_fh,
                stderr=subprocess.STDOUT))
        backend = ConsulBackend(address=f"127.0.0.1:{catalog_port}")

        def poll_catalog() -> None:
            while not stop_poll.is_set():
                try:
                    present = bool(backend.instances(f"trainer{crash_idx}"))
                    timeline.append((time.monotonic(), present))
                except Exception:
                    pass
                stop_poll.wait(0.2)

        poller = threading.Thread(target=poll_catalog, daemon=True)
        poller.start()
        deadline = time.monotonic() + 240
        for proc in supervisors:
            try:
                proc.wait(timeout=max(5.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                pytest.fail("supervisor did not exit; logs:\n" + "\n".join(
                    (tmp_path / f"sup{i}.log").read_text()[-3000:]
                    for i in range(n_procs)))
        stop_poll.set()
        poller.join(timeout=5)

        for i, proc in enumerate(supervisors):
            assert proc.returncode == 0, (
                f"supervisor {i} rc={proc.returncode}:\n"
                + (tmp_path / f"sup{i}.log").read_text()[-3000:])
        assert (tmp_path / "crash-sentinel").exists()
        outs = []
        for idx in range(n_procs):
            out_path = tmp_path / f"out{idx}.json"
            assert out_path.exists(), (
                f"worker {idx} never finished:\n"
                + (tmp_path / f"sup{idx}.log").read_text()[-3000:])
            outs.append(json.loads(out_path.read_text()))
        for out in outs:
            assert out["resumed_from"] > 0, out
            assert out["final_loss"] == pytest.approx(
                outs[0]["final_loss"], abs=1e-5)

        base_out = tmp_path / "baseline.json"
        baseline = subprocess.run(
            [sys.executable, WORKER, "--process-id", "0",
             "--num-processes", "1", "--steps", str(STEPS),
             "--global-batch", str(GLOBAL_BATCH),
             "--checkpoint-dir", str(tmp_path / "ckpt-base"),
             "--out", str(base_out), "--tp", "1"],
            cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
        assert baseline.returncode == 0, baseline.stdout[-2000:]
        base = json.loads(base_out.read_text())
        assert outs[0]["final_loss"] == pytest.approx(base["final_loss"],
                                                      abs=1e-4)
        assert outs[0]["params_digest"] == pytest.approx(
            base["params_digest"], rel=1e-5)

        saw_present = saw_gap = saw_return = False
        for _, present in timeline:
            if present and not saw_present:
                saw_present = True
            elif saw_present and not present:
                saw_gap = True
            elif saw_gap and present:
                saw_return = True
        assert saw_present and saw_gap and saw_return, (
            "catalog timeline never showed a restart gap: "
            f"{[(round(t, 1), p) for t, p in timeline]}")
    finally:
        stop_poll.set()
        for proc in supervisors:
            if proc.poll() is None:
                proc.terminate()
        for proc in supervisors:
            try:
                proc.wait(timeout=15)
            except subprocess.TimeoutExpired:
                proc.kill()
        catalog.terminate()
        catalog.wait(timeout=10)
        for fh in logs:
            fh.close()
