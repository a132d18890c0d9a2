"""``python -m containerpilot_tpu_torch`` against ``python -m
containerpilot_tpu``: the two supervisor CLIs run the same config (a
tiny Python job, health-checked and advertised, with stopping/stopped
hooks) on their own package's ``-catalog-server``, side by side, and
must give the same catalog timeline (passing, maintenance, passing
after -reload, deregistered), the same ``/status`` and ``/metrics``
families, the same answers to every control verb, and the same exit
codes. A subprocess pins that the port's entry point loads no jax, no
json5 and nothing of the JAX package, and leaves CUDA uninitialized."""
import json
import os
import re
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = ("containerpilot_tpu", "containerpilot_tpu_torch")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env() -> dict:
    return dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu",
                OMP_NUM_THREADS="1")


def _get(url: str):
    with urllib.request.urlopen(url, timeout=5) as resp:
        return resp.status, resp.read().decode()


def _config(tmp, cat_port, tel_port) -> str:
    py = sys.executable
    config = {
        "consul": f"127.0.0.1:{cat_port}",
        "stopTimeout": "2s",
        "control": {"socket": str(tmp / "cp.socket")},
        "telemetry": {
            "port": tel_port, "interfaces": ["static:127.0.0.1"],
            "metrics": [
                {"name": "job_steps_total", "help": "steps",
                 "type": "counter"},
                {"name": "job_loss", "help": "loss", "type": "gauge"},
                {"namespace": "job", "name": "wait", "help": "wait s",
                 "type": "histogram"},
                {"name": "job_size", "help": "size", "type": "summary"},
            ],
        },
        "jobs": [
            {"name": "app",
             "exec": [py, "-c", "import time; time.sleep(600)"],
             "port": 7001, "interfaces": ["static:127.0.0.1"],
             "restarts": "unlimited",
             "health": {"exec": [py, "-c", "pass"], "interval": 1,
                        "ttl": 5}},
            {"name": "drain", "exec": [py, "-c", "print('app stopping')"],
             "when": {"once": "stopping", "source": "app"}},
            {"name": "release", "exec": [py, "-c", "print('app stopped')"],
             "when": {"once": "stopped", "source": "app"}},
        ],
    }
    path = tmp / "cp.json5"
    path.write_text("// the same config for both CLIs\n" + json.dumps(config))
    return str(path)


def _families(text: str):
    """{family: type} of a Prometheus exposition."""
    return dict(re.findall(r"^# TYPE (\S+) (\S+)$", text, re.M))


def _samples(text: str, prefix: str):
    return sorted(line for line in text.splitlines()
                  if line.startswith(prefix) and "_created" not in line)


def _scenario(package: str, tmp) -> dict:
    """One CLI's run of the scenario; everything observable, with pids
    and times left out."""
    tmp.mkdir()
    cat_port, tel_port = _free_port(), _free_port()
    config = _config(tmp, cat_port, tel_port)
    env = _env()
    out = {"timeline": []}

    def cli(*args):
        done = subprocess.run(
            [sys.executable, "-m", package, *args], cwd=REPO, env=env,
            capture_output=True, text=True, timeout=120)
        return (args[2:] if args[:1] == ("-config",) else args,
                done.returncode, done.stdout,
                done.stderr.strip().splitlines()[-1:])

    catalog = subprocess.Popen(
        [sys.executable, "-m", package, "-catalog-server",
         f"127.0.0.1:{cat_port}"], cwd=REPO, env=env,
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    log = open(tmp / "sup.log", "w")
    sup = None
    stop = threading.Event()

    def state():
        # one read a poll: two reads (``?passing=1``, then all) could
        # straddle a registration and see it absent, then present but
        # not passing, a "critical" the catalog never held
        entries = json.loads(_get(
            f"http://127.0.0.1:{cat_port}/v1/health/service/app")[1])
        if any(check["Status"] == "passing"
               for entry in entries for check in entry["Checks"]):
            return "passing"
        return "critical" if entries else "absent"

    def poll():
        while not stop.is_set():
            try:
                now = state()
                if not out["timeline"] or out["timeline"][-1] != now:
                    out["timeline"].append(now)
            except OSError:
                pass
            stop.wait(0.1)

    def wait_for(want, timeout=60):
        deadline = time.monotonic() + timeout
        while not out["timeline"] or out["timeline"][-1] != want:
            assert sup.poll() is None, (tmp / "sup.log").read_text()
            assert time.monotonic() < deadline, (want, out["timeline"])
            time.sleep(0.05)

    poller = threading.Thread(target=poll, daemon=True)
    # the verbs that need no running supervisor, meanwhile
    offline = ThreadPoolExecutor(4).map(lambda args: cli(*args), [
        ("-version",), ("-config", config, "-template"),
        ("-config", str(tmp / "missing.json5"), "-ping"),
        ("-config", config, "-putmetric", "no-equals-sign"),
        ("-config", config, "-putenv", "=nokey")])
    try:
        deadline = time.monotonic() + 60
        while True:
            try:
                _get(f"http://127.0.0.1:{cat_port}/v1/health/service/x")
                break
            except OSError:
                assert time.monotonic() < deadline, "catalog never answered"
                time.sleep(0.1)
        poller.start()
        sup = subprocess.Popen([sys.executable, "-m", package, "-config",
                                config], cwd=REPO, env=env, stdout=log,
                               stderr=subprocess.STDOUT)
        wait_for("passing")
        status = json.loads(_get(f"http://127.0.0.1:{tel_port}/status")[1])
        out["status"] = status
        verbs = list(ThreadPoolExecutor(3).map(lambda args: cli(*args), [
            ("-config", config, "-ping"),
            ("-config", config, "-putmetric", "job_steps_total=3",
             "-putmetric", "job_loss=1.5", "-putmetric", "job_wait=0.3",
             "-putmetric", "job_size=42"),
            ("-config", config, "-putenv", "CP_TEST_VAR=1")]))
        deadline = time.monotonic() + 10
        while True:  # the metric actors record the events
            metrics = _get(f"http://127.0.0.1:{tel_port}/metrics")[1]
            if "job_size_count 1.0" in metrics or (
                    time.monotonic() > deadline):
                break
            time.sleep(0.1)
        out["families"] = _families(metrics)
        out["samples"] = (
            _samples(metrics, "job_") + _samples(metrics, "cp_build_info")
            + _samples(metrics, "containerpilot_control_http_requests")
            + [line for line in _samples(metrics, "containerpilot_events")
               if 'code="metric"' in line])
        verbs.append(cli("-config", config, "-maintenance", "enable"))
        wait_for("absent")
        verbs.append(cli("-config", config, "-reload"))
        wait_for("passing")
        sup.send_signal(signal.SIGTERM)
        out["rc"] = sup.wait(timeout=60)
        time.sleep(0.5)
        text = (tmp / "sup.log").read_text()
        out["hooks"] = re.findall(r"app stopp(?:ing|ed)", text)
        verbs.append(cli("-config", config, "-ping"))  # nobody listens
        # the run's own directory and ports named alike in both runs
        text = json.dumps(verbs + list(offline)).replace(str(tmp), "<run>")
        for port, name in ((cat_port, "<catalog>"), (tel_port, "<tel>")):
            text = re.sub(rf"\b{port}\b", name, text)
        out["verbs"] = json.loads(text)
        catalog.send_signal(signal.SIGTERM)
        out["catalog_rc"] = catalog.wait(timeout=30)
    finally:
        stop.set()
        for proc in (sup, catalog):
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
        log.close()
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    with ThreadPoolExecutor(2) as pool:
        futures = {
            pkg: pool.submit(_scenario, pkg, tmp_path_factory.mktemp(pkg)
                             / "run")
            for pkg in PACKAGES}
        return {pkg: f.result() for pkg, f in futures.items()}


def test_same_catalog_timeline_and_exit_codes(runs):
    ref, port = (runs[p] for p in PACKAGES)
    # passing; maintenance takes the job out; -reload's generation
    # passes again; SIGTERM deregisters it
    assert ref["timeline"][-4:] == ["passing", "absent", "passing",
                                    "absent"], ref["timeline"]
    assert port["timeline"] == ref["timeline"]
    assert port["rc"] == ref["rc"] == 0
    assert port["catalog_rc"] == ref["catalog_rc"] == 0
    # the hooks run at -reload's stop of the first generation and at
    # SIGTERM's stop of the second
    assert port["hooks"] == ref["hooks"] == [
        "app stopping", "app stopped"] * 2


def test_same_status_and_metrics_families(runs):
    ref, port = (runs[p] for p in PACKAGES)
    assert port["status"] == ref["status"]
    assert port["families"] == ref["families"]
    assert port["samples"] == ref["samples"]
    assert "job_steps_total 3.0" in port["samples"]


def test_same_answers_to_every_control_verb(runs):
    ref, port = (runs[p] for p in PACKAGES)
    assert port["verbs"] == ref["verbs"]
    # -ping, -putmetric, -putenv, -maintenance, -reload; -ping after the
    # stop; -version, -template; a missing config, malformed pairs
    assert [v[1] for v in port["verbs"]] == [0, 0, 0, 0, 0, 1, 0, 0, 1, 1,
                                              1], port["verbs"]


def test_entry_point_loads_no_jax_and_leaves_cuda_alone(tmp_path):
    """-version and a short supervised run (a job that exits at once)
    load no jax, no json5, no prometheus_client and no module of the
    JAX package, and leave torch.cuda uninitialized."""
    config = tmp_path / "once.json5"
    config.write_text(json.dumps({
        "consul": f"file:{tmp_path / 'catalog'}",
        "stopTimeout": "10ms",
        "control": {"socket": str(tmp_path / "cp.socket")},
        "jobs": [{"name": "once", "exec": [sys.executable, "-c", "pass"]}],
    }))
    probe = (
        "import json, runpy, sys\n"
        "sys.argv = ['containerpilot_tpu_torch'] + sys.argv[1:]\n"
        "try:\n"
        "    runpy.run_module('containerpilot_tpu_torch',"
        " run_name='__main__')\n"
        "except SystemExit as exc:\n"
        "    rc = exc.code\n"
        "import torch\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'json5', 'prometheus_client',\n"
        "              'containerpilot_tpu'))\n"
        "print(json.dumps({'rc': rc, 'bad': bad,\n"
        "                  'cuda': torch.cuda.is_initialized()}))\n"
    )
    runs = [(args, subprocess.Popen(
        [sys.executable, "-c", probe, *args], cwd=REPO, env=_env(),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        for args in (["-version"], ["-config", str(config)])]
    for args, proc in runs:
        stdout, stderr = proc.communicate(timeout=120)
        result = json.loads(stdout.strip().splitlines()[-1])
        assert result == {"rc": 0, "bad": [], "cuda": False}, (
            args, stdout, stderr[-2000:])
