"""The port's rendezvous and step watchdog.

- ``test_distributed_initialize_from_catalog_single_process``
  (``tests/test_workload.py:1600``) on the port's ``FileCatalogBackend``:
  the coordinator is discovered under the port's own service name, and a
  JAX coordinator in the same catalog is never taken for it;
- ``test_distributed_two_process_catalog_rendezvous`` (``:1655``): two
  child ranks meet through a file catalog with
  ``initialize_from_catalog`` (TCP rendezvous, gloo) and all-reduce to
  2.0;
- the seven tests of ``tests/test_watchdog.py`` on the port's
  ``StepWatchdog``, each in a child process (the firing path is
  ``os._exit``, which must never reach a pytest worker).

No process group is ever made in the pytest process.
"""
import os
import socket
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WATCHDOG_PY = os.path.join(ROOT, "containerpilot_tpu_torch", "parallel",
                           "watchdog.py")
CHILD_ENV = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": ROOT}
EXIT_CODE = 86  # the reference's watchdog exit code


def test_distributed_initialize_from_catalog_single_process(tmp_path):
    from containerpilot_tpu_torch.discovery import (
        FileCatalogBackend,
        ServiceRegistration,
    )
    from containerpilot_tpu_torch.parallel.distributed import (
        COORDINATOR_SERVICE,
        _discover_coordinator,
    )

    assert COORDINATOR_SERVICE == "torch-coordinator"
    backend = FileCatalogBackend(str(tmp_path))
    # a JAX coordinator in the same catalog is not a torch rendezvous
    backend.service_register(
        ServiceRegistration(id="jax-coordinator-host0",
                            name="jax-coordinator", port=8476,
                            address="10.0.0.2", ttl=600),
        status="passing",
    )
    with pytest.raises(TimeoutError):
        _discover_coordinator(backend, 29500, timeout=0.3,
                              poll_interval=0.1)
    backend.service_register(
        ServiceRegistration(id="torch-coordinator-host0",
                            name=COORDINATOR_SERVICE, port=8476,
                            address="10.0.0.1", ttl=600),
        status="passing",
    )
    addr = _discover_coordinator(backend, 8476, timeout=5, poll_interval=0.1)
    assert addr == "10.0.0.1:8476"
    with pytest.raises(TimeoutError):
        _discover_coordinator(
            FileCatalogBackend(str(tmp_path / "empty")), 8476,
            timeout=0.3, poll_interval=0.1,
        )


def test_initialize_from_env_without_a_coordinator_is_a_world_of_one(
        monkeypatch):
    import torch.distributed as dist

    from containerpilot_tpu_torch.parallel import distributed, make_mesh

    monkeypatch.delenv("COORDINATOR_ADDRESS", raising=False)
    distributed.initialize_from_env(device="cpu")
    assert not dist.is_initialized()
    assert make_mesh().shape == {"data": 1, "model": 1}


_RENDEZVOUS_RANK = r"""
import sys
import torch
torch.set_num_threads(1)
import torch.distributed as dist
from containerpilot_tpu_torch.discovery import FileCatalogBackend
from containerpilot_tpu_torch.parallel import make_mesh
from containerpilot_tpu_torch.parallel.distributed import (
    initialize_from_catalog,
)

pid, n, catalog, port = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                         int(sys.argv[4]))
initialize_from_catalog(
    FileCatalogBackend(catalog), pid, n, coordinator_port=port,
    advertise_address="127.0.0.1", timeout=60, poll_interval=0.1,
    device="cpu",
)
assert dist.get_world_size() == n and dist.get_backend() == "gloo"
mesh = make_mesh(device="cpu")
total = mesh.all_reduce(torch.ones(1), "model")
print("ALLREDUCE", float(total[0]), mesh.shape, flush=True)
dist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_distributed_two_process_catalog_rendezvous(tmp_path):
    """Two real processes rendezvous through a file catalog (rank 0
    registers torch-coordinator and hosts the TCP store) and complete
    an all-reduce over the mesh's model axis."""
    catalog = str(tmp_path / "catalog")
    port = _free_port()
    procs = []
    try:
        for pid in (0, 1):
            procs.append(subprocess.Popen(
                [sys.executable, "-c", _RENDEZVOUS_RANK, str(pid), "2",
                 catalog, str(port)],
                cwd=ROOT, env=CHILD_ENV, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True))
        outs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, f"rank failed:\n{err[-2000:]}"
        assert "ALLREDUCE 2.0 {'data': 1, 'model': 2}" in out, (out, err)


def _run_dog(body: str, timeout: float = 30) -> subprocess.CompletedProcess:
    """Run ``body`` in a child with the port's StepWatchdog loaded by
    file path (stdlib only: no torch import)."""
    prog = (
        "import importlib.util\n"
        f"spec = importlib.util.spec_from_file_location("
        f"'_watchdog', {WATCHDOG_PY!r})\n"
        "m = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(m)\n"
        "StepWatchdog = m.StepWatchdog\n"
        f"assert m.EXIT_CODE == {EXIT_CODE}\n"
        "import time\n" + body
    )
    return subprocess.run(
        [sys.executable, "-c", prog], capture_output=True, text=True,
        timeout=timeout,
    )


def test_beats_keep_it_alive():
    res = _run_dog(
        "dog = StepWatchdog(5.0).start()\n"
        "for _ in range(3):\n"
        "    time.sleep(0.2)\n"
        "    dog.beat()\n"
        "dog.stop()\n"
        "print('alive')\n"
    )
    assert res.returncode == 0 and "alive" in res.stdout, res.stderr


def test_fires_without_beats():
    res = _run_dog("StepWatchdog(0.3).start()\ntime.sleep(30)\n")
    assert res.returncode == EXIT_CODE, res.stderr


def test_stop_disarms():
    res = _run_dog(
        "dog = StepWatchdog(0.3).start()\n"
        "dog.stop()\n"
        "time.sleep(0.6)\n"
        "print('alive')\n"
    )
    assert res.returncode == 0 and "alive" in res.stdout, res.stderr


def test_startup_grace_covers_first_beat_only():
    res = _run_dog(
        "dog = StepWatchdog(0.3).start(grace_s=2.0)\n"
        "time.sleep(0.6)\n"      # inside grace: survives
        "print('survived grace', flush=True)\n"
        "dog.beat()\n"           # grace over; deadline now 0.3
        "time.sleep(30)\n"
    )
    assert res.returncode == EXIT_CODE, res.stderr
    assert "survived grace" in res.stdout


def test_grace_eventually_fires():
    res = _run_dog("StepWatchdog(0.2).start(grace_s=0.5)\ntime.sleep(30)\n")
    assert res.returncode == EXIT_CODE, res.stderr


def test_grace_below_timeout_rejected():
    res = _run_dog(
        "try:\n"
        "    StepWatchdog(5.0).start(grace_s=1.0)\n"
        "except ValueError:\n"
        "    print('rejected')\n"
    )
    assert res.returncode == 0 and "rejected" in res.stdout, res.stderr


def test_nonpositive_timeout_rejected():
    res = _run_dog(
        "try:\n"
        "    StepWatchdog(0.0)\n"
        "except ValueError:\n"
        "    print('rejected')\n"
    )
    assert res.returncode == 0 and "rejected" in res.stdout, res.stderr
