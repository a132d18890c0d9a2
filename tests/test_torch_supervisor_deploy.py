"""The port deployed without the JAX package: the capstone mirror at N=2
(``tests/test_torch_capstone.py``) and the supervised pod drill
(``tests/test_torch_serve_dist.py``'s ``_supervised_scenario``) run
under ``python -m containerpilot_tpu_torch`` and its ``-catalog-server``
instead of the reference's, with the same code and the same assertions
as their reference-supervisor cases: each module's ``subprocess`` is
swapped for one that starts the port's CLI wherever the reference's
``python -m containerpilot_tpu`` was started. Both drills spend most of
their time waiting (a crash and a wedge, restarts, rendezvous), so they
start together when the module starts; each test reads its own."""
import subprocess
import threading

import jax
import pytest

import test_torch_capstone as capstone
import test_torch_serve_dist as serve_dist


class _PortCLI:
    """``subprocess`` with ``Popen`` of ``[python, "-m",
    "containerpilot_tpu", ...]`` starting ``containerpilot_tpu_torch``;
    ``started`` records each such CLI's first flag."""

    def __init__(self):
        self.started = []

    def __getattr__(self, name):
        return getattr(subprocess, name)

    def Popen(self, argv, *args, **kwargs):  # noqa: N802 - subprocess API
        if list(argv[1:3]) == ["-m", "containerpilot_tpu"]:
            argv = [argv[0], "-m", "containerpilot_tpu_torch", *argv[3:]]
            self.started.append(argv[3])
        return subprocess.Popen(argv, *args, **kwargs)


def _capstone(tmp_path, out):
    try:
        capstone.test_supervised_torch_ranks_crash_and_resume(
            tmp_path, n_procs=2, tp=0, crash_idx=0)
    except BaseException as exc:  # noqa: BLE001 - reported by the test
        out["error"] = exc


@pytest.fixture(scope="module")
def drills(tmp_path_factory):
    """Both drills on threads, under the port's CLI: (thread, out, the
    CLI flags started) for each."""
    ck = tmp_path_factory.mktemp("pod_base") / "ck"
    jp = serve_dist.jtf.init_params(jax.random.PRNGKey(0),
                                    serve_dist.jax_cfg())
    serve_dist.write_checkpoint(ck, jp, 1)
    saved = {m: m.subprocess for m in (capstone, serve_dist)}
    runs = {}
    try:
        for name, module, target, args in (
            ("capstone", capstone, _capstone,
             (tmp_path_factory.mktemp("capstone"),)),
            ("pod", serve_dist, serve_dist._supervised_scenario,
             (tmp_path_factory.mktemp("pod"), str(ck))),
        ):
            cli = module.subprocess = _PortCLI()
            out: dict = {}
            thread = threading.Thread(target=target, args=(*args, out),
                                      daemon=True)
            thread.start()
            runs[name] = (thread, out, cli.started)
        runs["jax_params"] = jp
        yield runs
    finally:
        for name in ("capstone", "pod"):
            if name in runs:
                runs[name][0].join(timeout=600)
        for module, sub in saved.items():
            module.subprocess = sub


def test_capstone_under_the_ports_supervisor(drills):
    """test_torch_capstone's coordinator-crash case (N=2): every
    supervisor exits 0, the crash fired, both workers resumed with the
    same final loss, which equals a one-process run, and the catalog
    timeline shows the crashing worker passing, gone and back."""
    thread, out, started = drills["capstone"]
    thread.join(timeout=600)
    assert not thread.is_alive()
    if "error" in out:
        raise out["error"]
    assert started == ["-catalog-server", "-config", "-config"]


def test_supervised_pod_under_the_ports_supervisor(drills):
    """test_supervised_pod_recovers_from_wedged_follower's drill: a dp2
    x tp2 pod of four ranks under four of the port's supervisors on the
    port's live catalog server; a follower wedges, every rank exits 86,
    the supervisors restart them, the pod re-rendezvouses and answers as
    before; SIGTERM to every supervisor ends all of them with 0."""
    jp = drills["jax_params"]
    want_before = serve_dist._reference([1, 2, 3, 4], 6, params=jp)
    want_after = serve_dist._reference([5, 6, 7, 8], 5, params=jp)
    thread, out, started = drills["pod"]
    thread.join(timeout=600)
    assert not thread.is_alive()
    if "error" in out:
        raise out["error"]
    assert started == ["-catalog-server"] + ["-config"] * 4
    assert out["before"] == want_before
    assert out["after"] == want_after
    assert out["wedged"]
    assert out["rcs"] == [0, 0, 0, 0], out["logs"]
