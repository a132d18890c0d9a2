"""The port's tensor-parallel serving against the JAX package, on the
CPU: generate, MoE, the server, the slot engine and int8 weights with
the params cut into each rank's blocks, and the serve CLI's ``--tp``
with its spawned follower.

One gloo world of 4 ranks runs every in-library case, as ``python -m
torch_serve_jobs`` children (one thread each, ``file://`` rendezvous,
killed in ``finally``); the pytest process never makes a process group
and computes the JAX side while they run. The CLI tests start the serve
CLI as a subprocess (it spawns its own follower). Params come from
``jax.random.PRNGKey(0)`` (int8: the reference's ``quantize_model_params``
of them), carried into each rank's blocks by ``bridge.shard_from_jax``.

Mirrors ``tests/test_workload.py`` :3048 (generate parity on model 4,
greedy, and sampled against the one-rank port), :3088 (MoE, 4 experts on
model 4) and :3117 (the server reports its mesh), and
``tests/test_slots.py`` :742 (the slot engine under tp). Also: int8
weights under tp2 equal the one-rank port's int8 (greedy, the fused path:
every rank's projections through the plain version of K2), the CLI's
``--tp 2`` answering as ``--tp 1`` does, a killed follower making the
front exit non-zero within its lockstep deadline, and the compositions
refused over ranks. Tokens exactly; every rank's tokens equal rank 0's.
"""
import json
import os
import signal
import subprocess
import sys
import time
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from containerpilot_tpu.models import decode as jdecode
from containerpilot_tpu.models import quantized as jquant
from containerpilot_tpu.models import transformer as jtf
from containerpilot_tpu_torch import bridge
from containerpilot_tpu_torch.models import decode as tdecode
from containerpilot_tpu_torch.models import transformer as ttf
from containerpilot_tpu_torch.parallel.watchdog import EXIT_CODE
from containerpilot_tpu_torch.workload import serve_cli
from torch_serve_jobs import ROOT, finish_world, flat, results, start_world

WORLD = 4
TP = dict(vocab_size=64, d_model=64, n_heads=8, n_layers=2, d_ff=128,
          max_seq_len=32, dtype="float32")
MOE = dict(TP, n_heads=4, moe_experts=4)
SERVER = dict(TP, n_layers=1)
SLOTS = dict(vocab_size=64, d_model=64, n_heads=8, n_layers=1, d_ff=128,
             max_seq_len=64, dtype="float32")
# d 256, 4 heads of 64, d_ff 768: a tp2 rank's projections are 128-wide
# multiples, so decode takes the fused int8 path on each rank's blocks
INT8 = dict(vocab_size=256, d_model=256, n_heads=4, n_layers=2, d_ff=768,
            max_seq_len=64, dtype="float32")
SAMPLED = {"temperature": 0.8, "seed": 3, "top_k": 8}
SLOT_MAX_LEN = 48


def rows_of(shape, seed, vocab):
    return np.random.default_rng(seed).integers(0, vocab, size=shape)


def jax_cfg(cfg):
    return jtf.TransformerConfig(**{**cfg, "dtype": jnp.float32})


def port_params(tree):
    return bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, tree),
                                  "cpu")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(results dir, JAX params by config, the JAX side of each case)."""
    tmp = tmp_path_factory.mktemp("tp_serve")
    trees = {name: jtf.init_params(jax.random.PRNGKey(0), jax_cfg(cfg))
             for name, cfg in (("tp", TP), ("moe", MOE), ("server", SERVER),
                               ("slots", SLOTS), ("int8", INT8))}
    trees["int8"] = jquant.quantize_model_params(trees["int8"])
    for name, tree in trees.items():
        np.savez(tmp / f"{name}.npz",
                 **flat(jax.tree_util.tree_map(np.asarray, tree)))
    prompts = {"tp": rows_of((2, 6), 7, 64), "moe": rows_of((2, 5), 11, 64),
               "int8": rows_of((2, 9), 5, 256)}
    for name, prompt in prompts.items():
        np.savez(tmp / f"{name}_prompt.npz", prompt=prompt)

    def case(name, kind, cfg, plan, **kw):
        return {"name": name, "kind": kind, "config": cfg, "plan": plan,
                "params": str(tmp / f"{kw.pop('params', name)}.npz"), **kw}

    model4 = dict(data=1, model=4)
    cases = [
        case("tp", "generate", TP, model4,
             prompt=str(tmp / "tp_prompt.npz"), max_new=8, max_len=32,
             runs=[{}, SAMPLED]),
        case("moe", "generate", MOE, model4,
             prompt=str(tmp / "moe_prompt.npz"), max_new=6, max_len=32,
             runs=[{}]),
        case("int8", "generate", INT8, dict(data=2, model=2),
             prompt=str(tmp / "int8_prompt.npz"), max_new=8, max_len=64,
             runs=[{}]),
        case("server", "server", SERVER, model4, server={"max_len": 32},
             requests=[
                 {"tokens": [[1, 2, 3]], "max_new_tokens": 4},
                 {"tokens": [[1, 2, 3]], "max_new_tokens": 4,
                  "beam_width": 2},
                 {"method": "GET", "path": "/v1/weights"},
                 {"method": "POST", "path": "/v1/score",
                  "body": {"tokens": [[1, 2, 3, 4]]}},
             ]),
        case("slots", "slots", SLOTS, model4,
             engine={"max_len": SLOT_MAX_LEN, "slots": 2, "chunk": 3},
             requests=[[[1, 2, 3], {"max_new": 6, "temperature": 0.8,
                                    "seed": 4}],
                       [[5, 6], {"max_new": 4}]]),
    ]
    procs, out = start_world(tmp, cases, WORLD)
    try:
        refs = {}
        for name, cfg, new, max_len in (("tp", TP, 8, 32),
                                        ("moe", MOE, 6, 32),
                                        ("int8", INT8, 8, 64)):
            refs[name] = np.asarray(jdecode.generate(
                trees[name], jnp.asarray(prompts[name], jnp.int32),
                jax_cfg(cfg), new, max_len)).tolist()
        refs["server"] = np.asarray(jdecode.generate(
            trees["server"], jnp.asarray([[1, 2, 3]], jnp.int32),
            jax_cfg(SERVER), 4, 32)).tolist()
        refs["slots_greedy"] = np.asarray(jdecode.generate(
            trees["slots"], jnp.asarray([[5, 6]], jnp.int32),
            jax_cfg(SLOTS), 4, SLOT_MAX_LEN)).tolist()
    finally:
        finish_world(procs)
    return out, trees, prompts, refs


def all_ranks(out, name):
    ranks = results(out, name, WORLD)
    for r in ranks[1:]:
        assert r["outs"] == ranks[0]["outs"]
    return ranks[0]["outs"]


def test_tensor_parallel_generate_parity(world):
    """:3048 on model 4: greedy tokens equal JAX generate's on the whole
    params; seeded sampling (temperature, top_k) equals the one-rank
    port's; every rank emits the same tokens."""
    out, trees, prompts, refs = world
    got = all_ranks(out, "tp")
    assert got[0] == refs["tp"]
    cfg = ttf.TransformerConfig(**bridge.config_kwargs(TP))
    one = tdecode.generate(port_params(trees["tp"]),
                           torch.from_numpy(prompts["tp"]), cfg, 8, 32,
                           temperature=0.8, rng=3, top_k=8)
    assert got[1] == one.tolist()


def test_tensor_parallel_moe_generate_parity(world):
    """:3088: the experts shard over model 4 with the rest of the tp
    rules, and decode equals JAX's on the whole params."""
    out, _trees, _prompts, refs = world
    assert all_ranks(out, "moe")[0] == refs["moe"]


def test_int8_under_tp2_equals_one_rank_int8(world):
    """int8 weights quantized whole, then cut (column-parallel scales
    per rank, row-parallel scales whole): tp2's greedy tokens equal the
    one-rank port's int8 and JAX's int8 generate."""
    out, trees, prompts, refs = world
    got = all_ranks(out, "int8")[0]
    cfg = ttf.TransformerConfig(**bridge.config_kwargs(INT8))
    one = tdecode.generate(port_params(trees["int8"]),
                           torch.from_numpy(prompts["int8"]), cfg, 8, 64)
    assert got == one.tolist() == refs["int8"]


def test_inference_server_reports_mesh(world):
    """:3117 on model 4: /v1/model reports the mesh the params are
    sharded over, as the reference does, and the server answers from
    the sharded params (JAX's tokens); beams and the weight verb are
    refused over ranks; /v1/score runs as a lockstep op; the ranks
    agree."""
    out, _trees, _prompts, refs = world
    front = results(out, "server", WORLD)[0]
    gen, beam, weights, score = front["answers"]
    assert gen == [200, {"tokens": refs["server"]}]
    assert beam[0] == 422 and "not ported yet under --tp/--cp" in beam[1]
    assert weights[0] == 501
    assert score[0] == 200 and len(score[1]["logprobs"][0]) == 3
    info = front["info"]
    assert info["mesh"] == {"data": 1, "model": 4}
    assert info["cp"] is None
    lockstep = info["lockstep"]
    assert lockstep["agree"] and len(lockstep["ranks"]) == WORLD
    assert lockstep["backend"] == "gloo" and not lockstep["staging"]


def test_slot_engine_composes_with_tensor_parallel(world):
    """test_slots.py :742 on model 4: the slot pool rides the sharded
    params (head-sharded pool, the front's verbs replayed on every rank)
    and each output equals the one-rank solo run (the greedy one also
    JAX's)."""
    out, trees, _prompts, refs = world
    ranks = results(out, "slots", WORLD)
    a, b = ranks[0]["outs"]
    assert ranks[0]["step_program"] == "eager"
    cfg = ttf.TransformerConfig(**bridge.config_kwargs(SLOTS))
    params = port_params(trees["slots"])
    solo_a = tdecode.generate(params, torch.tensor([[1, 2, 3]]), cfg, 6,
                              SLOT_MAX_LEN, temperature=0.8, rng=4)
    assert a == solo_a[0].tolist()
    assert b == refs["slots_greedy"][0]


# -- the serve CLI ------------------------------------------------------

CLI_MODEL = ["--device", "cpu", "--d-model", "64", "--n-layers", "2",
             "--n-heads", "4", "--vocab", "128", "--max-len", "64"]


def _free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _start_cli(args, port):
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": ROOT}
    return subprocess.Popen(
        [sys.executable, "-m", "containerpilot_tpu_torch.workload.serve",
         *CLI_MODEL, "--host", "127.0.0.1", "--port", str(port), *args],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)


def _wait_healthy(proc, port, timeout=90):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if proc.poll() is not None:
            raise AssertionError(proc.communicate()[0][-3000:])
        try:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/health", timeout=2) as r:
                if r.status == 200:
                    return
        except OSError:
            pass
        time.sleep(0.2)
    raise AssertionError("serve CLI never became healthy")


def child_pids(pid):
    out = []
    for entry in os.listdir("/proc"):
        try:
            with open(f"/proc/{entry}/stat") as fh:
                stat = fh.read()
        except OSError:
            continue
        if int(stat.rsplit(")", 1)[1].split()[1]) == pid:
            out.append(int(entry))
    return out


def _post(port, path, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return json.loads(resp.read().decode())


def _stop(proc):
    if proc.poll() is None:
        proc.send_signal(signal.SIGTERM)
    try:
        log = proc.communicate(timeout=60)[0]
    except subprocess.TimeoutExpired:
        proc.kill()
        log = proc.communicate()[0]
    return proc.returncode, log


BODIES = [
    {"tokens": [[1, 2, 3, 4, 5]], "max_new_tokens": 8},
    {"tokens": [[1, 2, 3, 4, 5], [6, 7, 8, 9, 10]], "max_new_tokens": 8,
     "temperature": 0.8, "seed": 3},
]


def test_cli_tp2_answers_as_tp1():
    """``serve --tp 2 --device cpu`` spawns its follower and answers
    /v1/generate (greedy and seeded sampling) as ``--tp 1`` does; every
    rank prints its collectives line; SIGTERM shuts the follower down
    and both exit 0."""
    answers = {}
    for label, extra in (("tp1", []), ("tp2", ["--tp", "2"])):
        port = _free_port()
        proc = _start_cli(extra, port)
        try:
            _wait_healthy(proc, port)
            answers[label] = [_post(port, "/v1/generate", b) for b in BODIES]
            info = json.loads(urllib.request.urlopen(
                f"http://127.0.0.1:{port}/v1/model", timeout=60).read())
        finally:
            rc, log = _stop(proc)
        assert rc == 0, log[-3000:]
        if label == "tp2":
            assert info["mesh"] == {"data": 1, "model": 2}
            assert info["lockstep"]["agree"]
            assert "mesh: {'data': 1, 'model': 2} on cpu" in log
            assert "rank 1 of 2: collectives over gloo" in log
    assert answers["tp2"] == answers["tp1"]


def test_cli_killed_follower_ends_the_front():
    """A follower that dies makes the front exit non-zero (the lockstep
    watchdog's code) within its deadline; it never serves on fewer
    ranks."""
    port = _free_port()
    deadline = 8.0
    proc = _start_cli(["--tp", "2", "--lockstep-deadline", str(deadline)],
                      port)
    try:
        _wait_healthy(proc, port)
        followers = child_pids(proc.pid)
        assert len(followers) == 1
        os.kill(followers[0], signal.SIGKILL)
        t0 = time.monotonic()
        proc.wait(timeout=deadline + 30)
        took = time.monotonic() - t0
    finally:
        rc, log = _stop(proc)
    assert rc == EXIT_CODE, log[-3000:]
    assert took < deadline, took


@pytest.mark.parametrize("argv,message", [
    (["--tp", "2", "--prefix-cache", "2"],
     "--prefix-cache is not ported yet under --tp/--cp"),
    (["--tp", "2", "--draft-layers", "1"],
     "--draft-layers is not ported yet under --tp/--cp"),
    (["--cp", "2", "--standby"], "--standby is not ported yet under"),
    (["--tp", "2", "--weights-from", "127.0.0.1:1"],
     "--weights-from is not ported yet under"),
    (["--tp", "3"], r"--tp 3 must divide n_heads \(4\)"),
    (["--tp", "2", "--moe-experts", "3"],
     r"--tp 2 must divide moe_experts \(3\)"),
])
def test_cli_refuses_at_startup(argv, message):
    """Compositions this port does not serve over ranks exit before any
    rank starts, naming the pair; --tp that does not divide the model
    exits with the reference's message."""
    args = serve_cli.build_arg_parser().parse_args(argv)
    with pytest.raises(SystemExit, match=message):
        serve_cli.check_ported(args)
