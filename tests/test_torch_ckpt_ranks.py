"""Checkpoints across ranks, on the CPU: lockstep saves and restores on
one shared directory, every layout's state gathered and cut, a
checkpoint of one layout restored into another and into one process,
and the train CLI over 4 ranks killed, relaunched, fine-tuned with
LoRA, evaluated and preempted.

Every world is made of children of the test (``tests/torch_ckpt_jobs``:
one thread each, at most 4 alive, killed in ``finally``); the pytest
process never makes a process group. The library cases mirror
``tests/test_workload.py`` :787 (roundtrip), :1449 (LoRA), :2353 (EMA)
and :2784 (async) on a dp2 x tp2 world; the LoRA case starts from the
JAX package's base and adapter (carried by ``bridge``) and is held to
the reference's ``make_lora_train_step`` on the same (data 2, model 2)
mesh over ``jax.devices()[:4]``. The CLI runs on the mesh the reference
factors 4 ranks into (data 1 x model 4), and its in-loop eval is held
to the reference's ``average_eval_loss`` of the same checkpoint. On the
CPU every rank's float32 state restores bit for bit and a resumed run
repeats the uninterrupted one bit for bit (gloo reduces in a fixed
order); the one-rank and reference comparisons take ``ONE_RANK_TOL``
in float32 (the library cases) and ``BF16_TOL`` through the CLI, whose
model computes in bf16: tensor parallelism sums bf16 partial products
in another order than one rank (``tests/test_torch_train_cli.py`` holds
its two ranks to the same).
"""
import json
import os
import re
import signal
import socket
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from containerpilot_tpu.models import transformer as jtf
from containerpilot_tpu.parallel import MeshPlan as JPlan
from containerpilot_tpu.parallel import make_mesh as jmake_mesh
from containerpilot_tpu.parallel import train as jtrain
from containerpilot_tpu.workload import data as jdata
from containerpilot_tpu.workload import modelcfg as jmodelcfg
from containerpilot_tpu_torch.parallel import (
    abstract_train_state,
    make_lora_train_step,
    restore_checkpoint,
)
from containerpilot_tpu_torch.parallel.train import tree_leaves
from containerpilot_tpu_torch.workload import evaluate as teval
from containerpilot_tpu_torch.workload.data import write_token_shards

import torch_ckpt_jobs as jobs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ONE_RANK_TOL = 1e-5
BF16_TOL = 1e-3
ENV = {**os.environ, "OMP_NUM_THREADS": "1",
       "PYTHONPATH": os.pathsep.join([ROOT, os.path.join(ROOT, "tests")])}
MODEL = ["--device", "cpu", "--batch", "4", "--seq-len", "32", "--d-model",
         "64", "--n-layers", "2", "--n-heads", "4", "--vocab", "128",
         "--learning-rate", "1e-2"]


def _wait(procs, timeout=240):
    """Every child's (returncode, output); any still alive at the end is
    killed."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [p.returncode for p in procs], outs


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def library(tmp_path_factory):
    """The library cases on one world of 4 ranks: ({case: rank 0's
    facts}, tmp). The LoRA case's base and adapter are the JAX
    package's, written for the children as numpy trees; while they run,
    the reference's LoRA step trains the same adapter on the same batch
    on a (data 2, model 2) mesh, and its losses and adapter join the
    facts as ``facts["lora"]["reference"]``."""
    tmp = tmp_path_factory.mktemp("ckpt_world")
    jcfg = jtf.TransformerConfig(**{**jobs.BASE, "dtype": jnp.float32})
    jbase = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    mesh = jmake_mesh(jax.devices()[:4], plan=JPlan(data=2, model=2))
    jinit, jstep, _abstract = jtrain.make_lora_train_step(
        jcfg, mesh, jobs.LORA_RANK, learning_rate=jobs.LR)
    jstate = jinit(jax.random.PRNGKey(3))
    torch.save({"base": _np(jbase), "adapter": _np(jstate.params)},
               tmp / "lora_inputs.pt")
    spec = {"world": 4, "init_file": str(tmp / "rendezvous"),
            "out": str(tmp), "timeout": 120,
            "lora_inputs": str(tmp / "lora_inputs.pt")}
    (tmp / "spec.json").write_text(json.dumps(spec))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "torch_ckpt_jobs", str(tmp / "spec.json"),
         str(r)], cwd=ROOT, env=ENV, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(4)]
    try:
        batch = jnp.asarray(jobs.tokens(1, (8, 33)).numpy().astype(np.int32))
        losses = []
        with jax.default_matmul_precision("float32"):
            for _ in range(15):
                jstate, loss = jstep(jstate, jbase, batch)
                losses.append(float(loss))
        reference = {"losses": losses, "adapter": _np(jstate.params)}
    finally:
        rcs, outs = _wait(procs)
    for rc, out in zip(rcs, outs):
        assert rc == 0, out[-4000:]
    facts = {name: torch.load(tmp / f"{name}.pt", weights_only=False)
             for name, _fn in jobs.CASES}
    facts["lora"]["reference"] = reference
    return facts, tmp


def _port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start_cli(tmp, tag, args, ranks=4, kill=None):
    """The train CLI as ``ranks`` children joined by the reference's
    environment variables (``COORDINATOR_ADDRESS``, ``NUM_PROCESSES``,
    ``PROCESS_ID``; the catalog rendezvous is the capstone mirror's),
    each logging its per-step losses to <tmp>/<tag>.rank<r>."""
    world = {**ENV, "COORDINATOR_ADDRESS": f"127.0.0.1:{_port()}",
             "NUM_PROCESSES": str(ranks)}
    procs = []
    for r in range(ranks):
        extra = (["--kill-after", str(kill[1])]
                 if kill is not None and kill[0] == r else [])
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "torch_ckpt_jobs", "--train-rank",
             str(tmp / f"{tag}.rank{r}"), *extra, "--", *MODEL, *args],
            cwd=ROOT, env={**world, "PROCESS_ID": str(r)},
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return procs


def _losses(path):
    """The per-step {step, loss} a rank logged."""
    with open(path) as fh:
        return [{"step": r["step"], "loss": r["loss"]}
                for r in map(json.loads, fh) if "step" in r]


def _state(ck, step):
    return torch.load(os.path.join(ck, f"step_{step}", "state.pt"),
                      weights_only=True)


@pytest.fixture(scope="module")
def cli(tmp_path_factory):
    """The train CLI over 4 ranks (the reference's factorization, data 1
    x model 4): an uninterrupted 6-step
    run with checkpoints every 2 steps and eval every 3; the same run
    with rank 1 SIGKILLed after step 5, then relaunched; and LoRA on
    the uninterrupted run's checkpoint, SIGTERMed once 3 steps are
    logged."""
    tmp = tmp_path_factory.mktemp("ckpt_cli")
    write_token_shards(np.random.default_rng(0).integers(0, 128, 20_000),
                       str(tmp / "data"))
    run = ["--steps", "6", "--checkpoint-every", "2", "--data-dir",
           str(tmp / "data"), "--eval-holdout", "8", "--eval-every", "3"]
    res = {}
    res["full"] = _wait(_start_cli(
        tmp, "full", run + ["--checkpoint-dir", str(tmp / "ck_full")]))
    resumed = run + ["--checkpoint-dir", str(tmp / "ck_killed")]
    res["killed"] = _wait(_start_cli(tmp, "killed", resumed, kill=(1, 5)))
    res["relaunched"] = _wait(_start_cli(tmp, "relaunched", resumed))
    lora = ["--steps", "100000", "--lora-rank", "4",
            "--base-checkpoint-dir", str(tmp / "ck_full")]
    procs = _start_cli(tmp, "lora", lora)
    try:
        deadline = time.monotonic() + 240
        while time.monotonic() < deadline and all(
                p.poll() is None for p in procs):
            try:
                if all(len(_losses(tmp / f"lora.rank{r}")) >= 3
                       for r in range(4)):
                    break
            except OSError:
                pass
            time.sleep(0.05)
        for p in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
    finally:
        res["lora"] = _wait(procs)
    return res, tmp


def test_layouts_restore_every_rank_bit_for_bit(library):
    """dp2 x tp2, ZeRO-1, FSDP and pp2 x tp2: after a lockstep save and
    restore every rank's params, moments and count equal the live
    state's, the next step's loss is the live state's to the bit, and
    the file holds the gathered state (mirror of :787); the dp2 x tp2
    case also finds no checkpoint in a missing directory and prunes to
    the newest with keep=1."""
    facts, tmp = library
    for name in ("dp2_tp2", "zero1", "fsdp", "pp2_tp2"):
        got = facts[name]
        assert got["latest"] == 2, name
        assert got["blocks_equal_on_every_rank"], name
        assert got["live_loss"] == got["restored_loss"], name
        on_disk = _state(tmp / f"ck_{name}", 2)
        for part in ("params", "opt_state"):
            for a, b in zip(tree_leaves(on_disk[part]),
                            tree_leaves(got[f"gathered_{part}"])):
                assert torch.equal(torch.as_tensor(a), torch.as_tensor(b)), (
                    name, part)
        assert got["figures"]["host_bytes"] > 0
    assert facts["dp2_tp2"]["missing_dir"]
    assert facts["dp2_tp2"]["after_prune"] == ["step_3"]


def test_sharded_layouts_checkpoint_the_whole_state(library):
    """A ZeRO-1, FSDP or pipeline checkpoint holds whole moments and
    params, the same shapes as a one-process run's."""
    _facts, tmp = library
    whole = abstract_train_state(jobs.cfg())
    for name in ("zero1", "fsdp", "pp2_tp2"):
        raw = _state(tmp / f"ck_{name}", 2)
        for a, b in zip(tree_leaves(raw["opt_state"]["mu"]),
                        tree_leaves(whole.opt_state["mu"])):
            assert a.shape == b.shape, name
        for a, b in zip(tree_leaves(raw["params"]),
                        tree_leaves(whole.params)):
            assert a.shape == b.shape, name


@pytest.mark.parametrize("name", ["dp2_tp2_into_pp2_tp2",
                                  "zero1_into_dp2_tp2"])
def test_checkpoint_restores_into_another_layout(library, name):
    """A dp2 x tp2 checkpoint restored into pp2 x tp2 and a ZeRO-1 one
    into plain dp2 x tp2: the restored blocks gathered equal the file,
    and the restored state trains."""
    facts, tmp = library
    got = facts[name]
    raw = _state(tmp / f"ck_{name.split('_into_')[0]}", 2)
    assert got["step"] == 2
    for part in ("params", "opt_state"):
        for a, b in zip(tree_leaves(raw[part]), tree_leaves(got[part])):
            assert torch.equal(torch.as_tensor(a), torch.as_tensor(b)), part
    assert np.isfinite(got["next_loss"])


@pytest.mark.parametrize("name", ["dp2_tp2", "zero1", "fsdp", "pp2_tp2"])
def test_checkpoint_of_four_ranks_restores_into_one_process(library, name):
    """A 4-rank checkpoint restored by one process (no mesh) equals the
    4-rank state gathered, and the one-rank step from it computes the
    4-rank restored step's loss."""
    from containerpilot_tpu_torch.parallel import make_train_step

    got = library[0][name]
    state = restore_checkpoint(str(library[1] / f"ck_{name}"),
                               abstract_train_state(jobs.cfg()),
                               device="cpu")
    assert state.step == 2
    for part, tree in (("params", state.params),
                       ("opt_state", state.opt_state)):
        for a, b in zip(tree_leaves(tree), tree_leaves(got[f"gathered_{part}"])):
            assert torch.equal(torch.as_tensor(a).detach(),
                               torch.as_tensor(b)), part
    step = make_train_step(jobs.cfg(), learning_rate=jobs.LR)
    _state, loss = step(state, jobs.tokens(1, (4, 33)))
    assert float(loss) == pytest.approx(got["restored_loss"],
                                        rel=ONE_RANK_TOL)


def test_ema_shadow_checkpoints_across_ranks(library):
    """Mirror of :2353 on dp2 x tp2: the shadow starts as the params,
    follows the recurrence, and round-trips bit for bit; the serving
    restore with prefer_ema returns the gathered shadow."""
    from containerpilot_tpu_torch.parallel import (
        make_optimizer,
        restore_params,
        with_ema,
    )

    facts, tmp = library
    got = facts["ema"]
    assert got["starts_equal"]
    assert got["recurrence_err"] <= 1e-6
    assert got["ema_equal_on_every_rank"]
    abstract = abstract_train_state(jobs.cfg(),
                                    with_ema(make_optimizer(1e-2), 0.9))
    restored = restore_params(str(tmp / "ck_ema"), abstract,
                              prefer_ema=True, device="cpu")
    assert restored.ema and restored[1] == 2
    for a, b in zip(tree_leaves(restored[0]),
                    tree_leaves(got["gathered_ema"])):
        assert torch.equal(a, b)


def test_async_save_takes_the_state_at_the_call(library):
    """Mirror of :2784 on dp2 x tp2."""
    got = library[0]["async"]
    assert got["moved"] and got["step"] == 1
    assert got["restored_equal_on_every_rank"]


def test_rank0_write_failure_fails_every_rank(library):
    """No rank passes a failed save in silence: a synchronous save into
    a directory rank 0 cannot make raises on every rank, and an
    asynchronous one at the next wait_for_checkpoints."""
    got = library[0]["write_fails"]
    assert got["raised_on_every_rank"], got["messages"]


def test_lora_on_four_ranks_checkpoints_and_equals_one_rank(library):
    """Mirror of :1449 on dp2 x tp2: the fresh adapter reproduces the
    base, 15 steps lower the loss with the base's blocks untouched, the
    adapter checkpoint round-trips (params-only too); the losses and the
    trained adapter equal the reference's LoRA step on the same (data 2,
    model 2) mesh, and one rank's on the whole base."""
    from containerpilot_tpu_torch import bridge
    from containerpilot_tpu_torch.parallel import train as ptrain

    got = library[0]["lora"]
    assert got["zero_delta"]
    assert got["losses"][-1] < got["losses"][0] - 0.1, got["losses"]
    assert got["base_kept_on_every_rank"]
    assert got["resumed_step"] == 15 and got["resumed_equal_on_every_rank"]
    assert got["params_only_step"] == 15 and got["params_only_equal"]
    inputs = torch.load(library[1] / "lora_inputs.pt", weights_only=False)
    init_fn, step_fn, _abstract = make_lora_train_step(
        jobs.cfg(), jobs.LORA_RANK, jobs.LR)
    state = ptrain.TrainState(
        ptrain._master(bridge.lora_from_jax(inputs["adapter"], "cpu")),
        init_fn(3, "cpu").opt_state, 0)
    base = bridge.params_from_jax(inputs["base"], "cpu")
    batch = jobs.tokens(1, (8, 33))
    losses = []
    for _ in range(15):
        state, loss = step_fn(state, base, batch)
        losses.append(float(loss))
    reference = got["reference"]
    for want, adapter in ((reference["losses"], reference["adapter"]),
                          (losses, state.params)):
        np.testing.assert_allclose(got["losses"], want, rtol=ONE_RANK_TOL)
        for k, v in adapter.items():
            v = torch.tensor(np.asarray(v.detach() if isinstance(
                v, torch.Tensor) else v))
            scale = float(v.abs().max())
            assert float((got["adapter"][k] - v).abs().max()) <= (
                ONE_RANK_TOL * scale), k


def test_cli_killed_rank_ends_its_peers_and_the_relaunch_resumes_exactly(
        cli):
    """4 ranks of the train CLI: rank 1 SIGKILLed after step 5 leaves
    its peers to exit non-zero (none trains on a smaller world); the
    relaunch resumes at step 4 (the last periodic checkpoint) and its
    losses and final params equal the uninterrupted run's bit for bit."""
    res, tmp = cli
    rcs, outs = res["full"]
    assert rcs == [0] * 4, outs[0][-3000:]
    rcs, outs = res["killed"]
    assert rcs[1] == -signal.SIGKILL, rcs
    assert all(rc not in (0, None) for rc in rcs), (rcs, outs[0][-2000:])
    rcs, outs = res["relaunched"]
    assert rcs == [0] * 4, outs[0][-3000:]
    for out in outs:
        assert "resumed from checkpoint at step 4" in out, out[-2000:]
    full = [_losses(tmp / f"full.rank{r}") for r in range(4)]
    again = [_losses(tmp / f"relaunched.rank{r}") for r in range(4)]
    for r in range(4):
        assert full[r] == full[0]
        assert again[r] == [x for x in full[0] if x["step"] > 4]
    a, b = _state(tmp / "ck_full", 6), _state(tmp / "ck_killed", 6)
    for part in ("params", "opt_state"):
        for x, y in zip(tree_leaves(a[part]), tree_leaves(b[part])):
            assert torch.equal(torch.as_tensor(x), torch.as_tensor(y)), part


def test_cli_eval_every_agrees_on_every_rank_and_with_evaluate(cli,
                                                               capsys):
    """--eval-every 3: every rank prints the same eval_loss, and the
    last one equals the reference's average_eval_loss of the step-6
    checkpoint's params (the reference evaluate CLI's computation, in
    bf16 as the CLI's) on the same shards, and the port's one-rank
    evaluate CLI on that checkpoint, within BF16_TOL (model 4 sums bf16
    partial products in another order: the three read within 3.3e-4 of
    each other, the printed value having 4 decimals)."""
    res, tmp = cli
    _rcs, outs = res["full"]
    evals = [re.findall(r"step (\d+): eval_loss=([\d.]+)", out)
             for out in outs]
    assert evals[0] and [s for s, _ in evals[0]] == ["3", "6"], outs[0]
    assert all(e == evals[0] for e in evals)
    assert teval.main(["--device", "cpu", "--checkpoint-dir",
                       str(tmp / "ck_full"), "--data-dir",
                       str(tmp / "data"), "--eval-holdout", "8",
                       "--batch", "4", "--seq-len", "32", "--d-model", "64",
                       "--n-layers", "2", "--n-heads", "4", "--vocab",
                       "128"]) == 0
    scored = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert scored["checkpoint_step"] == 6
    params = jax.tree_util.tree_map(
        lambda t: jnp.asarray(t.float().numpy()),
        _state(tmp / "ck_full", 6)["params"])
    jcfg = jtf.TransformerConfig(
        vocab_size=128, d_model=64, n_heads=4, n_layers=2,
        d_ff=jmodelcfg.derive_d_ff(64), max_seq_len=32)
    shards = jdata.TokenShardDataset(str(tmp / "data"), 32, 4,
                                     vocab_size=128, holdout_windows=8)
    reference = jmodelcfg.average_eval_loss(
        params, jcfg, shards.n_eval_batches, shards.eval_batch)
    for want in (reference, scored["eval_loss"]):
        assert float(evals[0][1][1]) == pytest.approx(want, rel=BF16_TOL)


def test_cli_lora_and_sigterm_across_ranks(cli, capsys):
    """--lora-rank 4 at dp2 x tp2 over the uninterrupted run's
    checkpoint (a params-only restore into blocks) logs the losses of
    one rank's LoRA CLI on the same flags (within BF16_TOL: the CLI
    computes in bf16); SIGTERM makes every rank
    print the reference's multi-process message and exit 0."""
    res, tmp = cli
    rcs, outs = res["lora"]
    assert rcs == [0] * 4, outs[0][-3000:]
    for out in outs:
        assert "lora: frozen base from checkpoint step 6" in out
        assert ("preempted: exiting (resume from last periodic "
                "checkpoint)") in out, out[-2000:]
    logged = [_losses(tmp / f"lora.rank{r}") for r in range(4)]
    assert all(x == logged[0] for x in logged)
    n = len(logged[0])
    assert n >= 3
    one = tmp / "lora_one_rank"
    argv = ["--train-rank", str(one), "--", *MODEL, "--steps", str(n),
            "--lora-rank", "4", "--base-checkpoint-dir",
            str(tmp / "ck_full")]
    assert jobs.train_cli(argv) == 0
    capsys.readouterr()
    single = _losses(one)
    np.testing.assert_allclose([x["loss"] for x in logged[0]],
                               [x["loss"] for x in single],
                               rtol=BF16_TOL)
