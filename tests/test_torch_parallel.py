"""The port's training across ranks against the JAX package, on the CPU.

Two gloo worlds of 4 ranks each run once per module, as ``python -m
torch_rank_jobs`` children (one thread each, ``file://`` rendezvous
under the test's tmp dir, at most 4 children alive, killed in
``finally``); the pytest process never makes a process group. Every
case starts from the same seeded JAX params, cut into each rank's
blocks by ``bridge.shard_from_jax``, and rank 0 writes the global loss,
the gathered gradients and the gathered params after one step. The
tests then hold each case to the JAX side computed here: the mirrored
reference test's sharded step (``tests/test_workload.py`` :228, :201,
:276, :308, :2293, :1534) or the pipeline's forward and step (:1719,
:1787, :1830, :1878).

Tolerances (``tests/test_torch_train.py``): loss and gradients
``GRAD_TOL`` 1e-4 relative to each leaf's largest entry, params after a
step ``STEP_TOL`` 2e-4, the pipeline's forward logits the reference's
2e-4.
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from containerpilot_tpu.models import transformer as jtf
from containerpilot_tpu.parallel import MeshPlan, make_mesh
from containerpilot_tpu.parallel import pipeline as jpipe
from containerpilot_tpu.parallel import train as jtrain

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRAD_TOL = 1e-4
STEP_TOL = 2e-4
FWD_TOL = 2e-4
LR = 1e-3

BASE = dict(vocab_size=128, d_model=64, n_heads=4, n_layers=2, d_ff=128,
            max_seq_len=64, dtype="float32")
PIPE = dict(vocab_size=64, d_model=32, n_heads=2, n_layers=4, d_ff=64,
            max_seq_len=32, dtype="float32")

# name -> (config overrides of BASE, port plan options, (batch shape,
#          PRNGKey of the mirrored test's batch), JAX mesh plan of its
#          sharded step)
DP_TP = {
    "sharded": ({}, {}, ((4, 33), 1), (2, 4)),                      # :228
    "flash": ({"n_heads": 2, "n_layers": 1, "max_seq_len": 128,
               "flash_min_seq": 128}, {}, ((4, 129), 2), (2, 2)),   # :201
    "accum": ({}, {"accum": 2}, ((8, 32), 1), (2, 4)),              # :276
    "zero1": ({}, {"zero1": True}, ((4, 33), 1), (2, 4)),           # :308
    "fsdp": ({}, {"fsdp": True}, ((4, 33), 1), (2, 4)),             # :2293
    "moe": ({"moe_experts": 4}, {}, ((4, 33), 2), (2, 4)),          # :1534
    "moe_capacity": ({"moe_experts": 4, "moe_train_capacity": 1.25},
                     {}, ((4, 33), 2), (2, 4)),
    "gqa_kv_replicated": ({"n_kv_heads": 1}, {}, ((4, 33), 1), (2, 4)),
}
# name -> (config, port plan, (train batch shape, PRNGKey)); the forward
# batch is the mirrored tests' (8, 12) from PRNGKey(1)
PIPELINE = {
    "pp4": (PIPE, dict(data=1, model=1, pipe=4), ((8, 13), 2)),     # :1719
    "dp2_pp2": (PIPE, dict(data=2, model=1, pipe=2), ((8, 13), 2)),  # :1787
    "pp2_tp2": (PIPE, dict(data=1, model=2, pipe=2), ((8, 13), 2)),  # :1830
    "pp2_ep2_moe": ({**BASE, "n_heads": 2, "n_layers": 4,           # :1878
                     "max_seq_len": 32, "moe_experts": 2},
                    dict(data=1, model=2, pipe=2), ((8, 33), 2)),
}
FORWARD = ((8, 12), 1)
MICROBATCHES = 4


def jax_config(cfg: dict):
    return jtf.TransformerConfig(**{**cfg, "dtype": jnp.dtype(cfg["dtype"])})


def jax_params(cfg: dict):
    return jtf.init_params(jax.random.PRNGKey(0), jax_config(cfg))


def batch(shape_key, vocab):
    """The mirrored reference test's batch: ``jax.random.randint`` of its
    PRNGKey and shape."""
    shape, key = shape_key
    return np.asarray(jax.random.randint(jax.random.PRNGKey(key), shape, 0,
                                         vocab, jnp.int32))


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def start_world(tmp, cases, world=4):
    """Start one gloo world of ``world`` child ranks running every case;
    returns (children, results dir). The caller computes the JAX side
    while they run, then calls ``finish_world``."""
    out = tmp / "out"
    out.mkdir()
    spec = {"world": world, "init_file": str(tmp / "rendezvous"),
            "out": str(out), "cases": cases, "timeout": 120}
    (tmp / "spec.json").write_text(json.dumps(spec))
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": os.pathsep.join([ROOT, os.path.join(ROOT, "tests")])}
    procs = []
    try:
        for rank in range(world):
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "torch_rank_jobs",
                 str(tmp / "spec.json"), str(rank)],
                cwd=ROOT, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
    except BaseException:
        finish_world(procs, timeout=0)
        raise
    return procs, out


def finish_world(procs, timeout=240):
    """Wait for every child (killing any still alive at the end) and
    require each to have exited 0."""
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0] if timeout else "")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]


def write_inputs(tmp, name, cfg, shape, forward_shape=None):
    np.savez(tmp / f"{name}_params.npz", **flat(jax_params(cfg)))
    np.savez(tmp / f"{name}_tokens.npz",
             tokens=batch(shape, cfg["vocab_size"]))
    case = {"name": name, "config": cfg,
            "params": str(tmp / f"{name}_params.npz"),
            "tokens": str(tmp / f"{name}_tokens.npz"),
            "learning_rate": LR}
    if forward_shape:
        np.savez(tmp / f"{name}_forward.npz",
                 tokens=batch(forward_shape, cfg["vocab_size"]))
        case["forward_tokens"] = str(tmp / f"{name}_forward.npz")
    return case


@pytest.fixture(scope="module")
def dp_tp_world(tmp_path_factory):
    """(rank 0's results dir, the JAX side of each case), the JAX side
    computed while the children run."""
    tmp = tmp_path_factory.mktemp("dp_tp")
    cases = []
    for name, (over, opts, shape, _jplan) in DP_TP.items():
        case = write_inputs(tmp, name, {**BASE, **over}, shape)
        case.update(kind="step", plan={"data": 2, "model": 2}, **opts)
        cases.append(case)
    procs, out = start_world(tmp, cases)
    try:
        refs = {name: dp_reference(name) for name in DP_TP}
    finally:
        finish_world(procs)
    return out, refs


@pytest.fixture(scope="module")
def pipeline_world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pipeline")
    cases = []
    for name, (cfg, plan, shape) in PIPELINE.items():
        case = write_inputs(tmp, name, cfg, shape, forward_shape=FORWARD)
        case.update(kind="pipeline", plan=plan, microbatches=MICROBATCHES)
        cases.append(case)
    procs, out = start_world(tmp, cases)
    try:
        refs = {name: pipeline_reference(name) for name in PIPELINE}
    finally:
        finish_world(procs)
    return out, refs


def read(out, name):
    with np.load(out / f"{name}.npz") as npz:
        return {k: npz[k] for k in npz.files}


def assert_close(got: dict, prefix: str, ref: dict, tol: float):
    ref = flat(ref)
    keys = sorted(k[len(prefix):] for k in got if k.startswith(prefix))
    assert keys == sorted(ref), (keys, sorted(ref))
    for k in keys:
        want = np.asarray(ref[k])
        scale = max(float(np.abs(want).max()), 1e-6)
        err = float(np.abs(got[prefix + k] - want).max())
        assert err <= tol * scale, f"{prefix}{k}: {err} > {tol} x {scale}"


def jax_grads(cfg, toks, loss=None):
    """The reference loss's value and gradients (``loss``, a pipelined
    one, jitted: eager, its tick loop runs op by op)."""
    jcfg = jax_config(cfg)
    fn = jax.value_and_grad(loss or jtf.loss_fn)
    if loss is not None:
        fn = jax.jit(fn, static_argnums=2)
    with jax.default_matmul_precision("float32"):
        return fn(jax_params(cfg), jnp.asarray(toks), jcfg)


@jax.jit
def adamw_step(params, grads):
    """The params after one update of the reference optimizer."""
    opt = jtrain.make_optimizer(LR)
    updates, _ = opt.update(grads, opt.init(params), params)
    return jax.tree_util.tree_map(lambda p, u: p + u, params, updates)


# the cases also held to the reference's sharded step itself (ZeRO-1 and
# FSDP change only where state lives; the step is the same function)
SHARDED_STEP = ("sharded", "zero1", "fsdp")


def dp_reference(name):
    """The JAX side of a dp x tp case: the global batch's loss and
    gradients, the reference optimizer's update on them, and for
    SHARDED_STEP the mirrored test's sharded step on its mesh."""
    over, opts, shape, jplan = DP_TP[name]
    cfg = {**BASE, **over}
    params = jax_params(cfg)
    toks = batch(shape, cfg["vocab_size"])
    jloss, jgrads = jax_grads(cfg, toks)
    ref = {"loss": jloss, "grads": jgrads,
           "stepped": adamw_step(params, jgrads)}
    if name in SHARDED_STEP:
        jcfg = jax_config(cfg)
        mesh = make_mesh(jax.devices()[:jplan[0] * jplan[1]],
                         plan=MeshPlan(*jplan))
        rules = None
        if opts.get("fsdp"):
            from containerpilot_tpu.parallel import fsdp_sharding_rules

            rules = fsdp_sharding_rules(jcfg, mesh)
        jstate = jtrain.init_train_state(
            jax.random.PRNGKey(0), jcfg, mesh, learning_rate=LR,
            rules=rules, zero1=opts.get("zero1", False))
        jstep = jtrain.make_train_step(
            jcfg, mesh, learning_rate=LR, zero1=opts.get("zero1", False),
            fsdp=opts.get("fsdp", False))
        with jax.default_matmul_precision("float32"):
            jstate, step_loss = jstep(jstate, jnp.asarray(toks))
        ref["sharded_step"] = (step_loss, jstate.params)
    return ref


def pipeline_reference(name):
    """The JAX side of a pipeline case: the plain forward's logits, the
    pipelined loss and gradients, and the params after one update of the
    reference optimizer on them (what make_pipeline_train_step applies).
    A dense model's pipelined loss is the plain loss (no aux), so dense
    cases use jtf.loss_fn; an MoE model's aux is per microbatch, so it
    runs the reference's pipeline_loss_fn on a pipe-only mesh."""
    from jax.sharding import Mesh

    cfg, plan, shape = PIPELINE[name]
    jcfg = jax_config(cfg)
    params = jax_params(cfg)
    with jax.default_matmul_precision("float32"):
        logits = jtf.forward(
            params, jnp.asarray(batch(FORWARD, cfg["vocab_size"])), jcfg)
    toks = batch(shape, cfg["vocab_size"])
    loss = None
    if cfg.get("moe_experts"):
        mesh = Mesh(np.asarray(jax.devices()[:plan["pipe"]]), ("pipe",))

        def loss(p, t, c):
            return jpipe.pipeline_loss_fn(p, t, c, mesh, MICROBATCHES)
    jloss, jgrads = jax_grads(cfg, toks, loss)
    return np.asarray(logits), jloss, jgrads, adamw_step(params, jgrads)


@pytest.mark.parametrize("name", sorted(DP_TP))
def test_dp_tp_step_matches_jax(dp_tp_world, name):
    """dp2 x tp2 on 4 ranks (experts over model for MoE, kv heads
    replicated where they do not divide) with the case's option (flash
    per shard, accumulation, ZeRO-1, FSDP): the global batch's loss and
    gradients against the reference's, the params after one
    make_train_step against the reference optimizer's update on those
    gradients, and for the plain, ZeRO-1 and FSDP cases against the
    reference's own sharded step on its 8-device mesh."""
    out, refs = dp_tp_world
    got, ref = read(out, name), refs[name]
    np.testing.assert_allclose(float(got["loss"]), float(ref["loss"]),
                               rtol=GRAD_TOL)
    assert_close(got, "grads/", ref["grads"], GRAD_TOL)
    np.testing.assert_allclose(float(got["step_loss"]), float(ref["loss"]),
                               rtol=GRAD_TOL)
    assert_close(got, "params/", ref["stepped"], STEP_TOL)
    if "sharded_step" in ref:
        step_loss, params = ref["sharded_step"]
        np.testing.assert_allclose(float(got["step_loss"]),
                                   float(step_loss), rtol=GRAD_TOL)
        assert_close(got, "params/", params, STEP_TOL)


def test_zero1_and_fsdp_divide_state_by_dp(dp_tp_world):
    """ZeRO-1 halves each rank's Adam moments at dp 2 (every leaf has a
    dim that divides), FSDP halves its params and moments too; the plain
    step's moments mirror its params."""
    out, _refs = dp_tp_world
    plain, zero1, fsdp = (read(out, n) for n in ("sharded", "zero1", "fsdp"))
    assert int(plain["moment_numel"]) == int(plain["param_numel"])
    assert int(zero1["param_numel"]) == int(plain["param_numel"])
    assert 2 * int(zero1["moment_numel"]) == int(plain["moment_numel"])
    assert 2 * int(fsdp["param_numel"]) == int(plain["param_numel"])
    assert int(fsdp["moment_numel"]) == int(fsdp["param_numel"])


@pytest.mark.parametrize("name", sorted(PIPELINE))
def test_pipeline_matches_jax(pipeline_world, name):
    """GPipe over 4 ranks (pp4, dp2 x pp2, pp2 x tp2, pp2 x ep2 with 4
    microbatches): the forward logits against the plain forward (the
    reference's 2e-4), the loss and gradients against the reference's
    pipelined loss, and the params after one make_pipeline_train_step
    against the reference optimizer's update on those gradients."""
    out, refs = pipeline_world
    got = read(out, name)
    logits, jloss, jgrads, stepped = refs[name]
    np.testing.assert_allclose(got["logits"], logits, rtol=FWD_TOL,
                               atol=FWD_TOL)
    np.testing.assert_allclose(float(got["loss"]), float(jloss),
                               rtol=GRAD_TOL)
    assert_close(got, "grads/", jgrads, GRAD_TOL)
    assert float(np.abs(got["grads/layers/wq"]).sum()) > 0
    np.testing.assert_allclose(float(got["step_loss"]), float(jloss),
                               rtol=GRAD_TOL)
    assert_close(got, "params/", stepped, STEP_TOL)
