"""The port's context-parallel training against the JAX package, on the
CPU: the ring's backward (ops/ring_attention.py), the training step on
a ``MeshPlan(data, seq, model)`` mesh (parallel/train.py), and
``memory_efficient_attention`` (ops/flash_training.py).

One gloo world of 4 ranks runs every multi-rank case, as ``python -m
torch_rank_jobs`` children (one thread each, ``file://`` rendezvous
under the test's tmp dir, killed in ``finally``); the pytest process
never makes a process group, and computes the JAX side while the
children run, on the same mesh shapes over ``jax.devices()[:4]``.

- The ring's gradients (dq, dk, dv of sum(out * cotangent)) at seq 4 and
  model 2 x seq 2, GQA native and the MQA fallback, against one-rank
  autograd of the port's plain attention and against ``jax.grad`` of the
  reference ring: ``RING_TOL`` 2e-4, the reference's ring tolerance.
- Mirrors of ``tests/test_workload.py`` :679 (GQA) and :719 on data 1 x
  seq 2 x model 2 and data 2 x seq 2 x model 1, in float32: the loss
  and the gathered gradients within ``CP_TOL`` 1e-4 of the reference's
  context-parallel loss on the same mesh shape (relative to each leaf's
  largest entry), the loss within the reference's rtol 5e-3 of its 2D
  step, and the params after one step within ``STEP_TOL`` of the
  reference optimizer's update; ZeRO-1, FSDP and accumulation under
  ``seq`` held to the same.
- Mirrors of :1903 and :1939 (``memory_efficient_attention``'s value and
  gradients, and the model training with it bound in).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from containerpilot_tpu.models import transformer as jtf
from containerpilot_tpu.ops.flash_training import (
    memory_efficient_attention as jmea,
)
from containerpilot_tpu.ops.ring_attention import ring_attention as jring
from containerpilot_tpu.parallel import MeshPlan as JPlan
from containerpilot_tpu.parallel import context_parallel_config as jcp_config
from containerpilot_tpu.parallel import make_mesh as jmake_mesh
from containerpilot_tpu.parallel import train as jtrain
from containerpilot_tpu_torch.models import transformer as ttf
from containerpilot_tpu_torch.ops import memory_efficient_attention
from containerpilot_tpu_torch.ops.attention import causal_attention
from containerpilot_tpu_torch.parallel import MeshPlan, make_mesh
from containerpilot_tpu_torch.parallel import train as ttrain
from test_torch_parallel import (
    adamw_step,
    assert_close,
    batch,
    finish_world,
    jax_config,
    jax_params,
    read,
    start_world,
    write_inputs,
)

RING_TOL = 2e-4
CP_TOL = 1e-4
STEP_TOL = 2e-4
REF_2D_RTOL = 5e-3
LR = 1e-3

# name -> (plan, (b, s, h, kvh, hd), numpy seed)
RING = {
    "ring_seq4_gqa": (dict(data=1, model=1, seq=4), (2, 64, 4, 2, 16), 0),
    "ring_tp2_seq2_gqa": (dict(data=1, model=2, seq=2), (2, 64, 4, 2, 16), 1),
    "ring_tp2_seq2_mqa": (dict(data=1, model=2, seq=2), (2, 64, 4, 1, 16), 2),
}
CP_BASE = dict(vocab_size=128, d_model=64, n_heads=4, n_layers=2, d_ff=128,
               max_seq_len=64, dtype="float32")
PLANS = {"sp2_tp2": dict(data=1, seq=2, model=2),
         "dp2_sp2": dict(data=2, seq=2, model=1)}
# name -> (config overrides, (batch shape, PRNGKey), mirrored line)
MODELS = {"mha": ({}, ((4, 65), 7)),          # :719
          "gqa": ({"n_kv_heads": 2}, ((4, 65), 8))}  # :679
# the optimizer-state layouts under seq, on dp2 x sp2 with the MHA model
OPTIONS = {"zero1": {"zero1": True}, "fsdp": {"fsdp": True},
           "accum": {"accum": 2}}


def ring_inputs(shape, seed):
    b, s, h, kvh, hd = shape
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, h, hd), dtype=np.float32)
    k = rng.standard_normal((b, s, kvh, hd), dtype=np.float32)
    v = rng.standard_normal((b, s, kvh, hd), dtype=np.float32)
    cot = rng.standard_normal((b, s, h, hd), dtype=np.float32)
    return q, k, v, cot


def cp_cases():
    """(name, config, plan, options, batch) of every step case."""
    for model, (over, shape) in MODELS.items():
        for plan_name, plan in PLANS.items():
            yield f"{model}_{plan_name}", over, plan, {}, shape
    for opt, opts in OPTIONS.items():
        yield f"mha_dp2_sp2_{opt}", {}, PLANS["dp2_sp2"], opts, MODELS[
            "mha"][1]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(rank 0's results dir, the JAX side of every case), the JAX side
    computed while the children run."""
    tmp = tmp_path_factory.mktemp("cp_train")
    cases = []
    for name, (plan, shape, seed) in RING.items():
        q, k, v, cot = ring_inputs(shape, seed)
        np.savez(tmp / f"{name}.npz", q=q, k=k, v=v, cot=cot)
        cases.append({"name": name, "kind": "ring", "plan": plan,
                      "inputs": str(tmp / f"{name}.npz")})
    for name, over, plan, opts, shape in cp_cases():
        case = write_inputs(tmp, name, {**CP_BASE, **over}, shape)
        case.update(kind="step", plan=plan, **opts)
        cases.append(case)
    procs, out = start_world(tmp, cases)
    try:
        refs = {name: ring_reference(name) for name in RING}
        refs.update({name: cp_reference(over, plan, shape)
                     for name, over, plan, _opts, shape in cp_cases()
                     if not name.endswith(tuple(OPTIONS))})
    finally:
        finish_world(procs)
    return out, refs


def ring_reference(name):
    """The reference ring's output and jax.grad on the case's mesh shape,
    and one-rank autograd of the port's plain attention."""
    plan, shape, seed = RING[name]
    q, k, v, cot = ring_inputs(shape, seed)
    mesh = jmake_mesh(jax.devices()[:4], plan=JPlan(**plan))
    h = shape[2]

    def loss(q, k, v):
        return jnp.sum(jring(q, k, v, mesh) * cot)

    with jax.default_matmul_precision("float32"):
        out = jax.jit(lambda q, k, v: jring(q, k, v, mesh))(q, k, v)
        grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(q, k, v)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    plain = causal_attention(tq, tk.repeat_interleave(h // shape[3], 2),
                             tv.repeat_interleave(h // shape[3], 2))
    (plain * torch.from_numpy(cot)).sum().backward()
    return {"jax": (np.asarray(out), *map(np.asarray, grads)),
            "plain": (plain.detach().numpy(), tq.grad.numpy(),
                      tk.grad.numpy(), tv.grad.numpy())}


def cp_reference(over, plan, shape):
    """The reference's context-parallel loss and gradients on the plan's
    mesh shape over 4 devices, its 2D step's loss on data 2 x model 2,
    and the reference optimizer's update on the cp gradients."""
    cfg = {**CP_BASE, **over}
    jcfg = jax_config(cfg)
    params = jax_params(cfg)
    toks = jnp.asarray(batch(shape, cfg["vocab_size"]))
    mesh3 = jmake_mesh(jax.devices()[:4], plan=JPlan(**plan))
    cfg3 = jcp_config(jcfg, mesh3)
    with mesh3, jax.default_matmul_precision("float32"):
        loss3, grads3 = jax.jit(jax.value_and_grad(
            lambda p, t: jtf.loss_fn(p, t, cfg3)))(params, toks)
    mesh2 = jmake_mesh(jax.devices()[:4], plan=JPlan(data=2, model=2))
    state2 = jtrain.init_train_state(jax.random.PRNGKey(0), jcfg, mesh2)
    with jax.default_matmul_precision("float32"):
        _, loss2 = jtrain.make_train_step(jcfg, mesh2)(state2, toks)
    return {"loss": loss3, "grads": grads3, "loss_2d": loss2,
            "stepped": adamw_step(params, grads3)}


@pytest.mark.parametrize("name", sorted(RING))
def test_ring_backward_matches_plain_attention_and_jax(world, name):
    """dq, dk, dv of the ring (GQA at kv-head width, the MQA fallback's
    repeated heads summed by autograd) and its output against one-rank
    autograd of plain attention and jax.grad of the reference ring."""
    out, refs = world
    got = read(out, name)
    for side in ("plain", "jax"):
        for key, want in zip(("out", "dq", "dk", "dv"), refs[name][side]):
            np.testing.assert_allclose(got[key], want, rtol=RING_TOL,
                                       atol=RING_TOL,
                                       err_msg=f"{side} {key}")


@pytest.mark.parametrize("name", [n for n, *_r in cp_cases()])
def test_context_parallel_step_matches_jax(world, name):
    """The cp train step on 4 ranks (the ring in every layer, RoPE at
    the shard's global positions, gradients averaged over data and seq):
    loss and gradients against the reference's cp loss on the same mesh
    shape, the loss against its 2D step (the mirrored tests' check), and
    the params after one step against the reference optimizer's update.
    ZeRO-1, FSDP and accumulation under seq are held to the MHA model's
    dp2 x sp2 reference."""
    out, refs = world
    ref = refs[name if name in refs else "mha_dp2_sp2"]
    got = read(out, name)
    np.testing.assert_allclose(float(got["loss"]), float(ref["loss"]),
                               rtol=CP_TOL)
    np.testing.assert_allclose(float(got["loss"]), float(ref["loss_2d"]),
                               rtol=REF_2D_RTOL)
    assert_close(got, "grads/", ref["grads"], CP_TOL)
    np.testing.assert_allclose(float(got["step_loss"]), float(ref["loss"]),
                               rtol=CP_TOL)
    assert_close(got, "params/", ref["stepped"], STEP_TOL)


def test_seq_axis_refusals():
    """The reference's refusals on a seq mesh: a windowed model (the
    ring has no window) and seq with pipe; capacity routing, which
    counts a whole row's tokens, is refused under seq."""
    from containerpilot_tpu_torch.parallel import context_parallel_config

    mesh = make_mesh(MeshPlan(data=1, model=1, seq=2), world_size=2, rank=0)
    cfg = ttf.TransformerConfig(**{**CP_BASE, "dtype": torch.float32},
                                window=16)
    with pytest.raises(ValueError, match="sliding-window attention"):
        context_parallel_config(cfg, mesh)
    with pytest.raises(ValueError, match="seq and pipe"):
        make_mesh(MeshPlan(data=1, model=1, seq=2, pipe=2), world_size=4,
                  rank=0)
    moe = ttf.TransformerConfig(vocab_size=64, d_model=32, n_heads=2,
                                n_layers=1, d_ff=64, moe_experts=2,
                                moe_train_capacity=1.25)
    with pytest.raises(ValueError, match="moe_train_capacity"):
        ttrain.seq_train_config(moe, mesh)
    assert ttrain.local_rows(torch.arange(2 * 9).reshape(2, 9), mesh
                             ).tolist() == [[0, 1, 2, 3, 4], [9, 10, 11, 12,
                                                              13]]


def test_memory_efficient_attention_value_and_grad():
    """Mirror of :1903: the forward and all three input gradients
    against the port's plain attention and the reference's
    memory_efficient_attention on the same inputs; a ragged length
    raises the reference's message."""
    rng = np.random.default_rng(0)
    shape = (2, 256, 2, 32)
    q, k, v, cot = (rng.standard_normal(shape, dtype=np.float32)
                    for _ in range(4))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = memory_efficient_attention(tq, tk, tv, 64)
    ref = causal_attention(tq, tk, tv)
    np.testing.assert_allclose(out.detach().numpy(), ref.detach().numpy(),
                               rtol=2e-4, atol=2e-4)
    mea_grads = torch.autograd.grad((out * torch.from_numpy(cot)).sum(),
                                    (tq, tk, tv))
    ref_grads = torch.autograd.grad((ref * torch.from_numpy(cot)).sum(),
                                    (tq, tk, tv))

    def jloss(q, k, v):
        return jnp.sum(jmea(q, k, v, 64) * cot)

    with jax.default_matmul_precision("float32"):
        jout = jmea(q, k, v, 64)
        jgrads = jax.grad(jloss, argnums=(0, 1, 2))(q, k, v)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=2e-4, atol=2e-4)
    for name, mg, rg, jg in zip("qkv", mea_grads, ref_grads, jgrads):
        np.testing.assert_allclose(mg.numpy(), rg.numpy(), rtol=5e-4,
                                   atol=5e-4, err_msg=f"d{name}")
        np.testing.assert_allclose(mg.numpy(), np.asarray(jg), rtol=5e-4,
                                   atol=5e-4, err_msg=f"jax d{name}")
    with pytest.raises(ValueError, match="not a multiple of block"):
        memory_efficient_attention(tq[:, :100], tk[:, :100], tv[:, :100], 64)


def test_memory_efficient_attention_in_model_training():
    """Mirror of :1939: the model trains with memory_efficient_attention
    bound in (finite loss and gradients), and its loss and gradients
    equal the plain attention path's."""
    cfg = ttf.TransformerConfig(vocab_size=64, d_model=32, n_heads=2,
                                n_layers=1, d_ff=64, max_seq_len=64,
                                dtype=torch.float32)
    bound = dataclasses.replace(
        cfg, attention_fn=lambda q, k, v: memory_efficient_attention(
            q, k, v, 32))
    params = ttf.init_params(0, cfg, "cpu")
    leaves = ttrain.tree_leaves(params)
    for leaf in leaves:
        leaf.requires_grad_(True)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, 64, (2, 65)))
    results = []
    for c in (bound, cfg):
        loss = ttf.loss_fn(params, tokens, c)
        results.append((loss, torch.autograd.grad(loss, leaves)))
    (loss, grads), (plain_loss, plain_grads) = results
    assert torch.isfinite(loss) and all(torch.isfinite(g).all()
                                        for g in grads)
    np.testing.assert_allclose(loss.item(), plain_loss.item(), rtol=1e-5)
    for g, p in zip(grads, plain_grads):
        np.testing.assert_allclose(g.numpy(), p.numpy(), rtol=1e-4,
                                   atol=1e-5)
