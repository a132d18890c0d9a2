"""The port's ring attention (ops/ring_attention.py) and context-parallel
generation (parallel/context.py) against the JAX package, on the CPU.

One gloo world of 4 ranks runs every multi-rank case, as ``python -m
torch_serve_jobs`` children (one thread each, ``file://`` rendezvous
under the test's tmp dir, killed in ``finally``); the pytest process
never makes a process group, and computes the JAX side while the
children run, on the same mesh shapes over ``jax.devices()[:4]``. Inputs
come from a numpy seed; params from ``jax.random.PRNGKey(0)``, carried
into each rank's blocks by ``bridge.shard_from_jax``.

Mirrors ``tests/test_workload.py``: :365 (ring vs one device, seq 4 and
data 2 x seq 2), :628 (GQA native), :654 (MQA fallback on model 2 x seq
2), :705 (validation), :387 (``cp_generate`` vs unsharded: seq 4, model 2
x seq 2, sampled, an odd prompt length, the int8 KV cache, the contract's
refusals) and :466 (the remainder's extend pieces capped). Tolerances:
the reference's 2e-4 for ring outputs, greedy tokens exactly (against
JAX ``generate``), sampled tokens exactly against the one-rank port
(torch generators, not threefry), every rank's tokens equal rank 0's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from containerpilot_tpu.models import decode as jdecode
from containerpilot_tpu.models import transformer as jtf
from containerpilot_tpu.ops.attention import causal_attention as jcausal
from containerpilot_tpu.ops.ring_attention import ring_attention as jring
from containerpilot_tpu.parallel import MeshPlan as JPlan
from containerpilot_tpu.parallel import make_mesh as jmake_mesh
from containerpilot_tpu_torch import bridge
from containerpilot_tpu_torch.models import decode as tdecode
from containerpilot_tpu_torch.models import transformer as ttf
from containerpilot_tpu_torch.ops import ring_attention as tring
from containerpilot_tpu_torch.parallel import context as tctx
from containerpilot_tpu_torch.parallel.mesh import MeshPlan, make_mesh
from torch_serve_jobs import finish_world, flat, results, start_world

RING_TOL = 2e-4
WORLD = 4
CP_CFG = dict(vocab_size=64, d_model=32, n_heads=4, n_kv_heads=2,
              n_layers=2, d_ff=64, max_seq_len=128, dtype="float32")
MAX_LEN = 128
SAMPLED = {"temperature": 0.9, "top_k": 12, "seed": 5,
           "logit_bias": {"7": -100.0}}

# name -> (plan, (b, s, h, kvh, hd), numpy seed)
RING = {
    "ring_seq4": (dict(data=1, model=1, seq=4), (2, 128, 2, 2, 32), 0),
    "ring_dp2_seq2": (dict(data=2, model=1, seq=2), (2, 128, 2, 2, 32), 1),
    "ring_gqa": (dict(data=2, model=1, seq=2), (2, 128, 4, 2, 32), 6),
    "ring_mqa_tp2": (dict(data=1, model=2, seq=2), (2, 64, 4, 1, 32), 9),
}
# name -> (plan, config overrides, prompt length, max_new, runs)
CP = {
    "cp_seq4": (dict(data=1, model=1, seq=4), {}, 64, 8,
                [{}, SAMPLED]),
    "cp_seq4_odd": (dict(data=1, model=1, seq=4), {}, 30, 6, [{}]),
    "cp_seq4_kv_int8": (dict(data=1, model=1, seq=4), {"kv_int8": True},
                        64, 6, [{}]),
    "cp_tp2_seq2": (dict(data=1, model=2, seq=2), {}, 64, 8,
                    [{}, SAMPLED]),
}


def ring_inputs(shape, seed):
    b, s, h, kvh, hd = shape
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(sh).astype(np.float32)
                 for sh in ((b, s, h, hd), (b, s, kvh, hd), (b, s, kvh, hd)))


def prompt_of(n, seed=3):
    return np.random.default_rng(seed).integers(
        0, CP_CFG["vocab_size"], size=(1, n)).astype(np.int64)


def jax_cfg(over):
    return jtf.TransformerConfig(**{**CP_CFG, **over, "dtype": jnp.float32})


@pytest.fixture(scope="module")
def jax_params():
    return jtf.init_params(jax.random.PRNGKey(0), jax_cfg({}))


@pytest.fixture(scope="module")
def world(tmp_path_factory, jax_params):
    """(results dir, the JAX side of each case)."""
    tmp = tmp_path_factory.mktemp("ring")
    np.savez(tmp / "params.npz", **flat(jax.tree_util.tree_map(
        np.asarray, jax_params)))
    cases = []
    for name, (plan, shape, seed) in RING.items():
        q, k, v = ring_inputs(shape, seed)
        np.savez(tmp / f"{name}.npz", q=q, k=k, v=v)
        cases.append({"name": name, "kind": "ring", "plan": plan,
                      "inputs": str(tmp / f"{name}.npz")})
    for name, (plan, over, plen, new, runs) in CP.items():
        np.savez(tmp / f"{name}_prompt.npz", prompt=prompt_of(plen))
        cases.append({"name": name, "kind": "generate", "plan": plan,
                      "config": {**CP_CFG, **over},
                      "params": str(tmp / "params.npz"),
                      "prompt": str(tmp / f"{name}_prompt.npz"),
                      "max_new": new, "max_len": MAX_LEN, "runs": runs})
    procs, out = start_world(tmp, cases, WORLD)
    try:
        refs = {}
        for name, (plan, shape, seed) in RING.items():
            q, k, v = (jnp.asarray(x) for x in ring_inputs(shape, seed))
            mesh = jmake_mesh(jax.devices()[:WORLD], plan=JPlan(**plan))
            rep = shape[2] // shape[3]
            with jax.default_matmul_precision("float32"):
                ring = jax.jit(lambda q, k, v: jring(q, k, v, mesh))(q, k, v)
                plain = jcausal(q, jnp.repeat(k, rep, 2),
                                jnp.repeat(v, rep, 2))
            refs[name] = (np.asarray(ring), np.asarray(plain))
        for name, (plan, over, plen, new, runs) in CP.items():
            refs[name] = np.asarray(jdecode.generate(
                jax_params, jnp.asarray(prompt_of(plen), jnp.int32),
                jax_cfg(over), new, MAX_LEN)).tolist()
    finally:
        finish_world(procs)
    return out, refs


@pytest.mark.parametrize("name", list(RING))
def test_ring_attention_matches_one_device_and_jax(world, name):
    """:365 (seq 4; data 2 x seq 2), :628 (GQA native: the ring rotates
    the grouped kv heads) and :654 (MQA on model 2 x seq 2: full heads
    rotate): the port's ring equals causal attention on one device and
    the reference's ring on the same mesh shape within 2e-4."""
    out, refs = world
    ranks = results(out, name, WORLD)
    got = np.asarray(ranks[0]["out"], np.float32)
    ring, plain = refs[name]
    np.testing.assert_allclose(got, plain, rtol=RING_TOL, atol=RING_TOL)
    np.testing.assert_allclose(got, ring, rtol=RING_TOL, atol=RING_TOL)
    for r in ranks[1:]:  # every rank gathered the same whole output
        assert r["out"] == ranks[0]["out"]


def test_ring_attention_validates_inputs():
    """:705 and :628's refusal, with the reference's messages; raised
    before any collective (layout-only meshes)."""
    no_seq = make_mesh(MeshPlan(data=2, model=2), world_size=4, rank=0)
    q = torch.zeros((1, 64, 2, 16))
    with pytest.raises(ValueError, match="no 'seq' axis"):
        tring.ring_attention(q, q, q, no_seq)
    seq4 = make_mesh(MeshPlan(data=1, model=1, seq=4), world_size=4, rank=0)
    ragged = torch.zeros((1, 66, 2, 16))
    with pytest.raises(ValueError, match="not divisible"):
        tring.ring_attention(ragged, ragged, ragged, seq4)
    with pytest.raises(ValueError, match="divide"):
        tring.ring_attention(q, q[:, :, :0], q[:, :, :0], seq4)


@pytest.mark.parametrize("name", list(CP))
def test_cp_generate_matches_unsharded(world, jax_params, name):
    """:387: the prompt's head rings through prefill over the seq axis
    (alone, or beside tensor parallelism on model 2 x seq 2), the cache
    gathers once, and decode gives JAX generate's greedy tokens; an odd
    prompt length extends a remainder; the int8 KV cache composes; the
    sampling contract (seed, top_k, logit_bias) gives the one-rank
    port's tokens; every rank emits the same tokens."""
    out, refs = world
    plan, over, plen, new, runs = CP[name]
    ranks = results(out, name, WORLD)
    for r in ranks[1:]:
        assert r["outs"] == ranks[0]["outs"]
    got = ranks[0]["outs"]
    assert got[0] == refs[name]
    if len(runs) > 1:
        cfg = ttf.TransformerConfig(**bridge.config_kwargs({**CP_CFG,
                                                            **over}))
        params = bridge.params_from_jax(
            jax.tree_util.tree_map(np.asarray, jax_params), "cpu")
        one = tdecode.generate(
            params, torch.from_numpy(prompt_of(plen)), cfg, new, MAX_LEN,
            temperature=0.9, top_k=12, rng=5, logit_bias={7: -100.0})
        assert got[1] == one.tolist()
        assert 7 not in got[1][0]


def test_cp_generate_contract_refusals(jax_params):
    """:387's contract checks, with the reference's messages, raised
    before any collective."""
    cfg = ttf.TransformerConfig(**bridge.config_kwargs(CP_CFG))
    params = bridge.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jax_params), "cpu")
    seq4 = make_mesh(MeshPlan(data=1, model=1, seq=4), world_size=4, rank=0)
    with pytest.raises(ValueError, match="shorter than"):
        tctx.cp_generate(params, torch.ones((1, 3), dtype=torch.int64), cfg,
                         seq4, 4, MAX_LEN)
    with pytest.raises(ValueError, match="exceeds max_len"):
        tctx.cp_generate(params, torch.from_numpy(prompt_of(64)), cfg, seq4,
                         MAX_LEN, MAX_LEN)
    no_seq = make_mesh(MeshPlan(data=1, model=4), world_size=4, rank=0)
    with pytest.raises(ValueError, match="no 'seq' axis"):
        tctx.cp_generate(params, torch.from_numpy(prompt_of(64)), cfg,
                         no_seq, 4, MAX_LEN)
    with pytest.raises(ValueError, match="sliding-window"):
        tctx.context_parallel_config(dataclasses.replace(cfg, window=8),
                                     seq4)
    hooked = tctx.context_parallel_config(cfg, seq4)
    assert hooked.attention_fn.gqa_native and hooked == cfg


def test_cp_remainder_extend_steps_are_capped(monkeypatch):
    """:466: a bucketed head's remainder extends in pieces no larger than
    max(axis, prefill_chunk), summing to the remainder (host-only: the
    ring head and the extend are stubbed)."""
    cfg = ttf.TransformerConfig(**bridge.config_kwargs(
        dict(vocab_size=64, d_model=32, n_heads=2, n_layers=1, d_ff=64,
             max_seq_len=128, dtype="float32")))
    mesh = make_mesh(MeshPlan(data=1, model=1, seq=2), world_size=2, rank=0)
    monkeypatch.setattr(tctx, "_cp_prefill",
                        lambda *a, **k: ("logits", {}))
    widths = []

    def fake_extend(params, cache, chunk, cfg, mesh=None):
        widths.append(int(chunk.shape[1]))
        return "logits", cache

    monkeypatch.setattr(tdecode, "extend", fake_extend)
    prompt = np.zeros((1, 39), np.int64)
    for prefill_chunk, cap in ((8, 8), (0, 2)):
        widths.clear()
        tctx.cp_prefill_with_remainder(None, prompt, cfg, mesh, 128, head=8,
                                       prefill_chunk=prefill_chunk)
        assert sum(widths) == 39 - 8, widths
        assert max(widths) <= cap, widths


def test_cp_threshold_policy_and_head_buckets():
    """The reference's cp threshold table (resolve_cp_min_len) and its
    startup head buckets (cp_head_buckets, pick_cp_head)."""
    from containerpilot_tpu.parallel import context as jctx

    for args in ((0, 4, 128), (2, 4, 128), (64, 4, 128), (0, 8, 32)):
        assert tctx.resolve_cp_min_len(*args) == jctx.resolve_cp_min_len(*args)
    for args in ((0, 128, 128), (128, 4, 128)):
        with pytest.raises(ValueError, match="never engages"):
            tctx.resolve_cp_min_len(*args)
        with pytest.raises(ValueError, match="never engages"):
            jctx.resolve_cp_min_len(*args)
    for args in ((33, 512, 4), (0, 64, 1), (100, 2048, 8)):
        assert tctx.cp_head_buckets(*args) == jctx.cp_head_buckets(*args)
    buckets = tctx.cp_head_buckets(33, 512, 4)
    for plen in (10, 32, 100, 511):
        assert tctx.pick_cp_head(plen, buckets) == jctx.pick_cp_head(
            plen, buckets)
