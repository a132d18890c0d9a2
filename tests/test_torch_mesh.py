"""The port's mesh, sharding rules and layouts against the JAX package,
in the test process (no process group: a mesh made without one is a
layout only).

- ``test_mesh_factorization`` (``tests/test_workload.py:218``) on the
  port's ``make_mesh``, and each rank's coordinates against the
  reference mesh's device grid;
- every leaf's rule of ``param_sharding_rules``,
  ``fsdp_sharding_rules``, ``pipeline_sharding_rules`` and the ZeRO-1
  moment rule equals the reference's ``PartitionSpec`` for the dense,
  GQA and MoE configs;
- ``bridge.shard_from_jax`` gives every rank exactly the block that the
  reference's ``shard_params`` puts on that device of the 8-device CPU
  mesh (``addressable_shards``);
- ``test_pipeline_validates_inputs`` (``:1758``) and the data-axis check
  of ``:1787``;
- a world of one runs today's single-device step bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from containerpilot_tpu.models import transformer as jtf
from containerpilot_tpu.parallel import MeshPlan as JPlan
from containerpilot_tpu.parallel import make_mesh as jmake_mesh
from containerpilot_tpu.parallel import pipeline as jpipe
from containerpilot_tpu.parallel import sharding as jshard
from containerpilot_tpu.parallel import train as jtrain
from containerpilot_tpu_torch import bridge
from containerpilot_tpu_torch.models import transformer as ttf
from containerpilot_tpu_torch.parallel import mesh as tmesh
from containerpilot_tpu_torch.parallel import pipeline as tpipe
from containerpilot_tpu_torch.parallel import sharding as tshard
from containerpilot_tpu_torch.parallel import train as ttrain

SMALL = dict(vocab_size=128, d_model=64, n_heads=4, n_layers=2, d_ff=128,
             max_seq_len=64, dtype="float32")
CONFIGS = {
    "dense": {},
    "gqa": {"n_kv_heads": 2},          # kv heads shard over model 2
    "gqa_replicated": {"n_kv_heads": 1},  # 1 % model: wk/wv replicate
    "moe": {"moe_experts": 4},
}
PLANS = {"dp2_tp4": (2, 4, 1), "dp4_tp2": (4, 2, 1), "dp2_pp2_tp2": (2, 2, 2)}


def configs(name):
    d = {**SMALL, **CONFIGS[name]}
    return (jtf.TransformerConfig(**{**d, "dtype": jnp.float32}),
            ttf.TransformerConfig(**bridge.config_kwargs(d)))


def meshes(plan_name, rank=0):
    data, model, pipe = PLANS[plan_name]
    return (jmake_mesh(jax.devices()[:8], plan=JPlan(data, model, pipe=pipe)),
            tmesh.make_mesh(tmesh.MeshPlan(data, model, pipe=pipe),
                            world_size=8, rank=rank))


def specs_of(tree):
    """A reference tree of PartitionSpecs (or NamedShardings) as tuples."""
    if isinstance(tree, dict):
        return {k: specs_of(v) for k, v in tree.items()}
    spec = getattr(tree, "spec", tree)
    return tuple(spec)


def test_mesh_factorization():
    mesh = tmesh.make_mesh(world_size=8)
    assert mesh.axis_names == ("data", "model")
    assert mesh.shape == {"data": 2, "model": 4}
    assert tmesh.make_mesh().shape == {"data": 1, "model": 1}
    assert tmesh.make_mesh(world_size=4).shape == {"data": 1, "model": 4}
    with pytest.raises(ValueError, match="does not cover"):
        tmesh.make_mesh(tmesh.MeshPlan(3, 2), world_size=8)
    with pytest.raises(ValueError, match="cannot be combined"):
        tmesh.make_mesh(tmesh.MeshPlan(1, 2, seq=2, pipe=2), world_size=8)
    piped = tmesh.make_mesh(tmesh.MeshPlan(2, 2, pipe=2), world_size=8)
    assert piped.axis_names == ("data", "pipe", "model")
    with pytest.raises(RuntimeError, match="layout only"):
        mesh.all_reduce(torch.ones(2), "model")


@pytest.mark.parametrize("plan_name", sorted(PLANS))
def test_rank_coordinates_match_the_reference_device_grid(plan_name):
    """Rank r sits where device r sits in the reference mesh."""
    jmesh, _ = meshes(plan_name)
    grid = np.vectorize(lambda d: d.id)(jmesh.devices)
    for rank in range(8):
        _, tm = meshes(plan_name, rank)
        where = tuple(int(i) for i in np.argwhere(grid == rank)[0])
        assert tuple(tm.coords[a] for a in jmesh.axis_names) == where
        assert tm.axis_names == tuple(jmesh.axis_names)


@pytest.mark.parametrize("cfg_name", sorted(CONFIGS))
@pytest.mark.parametrize("plan_name", ["dp2_tp4", "dp4_tp2"])
def test_rules_match_reference_partition_specs(cfg_name, plan_name):
    """param_sharding_rules, fsdp_sharding_rules and the ZeRO-1 moment
    rule of every leaf equal the reference's specs."""
    jcfg, tcfg = configs(cfg_name)
    jmesh, tm = meshes(plan_name)
    assert tshard.param_sharding_rules(tcfg, tm) == specs_of(
        jshard.param_sharding_rules(jcfg, jmesh))
    assert tshard.fsdp_sharding_rules(tcfg, tm) == specs_of(
        jshard.fsdp_sharding_rules(jcfg, jmesh))
    for zero1 in (False, True):
        ref = jtrain.train_state_shardings(jcfg, jmesh, zero1=zero1)
        mu = ref.opt_state[1][0].mu
        port = ttrain.train_state_shardings(tcfg, tm, zero1=zero1)
        assert port.opt_state["mu"] == specs_of(mu)
        assert port.params == specs_of(ref.params)


@pytest.mark.parametrize("cfg_name", ["dense", "moe"])
def test_pipeline_rules_match_reference(cfg_name):
    jcfg, tcfg = configs(cfg_name)
    jmesh, tm = meshes("dp2_pp2_tp2")
    assert tpipe.pipeline_sharding_rules(tcfg, tm) == specs_of(
        jpipe.pipeline_sharding_rules(jcfg, jmesh))
    assert tpipe.pipeline_sharding_rules(tcfg, tm)["layers"]["wq"] == (
        "pipe", None, "model", None)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("layout", ["tp", "fsdp", "pipeline"])
@pytest.mark.parametrize("cfg_name", ["dense", "gqa_replicated", "moe"])
def test_shard_from_jax_equals_reference_addressable_shards(cfg_name,
                                                            layout):
    """Each rank's blocks equal the shard the reference places on that
    device, for the tensor-parallel, FSDP and pipeline rules."""
    jcfg, tcfg = configs(cfg_name)
    plan_name = "dp2_pp2_tp2" if layout == "pipeline" else "dp2_tp4"
    jmesh, _ = meshes(plan_name)
    if layout == "pipeline":
        jrules = jpipe.pipeline_sharding_rules(jcfg, jmesh)
    elif layout == "fsdp":
        jrules = jshard.fsdp_sharding_rules(jcfg, jmesh)
    else:
        jrules = jshard.param_sharding_rules(jcfg, jmesh)
    params = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    placed = _flat(jshard.shard_params(params, jmesh, jcfg, rules=jrules))
    numpy_tree = jax.tree_util.tree_map(np.asarray, params)
    for rank in range(8):
        _, tm = meshes(plan_name, rank)
        trules = {"tp": tshard.param_sharding_rules,
                  "fsdp": tshard.fsdp_sharding_rules,
                  "pipeline": tpipe.pipeline_sharding_rules}[layout](tcfg, tm)
        mine = _flat(bridge.shard_from_jax(numpy_tree, tm, "cpu",
                                           rules=trules))
        assert sorted(mine) == sorted(placed)
        for key, arr in placed.items():
            shard = next(s for s in arr.addressable_shards
                         if s.device.id == rank)
            np.testing.assert_array_equal(mine[key].numpy(),
                                          np.asarray(shard.data), key)


def test_pipeline_validates_inputs():
    """tests/test_workload.py:1758 on the port (layout-only meshes: the
    checks run before any collective), and :1787's data-axis check."""
    cfg = ttf.TransformerConfig(vocab_size=64, d_model=32, n_heads=2,
                                n_layers=3, d_ff=64, max_seq_len=32)
    mesh = tmesh.make_mesh(tmesh.MeshPlan(1, 1, pipe=4), world_size=4)
    params = ttf.init_params(0, cfg, "cpu")
    tokens = torch.zeros((8, 8), dtype=torch.long)
    with pytest.raises(ValueError, match="not divisible by 4 stages"):
        tpipe.pipeline_forward_with_aux(params, tokens, cfg, mesh)
    cfg2 = ttf.TransformerConfig(vocab_size=64, d_model=32, n_heads=2,
                                 n_layers=4, d_ff=64, max_seq_len=32)
    params2 = ttf.init_params(0, cfg2, "cpu")
    with pytest.raises(ValueError, match="microbatches"):
        tpipe.pipeline_forward_with_aux(
            params2, torch.zeros((6, 8), dtype=torch.long), cfg2, mesh,
            n_microbatches=4)
    dp_pp = tmesh.make_mesh(tmesh.MeshPlan(2, 1, pipe=2), world_size=4)
    with pytest.raises(ValueError, match="data axis"):
        tpipe.pipeline_forward_with_aux(params2, tokens[:4], cfg2, dp_pp,
                                        n_microbatches=4)
    flat_mesh = tmesh.make_mesh(world_size=4)
    with pytest.raises(ValueError, match="no 'pipe' axis"):
        ttrain.make_pipeline_train_step(cfg2, flat_mesh)


def test_batch_rows_per_rank():
    """local_rows splits each accumulation chunk over data (contiguous
    rows without accumulation); microbatch_rows takes each microbatch's
    share (the reference's x_spec)."""
    tokens = torch.arange(8)[:, None].expand(8, 3)
    rows = {r: ttrain.local_rows(tokens, tmesh.make_mesh(
        tmesh.MeshPlan(2, 2), world_size=4, rank=r), 2)[:, 0].tolist()
        for r in range(4)}
    assert rows == {0: [0, 1, 4, 5], 1: [0, 1, 4, 5],
                    2: [2, 3, 6, 7], 3: [2, 3, 6, 7]}
    assert ttrain.local_rows(tokens, tmesh.make_mesh(
        tmesh.MeshPlan(2, 1), world_size=2, rank=1))[:, 0].tolist() == [
        4, 5, 6, 7]
    pp = tmesh.make_mesh(tmesh.MeshPlan(2, 1, pipe=2), world_size=4, rank=2)
    assert tpipe.microbatch_rows(tokens, pp, 4)[:, 0].tolist() == [1, 3, 5, 7]
    with pytest.raises(ValueError, match="not divisible"):
        ttrain.local_rows(tokens[:6], tmesh.make_mesh(
            tmesh.MeshPlan(2, 1), world_size=2), 2)


def test_zero1_layout_slices_moments():
    """ZeRO-1's moments on a dp2 x tp2 rank: each leaf's local block cut
    in two along the moment rule's data dim."""
    _, tcfg = configs("dense")
    mesh = tmesh.make_mesh(tmesh.MeshPlan(2, 2), world_size=4, rank=3)
    rules = tshard.param_sharding_rules(tcfg, mesh)
    params = tshard.shard_params(ttf.init_params(0, tcfg, "cpu"), mesh,
                                 rules=rules)
    layout = ttrain.Layout(mesh, rules, zero1=True)
    moments = layout.moment_zeros(params)
    for p, m in zip(ttrain.tree_leaves(params), ttrain.tree_leaves(moments)):
        assert 2 * m.numel() == p.numel()
    assert ttrain.Layout(mesh, rules).moment_zeros(params)["embed"].shape == \
        params["embed"].shape
    # the clip's replica counts: embed is split over model only (2 of 4
    # ranks hold each block), norms are whole on every rank
    leaf_names = ["embed"] + [f"layers/{k}" for k in sorted(
        rules["layers"])] + ["norm_out", "unembed"]
    replicas = dict(zip(leaf_names, layout.replicas))
    assert replicas["embed"] == 2 and replicas["norm_out"] == 4


def test_world_of_one_is_the_single_device_step_bit_for_bit():
    """A one-rank mesh takes today's path: the same loss and params, bit
    for bit, as make_train_step without a mesh."""
    _, tcfg = configs("dense")
    one = tmesh.make_mesh()
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, 128, (2, 17))).long()
    runs = []
    for mesh in (None, one):
        state = ttrain.init_train_state(0, tcfg, "cpu", mesh=mesh)
        step = ttrain.make_train_step(tcfg, mesh=mesh)
        state, loss = step(state, toks)
        runs.append((loss, state.params))
    assert torch.equal(runs[0][0], runs[1][0])
    for a, b in zip(ttrain.tree_leaves(runs[0][1]),
                    ttrain.tree_leaves(runs[1][1])):
        assert torch.equal(a, b)
    params = ttf.init_params(0, tcfg, "cpu")
    assert torch.equal(ttf.loss_fn(params, toks, tcfg),
                       ttf.loss_fn(params, toks, tcfg, one))
