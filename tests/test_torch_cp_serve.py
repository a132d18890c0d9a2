"""The port's context-parallel serving (``--cp``) against the JAX
package, on the CPU: the server rings long single-row prompts over the
mesh's seq axis, through the Batcher's path (``run_cp``) and through the
slot engine's admission, alone and beside tensor parallelism; its
refusals at construction.

One gloo world of 4 ranks runs every server, as ``python -m
torch_serve_jobs`` children: rank 0 is the front (``InferenceServer``
with its lockstep, requests over HTTP on 127.0.0.1:0), ranks 1-3
``ServingFollower``s. The pytest process never makes a process group;
it computes JAX ``generate`` (the reference's vanilla server) and the
one-rank port while the children run. Construction refusals run in the
pytest process on layout-only meshes (no collective is reached).

Mirrors ``tests/test_workload.py`` :518 (``--cp`` vs vanilla, Batcher
and ``slots=2``, on seq 4 and on model 2 x seq 2 — the reference's 8
devices become 4 ranks — with ``/v1/model``'s ``cp`` and ``mesh``; bad
compositions and thresholds fail at construction) and
``tests/test_slots.py`` :703 (the prefix cache refuses cp and window).
Greedy tokens equal JAX's exactly; the sampled request equals the
one-rank port's (the same threefry keys); every rank's tokens agree.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from containerpilot_tpu.models import decode as jdecode
from containerpilot_tpu.models import transformer as jtf
from containerpilot_tpu_torch import bridge
from containerpilot_tpu_torch.models import decode as tdecode
from containerpilot_tpu_torch.models import transformer as ttf
from containerpilot_tpu_torch.parallel.mesh import MeshPlan, make_mesh
from containerpilot_tpu_torch.workload.serve import InferenceServer
from containerpilot_tpu_torch.workload.serve_prefix import PrefixCache
from containerpilot_tpu_torch.workload.serve_slots import SlotEngine
from torch_serve_jobs import finish_world, flat, results, start_world

WORLD = 4
CFG = dict(vocab_size=64, d_model=32, n_heads=4, n_kv_heads=2, n_layers=2,
           d_ff=64, max_seq_len=128, dtype="float32")
MAX_LEN = 128
MIN_LEN = 32
LONG = np.random.default_rng(0).integers(0, 64, size=45).tolist()
REQUESTS = [
    {"tokens": [LONG], "max_new_tokens": 6},
    {"tokens": [LONG], "max_new_tokens": 5, "temperature": 0.8,
     "top_k": 10, "seed": 4},
    {"tokens": [[1, 2, 3]], "max_new_tokens": 4},  # short: the plain path
]
PLANS = {"cp4": dict(data=1, model=1, seq=4),
         "cp2xtp2": dict(data=1, model=2, seq=2)}
# name -> (plan, slots)
SERVERS = {f"{plan}_{mode}": (plan, slots)
           for plan in PLANS for mode, slots in (("batcher", 0),
                                                 ("slots", 2))}


@pytest.fixture(scope="module")
def jax_params():
    jcfg = jtf.TransformerConfig(**{**CFG, "dtype": jnp.float32})
    return jcfg, jtf.init_params(jax.random.PRNGKey(0), jcfg)


@pytest.fixture(scope="module")
def port():
    """(config, one-rank params) of the port, bridged."""
    jcfg = jtf.TransformerConfig(**{**CFG, "dtype": jnp.float32})
    tree = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    return (ttf.TransformerConfig(**bridge.config_kwargs(CFG)),
            bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, tree),
                                   "cpu"))


@pytest.fixture(scope="module")
def world(tmp_path_factory, jax_params):
    """(results dir, JAX's greedy answers by request index)."""
    tmp = tmp_path_factory.mktemp("cp_serve")
    jcfg, tree = jax_params
    np.savez(tmp / "params.npz",
             **flat(jax.tree_util.tree_map(np.asarray, tree)))
    cases = [{"name": name, "kind": "server", "plan": PLANS[plan],
              "config": CFG, "params": str(tmp / "params.npz"),
              "server": {"max_len": MAX_LEN, "cp_min_len": MIN_LEN,
                         "slots": slots},
              "requests": REQUESTS}
             for name, (plan, slots) in SERVERS.items()]
    procs, out = start_world(tmp, cases, WORLD)
    try:
        refs = {i: np.asarray(jdecode.generate(
            tree, jnp.asarray(body["tokens"], jnp.int32), jcfg,
            body["max_new_tokens"], MAX_LEN)).tolist()
            for i, body in enumerate(REQUESTS) if "temperature" not in body}
    finally:
        finish_world(procs)
    return out, refs


@pytest.mark.parametrize("name", list(SERVERS))
def test_serve_cp_long_prompt_matches_vanilla(world, port, name):
    """:518: a server on a seq-axis mesh (alone, or beside tensor
    parallelism) answers the long prompt as a vanilla server does
    (greedy: JAX's tokens; sampled: the one-rank port's), the short one
    takes the plain path, through the Batcher or the slot engine's cp
    admission; /v1/model reports cp and mesh as the reference does; the
    ranks agree."""
    out, refs = world
    plan, slots = SERVERS[name]
    front = results(out, name, WORLD)[0]
    cfg, params = port
    for i, (body, (status, answer)) in enumerate(zip(REQUESTS,
                                                     front["answers"])):
        assert status == 200, answer
        if i in refs:
            assert answer["tokens"] == refs[i], (i, answer)
        else:
            one = tdecode.generate(
                params, torch.tensor(body["tokens"]), cfg,
                body["max_new_tokens"], MAX_LEN,
                temperature=body["temperature"], top_k=body["top_k"],
                rng=body["seed"])
            assert answer["tokens"] == one.tolist()
    info = front["info"]
    seq = PLANS[plan]["seq"]
    assert info["cp"] == {"seq": seq, "min_len": MIN_LEN}
    # the reference reports a mesh only for sharded params (tp > 1)
    assert info["mesh"] == ({"data": 1, "seq": 2, "model": 2}
                            if PLANS[plan]["model"] > 1 else None)
    assert info["lockstep"]["agree"]
    if slots:
        assert info["slot_engine"]["slots"] == slots
        assert info["lockstep"]["step_program"] == "eager"
    else:
        assert info["batching"]["device_calls"] >= 2  # the cp row counted


def _layout(plan):
    p = MeshPlan(**plan)
    return make_mesh(p, world_size=p.n_devices, rank=0)


def test_serve_cp_refusals_at_construction(port):
    """:518's construction checks, with the reference's messages: a
    threshold no prompt can reach, the derived default clamped below
    max_len, the compositions --cp rejects, a mesh without a seq axis."""
    cfg, params = port
    mesh = _layout(PLANS["cp4"])
    with pytest.raises(ValueError, match="never engages"):
        InferenceServer(cfg, params, "127.0.0.1", 0, max_len=MAX_LEN,
                        device="cpu", cp_mesh=mesh, cp_min_len=MAX_LEN)
    defaulted = InferenceServer(cfg, params, "127.0.0.1", 0, max_len=32,
                                device="cpu", cp_mesh=mesh)
    assert defaulted.cp_min_len == 31  # min(8 * 4, max_len - 1)
    for kw, why in (({"draft_layers": 1}, "--draft-layers"),
                    ({"prefix_cache_entries": 2}, "--prefix-cache")):
        with pytest.raises(ValueError, match=f"--cp does not compose with "
                           f"{why}"):
            InferenceServer(cfg, params, "127.0.0.1", 0, max_len=MAX_LEN,
                            device="cpu", cp_mesh=mesh, **kw)
    with pytest.raises(ValueError, match="--cp does not compose with "
                       "--window"):
        InferenceServer(dataclasses.replace(cfg, window=16), params,
                        "127.0.0.1", 0, max_len=MAX_LEN, device="cpu",
                        cp_mesh=mesh)
    with pytest.raises(ValueError, match="needs a seq axis"):
        InferenceServer(cfg, params, "127.0.0.1", 0, max_len=MAX_LEN,
                        device="cpu", cp_mesh=_layout(dict(data=1,
                                                           model=4)))


def test_prefix_cache_rejects_cp_and_window(port):
    """test_slots.py :703: cached prefixes bypass the ring, and a ring
    cache's stale rows are live window context."""
    cfg, params = port
    mesh = _layout(dict(data=1, model=1, seq=2))
    with pytest.raises(ValueError, match="bypass the ring"):
        SlotEngine(cfg, params, MAX_LEN, slots=2, chunk=3, cp_mesh=mesh,
                   prefix_cache=PrefixCache(2))
    with pytest.raises(ValueError, match="window"):
        SlotEngine(dataclasses.replace(cfg, window=8), params, MAX_LEN,
                   slots=2, chunk=3, prefix_cache=PrefixCache(2))
