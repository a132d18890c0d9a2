"""One rank of a gloo world on the CPU, for the multi-rank parity tests
(``tests/test_torch_parallel.py``):

    python -m torch_rank_jobs SPEC.json RANK

with ``tests/`` on PYTHONPATH. The spec names the world size, a
``file://`` rendezvous path, the JAX params of each case (an ``.npz`` the
test process wrote) and the cases; each case runs on its own mesh, and
rank 0 writes ``<out>/<case>.npz`` with the loss, the gathered gradients
and params after one step, and the per-rank facts the tests assert on.
The child imports torch and the port only, uses one thread, and never
outlives its world (every collective has the group's timeout).
"""
import os
import sys

os.environ.setdefault("OMP_NUM_THREADS", "1")

import torch  # noqa: E402

torch.set_num_threads(1)

# modules torch imports lazily on a first checkpointed backward and a
# first foreach update (~3 s): import them before the world forms, or
# the pipeline's stages take that cost one after another
import torch._dynamo  # noqa: E402,F401
import torch.distributed.tensor  # noqa: E402,F401

import datetime  # noqa: E402
import json  # noqa: E402

import numpy as np  # noqa: E402
import torch.distributed as dist  # noqa: E402

from containerpilot_tpu_torch import bridge  # noqa: E402
from containerpilot_tpu_torch.models import transformer as ttf  # noqa: E402
from containerpilot_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from containerpilot_tpu_torch.parallel import pipeline as tpipe  # noqa: E402
from containerpilot_tpu_torch.parallel import sharding as tshard  # noqa: E402
from containerpilot_tpu_torch.parallel import train as ttrain  # noqa: E402


def unflatten(npz) -> dict:
    tree: dict = {}
    for key in npz.files:
        node = tree
        *path, leaf = key.split("/")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = npz[key]
    return tree


def flatten(tree, prefix="") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v.detach().numpy() if isinstance(
                v, torch.Tensor) else np.asarray(v)
    return out


def run_case(case: dict, spec: dict, rank: int) -> None:
    cfg = ttf.TransformerConfig(**bridge.config_kwargs(case["config"]))
    plan = tmesh.MeshPlan(**case["plan"])
    mesh = tmesh.make_mesh(plan, device="cpu")
    with np.load(case["params"]) as npz:
        full = unflatten(npz)
    with np.load(case["tokens"]) as npz:
        tokens = torch.from_numpy(npz["tokens"]).long()
    kind = case["kind"]
    lr = case.get("learning_rate", 3e-4)
    out = {}
    if kind == "pipeline":
        rules = tpipe.pipeline_sharding_rules(cfg, mesh)
    elif case.get("fsdp"):
        rules = tshard.fsdp_sharding_rules(cfg, mesh)
    else:
        rules = tshard.param_sharding_rules(cfg, mesh)
    params = bridge.shard_from_jax(full, mesh, "cpu", rules=rules)
    state = ttrain.init_train_state(params, cfg, "cpu", learning_rate=lr,
                                    mesh=mesh, zero1=case.get("zero1", False),
                                    rules=rules)
    out["param_numel"] = sum(p.numel() for p in ttrain.tree_leaves(
        state.params))
    out["moment_numel"] = sum(p.numel() for p in ttrain.tree_leaves(
        state.opt_state["mu"]))
    if kind == "pipeline":
        m = case["microbatches"]
        if "forward_tokens" in case:
            with np.load(case["forward_tokens"]) as npz:
                ftoks = torch.from_numpy(npz["tokens"]).long()
            logits, aux = tpipe.pipeline_forward_with_aux(
                state.params, ftoks, cfg, mesh, m)
            out["logits"] = logits.numpy()
            out["aux"] = float(aux)
        step = ttrain.make_pipeline_train_step(cfg, mesh, lr, m)
        loss, grads = tpipe.pipeline_value_and_grad(
            state.params, tokens, cfg, mesh, m, step.layout)
    else:
        step = ttrain.make_train_step(
            cfg, accum_steps=case.get("accum", 1), learning_rate=lr,
            mesh=mesh, zero1=case.get("zero1", False),
            fsdp=case.get("fsdp", False))
        fsdp_rules = rules if case.get("fsdp") else None
        loss, grads = ttrain.sharded_value_and_grad(
            state.params, tokens, cfg, mesh, case.get("accum", 1),
            fsdp_rules, step.layout)
    out["loss"] = float(loss)
    full_grads = tshard.gather_params(ttrain.tree_unflatten(state.params, grads), mesh,
                                      rules=rules)
    state, step_loss = step(state, tokens)
    out["step_loss"] = float(step_loss)
    full_params = tshard.gather_params(state.params, mesh, rules=rules)
    if rank == 0:
        arrays = {f"grads/{k}": v for k, v in flatten(full_grads).items()}
        arrays.update({f"params/{k}": v
                       for k, v in flatten(full_params).items()})
        arrays.update({k: np.asarray(v) for k, v in out.items()})
        np.savez(os.path.join(spec["out"], f"{case['name']}.npz"), **arrays)


def main() -> int:
    spec_path, rank = sys.argv[1], int(sys.argv[2])
    with open(spec_path) as fh:
        spec = json.load(fh)
    dist.init_process_group(
        "gloo", init_method=f"file://{spec['init_file']}", rank=rank,
        world_size=spec["world"],
        timeout=datetime.timedelta(seconds=spec.get("timeout", 120)))
    try:
        for case in spec["cases"]:
            run_case(case, spec, rank)
            print(f"rank {rank}: {case['name']} done", flush=True)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
