"""Children of the multi-rank checkpoint tests
(``tests/test_torch_ckpt_ranks.py``), with ``tests/`` on PYTHONPATH.

One rank of a gloo world on the CPU running the library cases in order:

    python -m torch_ckpt_jobs SPEC.json RANK

The spec names the world size, a ``file://`` rendezvous path and an
output directory; every case saves and restores in lockstep on one
shared directory under it, and rank 0 writes ``<out>/<case>.pt`` (a
dict of facts and tensors) for the test to assert on. A fact that every
rank must hold (its own blocks restored bit for bit) is the world's
minimum, so one rank's failure shows in rank 0's file.

Or one rank of the train CLI, recording each step's loss:

    python -m torch_ckpt_jobs --train-rank LOG [--kill-after N] -- ARGS...

runs ``containerpilot_tpu_torch.workload.train.main(ARGS)`` through
``chip_smoke.train_rank``, which appends a JSON line to LOG after every
step (``step``, ``loss`` and its timing and launches) and one for the
restore; ``--kill-after N`` SIGKILLs this rank right after step N is
logged (a rank lost mid-run).

The children import torch and the port only and use one thread.
"""
import os
import sys

os.environ.setdefault("OMP_NUM_THREADS", "1")

import torch  # noqa: E402

torch.set_num_threads(1)

# imported lazily by a first checkpointed backward (~3 s): before the
# world forms, so no rank waits on another's import
import torch._dynamo  # noqa: E402,F401

import datetime  # noqa: E402
import json  # noqa: E402

import torch.distributed as dist  # noqa: E402

BASE = dict(vocab_size=128, d_model=64, n_heads=4, n_layers=2, d_ff=128,
            max_seq_len=64, dtype=torch.float32)
LR = 1e-2
LORA_RANK = 4


def tokens(seed, shape):
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(0, BASE["vocab_size"], shape, generator=gen)


def train_cli(argv) -> int:
    """One rank of the train CLI: ``chip_smoke.train_rank`` (the logging
    wrapper the card's train_resume phase runs), here on the CPU."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke

    return chip_smoke.train_rank(argv)


# ---------------------------------------------------------------------------
# the library cases
# ---------------------------------------------------------------------------

def _world_all(mesh, ok: bool) -> bool:
    """True when ``ok`` holds on every rank."""
    bad = torch.tensor([0.0 if ok else 1.0])
    return float(mesh.all_reduce_world(bad)) == 0.0


def _same(a, b) -> bool:
    from containerpilot_tpu_torch.parallel.train import tree_leaves

    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        (torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y)
        for x, y in zip(la, lb))


def _layout(name, cfg, optimizer=None):
    """(mesh, rules, step) of a named layout over the 4-rank world."""
    from containerpilot_tpu_torch.parallel import (
        MeshPlan,
        fsdp_sharding_rules,
        make_mesh,
        make_pipeline_train_step,
        make_train_step,
        param_sharding_rules,
        pipeline_sharding_rules,
    )

    if name == "pp2_tp2":
        mesh = make_mesh(MeshPlan(data=1, model=2, pipe=2), device="cpu")
        step = make_pipeline_train_step(cfg, mesh, LR, 2,
                                        optimizer=optimizer)
        return mesh, pipeline_sharding_rules(cfg, mesh), step
    mesh = make_mesh(MeshPlan(data=2, model=2), device="cpu")
    rules = (fsdp_sharding_rules(cfg, mesh) if name == "fsdp"
             else param_sharding_rules(cfg, mesh))
    step = make_train_step(cfg, learning_rate=LR, optimizer=optimizer,
                           mesh=mesh, zero1=name == "zero1",
                           fsdp=name == "fsdp", rules=rules)
    return mesh, rules, step


def _fresh(cfg, mesh, rules, name, optimizer=None):
    from containerpilot_tpu_torch.models.transformer import init_params
    from containerpilot_tpu_torch.parallel import init_train_state, shard_params

    params = shard_params(init_params(0, cfg, "cpu"), mesh, rules=rules)
    return init_train_state(params, cfg, "cpu", learning_rate=LR,
                            optimizer=optimizer, mesh=mesh,
                            zero1=name == "zero1", rules=rules)


def case_layout(name, out, rank):
    """Train 2 steps, save in lockstep, restore into a fresh skeleton:
    every rank's blocks (params, moments, count) come back bit for bit
    and the next step's loss equals the live state's; the gathered state
    is what rank 0 wrote. dp2_tp2 also checks pruning and a missing
    directory."""
    from containerpilot_tpu_torch.parallel import (
        abstract_train_state,
        latest_step,
        restore_checkpoint,
        save_checkpoint,
    )
    from containerpilot_tpu_torch.parallel.sharding import gather_state

    cfg_ = cfg()
    mesh, rules, step = _layout(name, cfg_)
    state = _fresh(cfg_, mesh, rules, name)
    batch = tokens(1, (4, 33))
    for _ in range(2):
        state, _loss = step(state, batch)
    ck = os.path.join(out, f"ck_{name}")
    figures = save_checkpoint(ck, 2, state, mesh=mesh, layout=step.layout)
    gathered = gather_state(state.params, state.opt_state, mesh,
                            step.layout)
    restored = restore_checkpoint(ck, abstract_train_state(cfg_),
                                  device="cpu", mesh=mesh,
                                  layout=step.layout)
    blocks_equal = (restored.step == 2
                    and _same(restored.params, state.params)
                    and _same(restored.opt_state, state.opt_state))
    _s, live_loss = step(state, batch)
    restored, restored_loss = step(restored, batch)
    facts = {"latest": latest_step(ck),
             "blocks_equal_on_every_rank": _world_all(mesh, blocks_equal),
             "live_loss": float(live_loss),
             "restored_loss": float(restored_loss),
             "figures": figures,
             "gathered_params": gathered[0],
             "gathered_opt_state": gathered[1]}
    if name == "dp2_tp2":
        facts["missing_dir"] = restore_checkpoint(
            os.path.join(out, "nope"), abstract_train_state(cfg_),
            device="cpu", mesh=mesh, layout=step.layout) is None
        pruned = os.path.join(out, "ck_pruned")
        for n in (2, 3):
            save_checkpoint(pruned, n, restored, keep=1, mesh=mesh,
                            layout=step.layout)
        facts["after_prune"] = sorted(os.listdir(pruned))
    return facts


def case_cross(name, out, rank):
    """dp2_tp2's and zero1's checkpoints restored into another layout:
    the restored blocks gathered equal the file's state."""
    from containerpilot_tpu_torch.parallel import (
        abstract_train_state,
        restore_checkpoint,
    )
    from containerpilot_tpu_torch.parallel.sharding import gather_state

    source, target = name.split("_into_")
    cfg_ = cfg()
    mesh, _rules, step = _layout(target, cfg_)
    restored = restore_checkpoint(os.path.join(out, f"ck_{source}"),
                                  abstract_train_state(cfg_), device="cpu",
                                  mesh=mesh, layout=step.layout)
    params, opt_state = gather_state(restored.params, restored.opt_state,
                                     mesh, step.layout)
    _s, loss = step(restored, tokens(1, (4, 33)))
    return {"step": restored.step, "params": params,
            "opt_state": opt_state, "next_loss": float(loss)}


def case_ema(name, out, rank):
    """with_ema on dp2_tp2 (mirror of the reference's EMA test): the
    shadow starts as the params and follows the recurrence; a lockstep
    roundtrip keeps it bit for bit."""
    from containerpilot_tpu_torch.parallel import (
        abstract_train_state,
        ema_params,
        make_optimizer,
        restore_checkpoint,
        save_checkpoint,
        with_ema,
    )
    from containerpilot_tpu_torch.parallel.sharding import gather_state

    decay = 0.9
    opt = with_ema(make_optimizer(LR), decay)
    cfg_ = cfg()
    mesh, rules, step = _layout("dp2_tp2", cfg_, optimizer=opt)
    state = _fresh(cfg_, mesh, rules, "dp2_tp2", optimizer=opt)
    starts_equal = torch.equal(ema_params(state)["layers"]["wq"],
                               state.params["layers"]["wq"])
    manual = state.params["layers"]["wq"].detach().clone()
    batch = tokens(1, (4, 33))
    for _ in range(2):
        state, _loss = step(state, batch)
        manual = decay * manual + (1 - decay) * state.params["layers"]["wq"]
    rec_err = float((ema_params(state)["layers"]["wq"] - manual).abs().max())
    ck = os.path.join(out, "ck_ema")
    save_checkpoint(ck, 2, state, mesh=mesh, layout=step.layout)
    restored = restore_checkpoint(ck, abstract_train_state(cfg_, opt),
                                  device="cpu", mesh=mesh,
                                  layout=step.layout)
    equal = _same(ema_params(restored), ema_params(state))
    gathered = gather_state(state.params, state.opt_state, mesh,
                            step.layout)
    return {"starts_equal": _world_all(mesh, starts_equal),
            "recurrence_err": rec_err,
            "ema_equal_on_every_rank": _world_all(mesh, equal),
            "gathered_ema": gathered[1]["ema"]}


def case_async(name, out, rank):
    """save_checkpoint(wait=False) on dp2_tp2 (mirror of the reference's
    async test): the state is taken at the call, three more steps move
    the live params, and after wait_for_checkpoints the restore equals
    the saved step."""
    from containerpilot_tpu_torch.parallel import (
        abstract_train_state,
        restore_checkpoint,
        save_checkpoint,
        wait_for_checkpoints,
    )

    cfg_ = cfg()
    mesh, rules, step = _layout("dp2_tp2", cfg_)
    state = _fresh(cfg_, mesh, rules, "dp2_tp2")
    batch = tokens(1, (4, 33))
    state, _loss = step(state, batch)
    saved = state.params["layers"]["wq"].detach().clone()
    ck = os.path.join(out, "ck_async")
    save_checkpoint(ck, 1, state, wait=False, mesh=mesh, layout=step.layout)
    for _ in range(3):
        state, _loss = step(state, batch)
    moved = not torch.equal(state.params["layers"]["wq"], saved)
    wait_for_checkpoints(mesh)
    restored = restore_checkpoint(ck, abstract_train_state(cfg_),
                                  device="cpu", mesh=mesh,
                                  layout=step.layout)
    return {"moved": _world_all(mesh, moved), "step": restored.step,
            "restored_equal_on_every_rank": _world_all(
                mesh, torch.equal(restored.params["layers"]["wq"], saved))}


def case_write_fails(name, out, rank):
    """Rank 0 cannot write (the directory is a regular file): a
    synchronous save raises on every rank, and an asynchronous one at
    the next wait_for_checkpoints, on every rank."""
    from containerpilot_tpu_torch.parallel import (
        save_checkpoint,
        wait_for_checkpoints,
    )

    cfg_ = cfg()
    mesh, rules, step = _layout("dp2_tp2", cfg_)
    state = _fresh(cfg_, mesh, rules, "dp2_tp2")
    blocked = os.path.join(out, "not_a_dir")
    if rank == 0:
        with open(blocked, "w") as fh:
            fh.write("x")
    mesh.all_reduce_world(torch.zeros(1))  # the file exists for every rank
    raised = []
    for wait in (True, False):
        try:
            save_checkpoint(blocked, 1, state, wait=wait, mesh=mesh,
                            layout=step.layout)
            wait_for_checkpoints(mesh)
            raised.append("")
        except RuntimeError as exc:
            raised.append(str(exc))
    ok = all("checkpoint save failed on rank 0" in r for r in raised)
    return {"raised_on_every_rank": _world_all(mesh, ok), "messages": raised}


def case_lora(name, out, rank):
    """LoRA on dp2_tp2 (mirror of the reference's LoRA test) from the
    JAX package's base and fresh adapter (``<out>/lora_inputs.pt``,
    numpy trees): the adapter reproduces the base (B = 0); 15 steps
    lower the loss with the base's blocks untouched; the adapter
    checkpoint round-trips in lockstep, params-only too. Rank 0 also
    writes the adapter and the losses for the comparisons with the
    reference and with one rank."""
    from containerpilot_tpu_torch import bridge
    from containerpilot_tpu_torch.models import transformer as tf
    from containerpilot_tpu_torch.models.lora import apply_lora
    from containerpilot_tpu_torch.parallel import (
        MeshPlan,
        make_lora_train_step,
        make_mesh,
        restore_checkpoint,
        restore_params,
        save_checkpoint,
        shard_params,
    )
    from containerpilot_tpu_torch.parallel.train import TrainState, _master

    cfg_ = cfg()
    mesh = make_mesh(MeshPlan(data=2, model=2), device="cpu")
    inputs = torch.load(os.path.join(out, "lora_inputs.pt"),
                        weights_only=False)
    base = shard_params(bridge.params_from_jax(inputs["base"], "cpu"), mesh,
                        cfg_)
    batch = tokens(1, (8, 33))
    init_fn, step_fn, abstract = make_lora_train_step(cfg_, LORA_RANK, LR,
                                                      mesh=mesh)
    state = TrainState(_master(bridge.lora_from_jax(inputs["adapter"],
                                                    "cpu")),
                       init_fn(3, "cpu").opt_state, 0)
    rows = batch[:, :-1]
    with torch.no_grad():
        plain, _ = tf.forward_with_aux(base, rows, cfg_, mesh)
        merged, _ = tf.forward_with_aux(
            apply_lora(base, state.params, cfg_, mesh=mesh), rows, cfg_,
            mesh)
    before = {k: v.clone() for k, v in base["layers"].items()}
    losses = []
    for _ in range(15):
        state, loss = step_fn(state, base, batch)
        losses.append(float(loss))
    base_kept = all(torch.equal(before[k], base["layers"][k])
                    for k in before)
    ck = os.path.join(out, "ck_lora")
    save_checkpoint(ck, 15, state, mesh=mesh)
    resumed = restore_checkpoint(ck, abstract, device="cpu", mesh=mesh)
    only = restore_params(ck, abstract, device="cpu")
    return {"zero_delta": torch.equal(plain, merged),
            "losses": losses,
            "base_kept_on_every_rank": _world_all(mesh, base_kept),
            "resumed_step": resumed.step,
            "resumed_equal_on_every_rank": _world_all(
                mesh, _same(resumed.params, state.params)
                and _same(resumed.opt_state, state.opt_state)),
            "params_only_step": only[1],
            "params_only_equal": torch.equal(only[0]["wq_a"],
                                             state.params["wq_a"]),
            "adapter": {k: v.detach() for k, v in state.params.items()}}


def cfg():
    from containerpilot_tpu_torch.models.transformer import TransformerConfig

    return TransformerConfig(**BASE)


CASES = [
    ("dp2_tp2", case_layout), ("zero1", case_layout),
    ("fsdp", case_layout), ("pp2_tp2", case_layout),
    ("dp2_tp2_into_pp2_tp2", case_cross), ("zero1_into_dp2_tp2", case_cross),
    ("ema", case_ema), ("async", case_async),
    ("write_fails", case_write_fails), ("lora", case_lora),
]


def main(argv) -> int:
    if "--train-rank" in argv:
        return train_cli(argv)
    spec_path, rank = argv[0], int(argv[1])
    with open(spec_path) as fh:
        spec = json.load(fh)
    dist.init_process_group(
        "gloo", init_method=f"file://{spec['init_file']}", rank=rank,
        world_size=spec["world"],
        timeout=datetime.timedelta(seconds=spec.get("timeout", 120)))
    try:
        for name, fn in CASES:
            facts = fn(name, spec["out"], rank)
            if rank == 0:
                torch.save(facts, os.path.join(spec["out"], f"{name}.pt"))
            print(f"rank {rank}: {name} done", flush=True)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
