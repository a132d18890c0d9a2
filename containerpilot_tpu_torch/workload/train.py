"""A supervised training process on one GPU (counterpart of
``containerpilot_tpu/workload/train.py``).

What a job's ``exec`` points at, supervised by containerpilot-tpu:

- writes a progress file every step (``--progress-file``) for the job's
  health check;
- posts ``training_*`` metrics to the supervisor's control socket
  (``--control-socket``) every 10 steps;
- trains the flagship transformer on synthetic tokens or token shards
  (``--data-dir``) on one device: ``--device cuda`` (the default; raises
  without a card) or ``--device cpu``;
- on SIGTERM finishes the in-flight step, saves a checkpoint and exits 0;
  a restart resumes at exactly that step and replays the same data
  (across ranks: no save from the signal, as in the reference; every
  rank exits 0 at the same step and a restart resumes from the last
  periodic checkpoint);
- with ``--lora-rank R`` fine-tunes rank-R LoRA adapters on attention q/v
  over a frozen base: the params of the latest checkpoint under
  ``--base-checkpoint-dir`` (a params-only restore), or a fresh init
  ("demo mode") without it; eval, checkpoints, SIGTERM and resume then
  cover the adapters.

Synthetic tokens for step N come from a ``torch.Generator`` seeded from
(1, N), so a resumed run replays its stream exactly; the stream differs
from the JAX trainer's ``jax.random`` one for the same seed. The
reference's ``enable_compile_cache`` has no counterpart: nothing is
jit-compiled here (the CUDA kernels build once into ``build/kernels``).

    python -m containerpilot_tpu_torch.workload.train --steps 20

``--moe-experts E`` trains a switch-routed mixture of experts (drop-free
routing; ``--moe-capacity F`` bounds each expert to ``ceil(F * s / E)``
tokens of a row during training).

Across ranks: each rank is one process. It joins its world through the
catalog (``--catalog file:DIR`` or a Consul address, ``--process-id``,
``--num-processes``) or through the reference's environment variables
(``COORDINATOR_ADDRESS``, ``NUM_PROCESSES``, ``PROCESS_ID``); without
either the world is one rank. The mesh is built from the world as the
reference builds it from its devices: ``--pipeline-stages S
[--tensor-parallel T] [--microbatches M]`` makes a (data, pipe, model)
mesh of S stages and T-way tensor parallelism, else the world factors
into (data, model) with up to 4 on model. ``--zero1`` and ``--fsdp``
shard the optimizer state (and, for fsdp, the params) over data. Every
rank reads the same global batch and trains on its own rows.
``--checkpoint-dir`` names one directory shared by every rank: the
ranks save and restore in lockstep (parallel/checkpoint.py: rank 0
decides the resume step and writes the gathered state, in the
one-process format, so a run of any layout resumes in any other).
``--lora-rank`` trains replicated adapters over the base's blocks, and
``--eval-every`` prints the same ``eval_loss`` on every rank.

    python -m containerpilot_tpu_torch.workload.train --device cpu \
        --catalog file:/tmp/cat --num-processes 4 --process-id R \
        --pipeline-stages 2 --tensor-parallel 2
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import signal
import sys
import threading
import time

import torch

_LORA_PLAIN_ONLY = (
    "--lora-rank composes with the plain trainer only (the adapter "
    "state is tiny; zero1/fsdp/accum/pipeline solve problems LoRA "
    "doesn't have)"
)


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--device", default="cuda",
                        help="cuda (default; raises without a card) or cpu")
    parser.add_argument("--steps", type=int, default=100)
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--seq-len", type=int, default=256)
    parser.add_argument("--d-model", type=int, default=256)
    parser.add_argument("--n-layers", type=int, default=2)
    parser.add_argument("--n-heads", type=int, default=4)
    parser.add_argument("--n-kv-heads", type=int, default=0,
                        help="GQA kv heads (0 = full multi-head)")
    parser.add_argument("--window", type=int, default=0,
                        help="sliding-window attention: each position "
                        "attends the last N positions only (0 = full "
                        "causal); bounds attention FLOPs and the "
                        "serving KV cache")
    parser.add_argument("--loss-chunk", type=int, default=0,
                        help="stream the vocab projection + softmax over "
                        "sequence chunks of N (0 = whole-logits loss)")
    parser.add_argument("--moe-experts", type=int, default=0,
                        help="switch-MoE experts (0 = dense MLP)")
    parser.add_argument("--moe-capacity", type=float, default=0.0,
                        help="capacity factor for bounded expert compute "
                        "during training (0 = drop-free routing)")
    parser.add_argument("--vocab", type=int, default=1024)
    parser.add_argument("--data-dir", default="",
                        help="token shards (shard_*.npy; workload/data.py)"
                        " — default is synthetic data")
    parser.add_argument("--eval-every", type=int, default=0,
                        help="report held-out loss every N steps "
                        "(requires --data-dir and --eval-holdout)")
    parser.add_argument("--eval-holdout", type=int, default=0,
                        help="windows reserved from the shard tail as the "
                        "eval split")
    parser.add_argument("--profile-dir", default="",
                        help="write a torch.profiler trace of steps "
                        "2..2+profile-steps into this dir (chrome trace)")
    parser.add_argument("--profile-steps", type=int, default=3)
    parser.add_argument("--progress-file", default="")
    parser.add_argument("--control-socket", default="")
    parser.add_argument("--learning-rate", type=float, default=3e-4)
    parser.add_argument("--warmup-steps", type=int, default=0,
                        help="linear lr warmup from 0 over N steps")
    parser.add_argument("--decay-steps", type=int, default=0,
                        help="cosine-decay the lr to 10%% of peak over N "
                        "post-warmup steps (0 = constant)")
    parser.add_argument("--ema-decay", type=float, default=0.0,
                        help="maintain an EMA shadow of the params; eval "
                        "and the checkpoint carry it; 0 = off")
    parser.add_argument("--lora-rank", type=int, default=0,
                        help="LoRA fine-tuning: train rank-R adapters on "
                        "attention q/v with the base frozen (0 = full "
                        "training)")
    parser.add_argument("--base-checkpoint-dir", default="",
                        help="with --lora-rank: frozen base weights from "
                        "this checkpoint (params-only restore); default is "
                        "a fresh init (demo)")
    parser.add_argument("--accum-steps", type=int, default=1,
                        help="gradient accumulation: split each batch into "
                        "N sequential chunks (batch must divide)")
    parser.add_argument("--checkpoint-dir", default="")
    parser.add_argument("--checkpoint-every", type=int, default=50)
    parser.add_argument("--checkpoint-async", action="store_true",
                        help="commit checkpoints on a background thread "
                        "after the device->host copy")
    parser.add_argument("--pipeline-stages", type=int, default=0,
                        help="GPipe pipeline stages (0 = no pipeline); "
                        "n_layers must divide by it")
    parser.add_argument("--microbatches", type=int, default=4,
                        help="pipeline microbatches (batch must divide)")
    parser.add_argument("--tensor-parallel", type=int, default=0,
                        help="model-axis size when pipelining "
                        "(0 = all remaining ranks go to data)")
    parser.add_argument("--zero1", action="store_true",
                        help="ZeRO-1: shard adam moments over the data "
                        "axis; optimizer memory per rank drops by the "
                        "data-parallel factor")
    parser.add_argument("--fsdp", action="store_true",
                        help="FSDP (ZeRO-3): shard params, grads and "
                        "moments over the data axis; each layer gathers "
                        "its params at use (subsumes --zero1)")
    world = parser.add_argument_group(
        "the world (default: COORDINATOR_ADDRESS, NUM_PROCESSES and "
        "PROCESS_ID from the environment, else one rank)")
    world.add_argument("--catalog", default="",
                       help="rendezvous through this catalog "
                       "('file:/shared/catalog' or a Consul address)")
    world.add_argument("--process-id", type=int, default=0)
    world.add_argument("--num-processes", type=int, default=1)
    world.add_argument("--coordinator-port", type=int, default=0)
    world.add_argument("--advertise-address", default="",
                       help="the coordinator's address as other ranks "
                       "reach it (default: this host's routable IP)")
    return parser


def join_world(args: argparse.Namespace) -> None:
    """Form the process group the flags or the environment name."""
    from ..parallel import distributed

    if not args.catalog:
        distributed.initialize_from_env(device=args.device)
        return
    from ..discovery import new_backend

    kw = {}
    if args.coordinator_port:
        kw["coordinator_port"] = args.coordinator_port
    distributed.initialize_from_catalog(
        new_backend(args.catalog), args.process_id, args.num_processes,
        advertise_address=args.advertise_address, device=args.device, **kw)


def build_mesh(args: argparse.Namespace, device):
    """The reference's mesh choice (workload/train.py:155-180) over this
    world: (data, pipe, model) for a pipeline, else the factorization."""
    import torch.distributed as dist

    from ..parallel import MeshPlan, make_mesh

    world = dist.get_world_size() if dist.is_initialized() else 1
    if args.pipeline_stages > 1:
        tp = args.tensor_parallel or 1
        if world % (args.pipeline_stages * tp):
            raise SystemExit(
                f"{world} devices not divisible by pipeline-stages x "
                f"tensor-parallel = {args.pipeline_stages} x {tp}"
            )
        return make_mesh(MeshPlan(
            data=world // (args.pipeline_stages * tp), model=tp,
            pipe=args.pipeline_stages), device=device)
    return make_mesh(device=device)


def synthetic_tokens(step: int, batch: int, seq_len: int, vocab: int,
                     device) -> torch.Tensor:
    """Step ``step``'s [batch, seq_len + 1] tokens: a CPU generator
    seeded from (1, step), so the stream is the same on every device and
    a resumed run replays it."""
    gen = torch.Generator()
    gen.manual_seed((1 << 32) | step)
    toks = torch.randint(0, vocab, (batch, seq_len + 1), generator=gen)
    return toks.to(device)


def _write_progress(path: str, step: int, loss: float) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"step": step, "loss": loss, "time": time.time()}, f)
    os.replace(tmp, path)


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    if args.pipeline_stages > 1 and args.loss_chunk:
        raise SystemExit(
            "--loss-chunk does not apply to the pipelined loss "
            "(pipeline_loss_fn computes its own whole-logits CE)"
        )

    import torch.distributed as dist

    from .. import resolve_device
    from ..models.transformer import TransformerConfig, init_params
    from ..parallel import (
        abstract_train_state,
        ema_params,
        fsdp_sharding_rules,
        init_train_state,
        make_optimizer,
        make_pipeline_train_step,
        make_train_step,
        pipeline_sharding_rules,
        restore_checkpoint,
        save_checkpoint,
        wait_for_checkpoints,
        with_ema,
    )
    from ..parallel.mesh import rank_device
    from .flops import count_params, peak_flops, train_flops_per_token
    from .modelcfg import average_eval_loss, derive_d_ff

    resolve_device(args.device)  # no card: raise before any rendezvous
    join_world(args)
    rank = dist.get_rank() if dist.is_initialized() else 0
    device = resolve_device(rank_device(rank, args.device))
    mesh = build_mesh(args, device)
    multi = mesh.size > 1
    if args.eval_every > 0 and not (args.data_dir and args.eval_holdout):
        raise SystemExit("--eval-every requires --data-dir and --eval-holdout")
    if args.profile_dir and args.profile_steps < 1:
        raise SystemExit("--profile-steps must be >= 1")
    cfg = TransformerConfig(
        vocab_size=args.vocab,
        d_model=args.d_model,
        n_heads=args.n_heads,
        n_kv_heads=args.n_kv_heads,
        n_layers=args.n_layers,
        d_ff=derive_d_ff(args.d_model),
        max_seq_len=args.seq_len,
        moe_experts=args.moe_experts,
        moe_train_capacity=args.moe_capacity,
        loss_chunk=args.loss_chunk,
        window=args.window,
    )
    print(f"device: {device}"
          + (f" ({torch.cuda.get_device_name(device)})"
             if device.type == "cuda" else ""), flush=True)
    print(f"mesh: {mesh.shape} on {device.type}", flush=True)
    if multi:
        print(f"rank {rank} of {mesh.size}: collectives over "
              f"{mesh.backend}"
              + (", staged through host buffers" if mesh.staging else ""),
              flush=True)
    optimizer = make_optimizer(
        args.learning_rate,
        warmup_steps=args.warmup_steps,
        decay_steps=args.decay_steps,
    )
    if args.ema_decay:
        optimizer = with_ema(optimizer, args.ema_decay)
    base_params = None
    rules = None
    if args.lora_rank > 0:
        if (args.pipeline_stages > 1 or args.zero1 or args.fsdp
                or args.accum_steps > 1):
            raise SystemExit(_LORA_PLAIN_ONLY)
        base_params, lora_init, train_step, abstract = _lora_setup(
            args, cfg, optimizer, device, mesh)
    elif args.pipeline_stages > 1:
        if args.accum_steps > 1:
            raise SystemExit(
                "--accum-steps composes with the plain trainer only; "
                "pipeline microbatching already bounds activations"
            )
        if args.zero1 or args.fsdp:
            raise SystemExit(
                "--zero1/--fsdp compose with the plain trainer only "
                "(pipeline sharding rules already partition state over "
                "stages)"
            )
        rules = pipeline_sharding_rules(cfg, mesh)
        train_step = make_pipeline_train_step(
            cfg, mesh, args.learning_rate, args.microbatches,
            optimizer=optimizer)
        abstract = abstract_train_state(cfg, optimizer)
    else:
        if args.batch % args.accum_steps:
            raise SystemExit(
                f"--batch {args.batch} not divisible by --accum-steps "
                f"{args.accum_steps}"
            )
        if args.fsdp and multi:
            rules = fsdp_sharding_rules(cfg, mesh)
        train_step = make_train_step(cfg, optimizer,
                                     accum_steps=args.accum_steps,
                                     mesh=mesh, zero1=args.zero1,
                                     fsdp=args.fsdp, rules=rules)
        abstract = abstract_train_state(cfg, optimizer)

    # the step's layout of a sharded state (None: replicated adapters,
    # or one rank)
    layout = getattr(train_step, "layout", None)
    eval_mesh = mesh.with_options(fsdp=rules) if args.fsdp and multi else mesh
    state = None
    start_step = 0
    if args.checkpoint_dir:
        # restore into a meta-device skeleton: no throwaway init
        state = restore_checkpoint(args.checkpoint_dir, abstract,
                                   device=device, mesh=mesh, layout=layout)
        if state is not None:
            start_step = state.step
            print(f"resumed from checkpoint at step {start_step}", flush=True)
    if state is None:
        state = (lora_init(0, device) if base_params is not None
                 else init_train_state(0, cfg, device, optimizer=optimizer,
                                       mesh=mesh, zero1=args.zero1,
                                       rules=rules))

    client = None
    if args.control_socket:
        from ..client import ControlClient

        client = ControlClient(args.control_socket)

    # graceful preemption: the handler only sets a flag; the loop checks
    # it at the step boundary. Installed before any resource exists.
    preempted = threading.Event()
    prev_term = signal.signal(signal.SIGTERM, lambda s, f: preempted.set())

    prefetcher = dataset = None
    profiler = None
    try:
        if args.data_dir:
            from .data import DevicePrefetcher, TokenShardDataset

            dataset = TokenShardDataset(
                args.data_dir, args.seq_len, args.batch,
                vocab_size=cfg.vocab_size,
                holdout_windows=args.eval_holdout,
            )
            prefetcher = DevicePrefetcher(
                dataset, start_step=start_step, device=device
            )
            print(f"data: {dataset.n_windows} train windows "
                  f"(+{dataset.holdout_windows} held out) from "
                  f"{args.data_dir}", flush=True)

        profile_start = start_step + 1 if args.profile_dir else -1
        profile_stop = profile_start + args.profile_steps
        if args.profile_dir and profile_start >= args.steps:
            print("warning: --profile-dir needs at least 2 steps after "
                  "resume; nothing will be profiled", flush=True)

        # the whole model's parameters (a rank holds only its blocks)
        n_params = count_params(init_params(0, cfg, device="meta"))
        n_frozen = 0
        if base_params is not None:
            # the frozen base forwards and carries gradients, trains nothing
            n_frozen = n_params
            n_params = count_params(state.params) + n_frozen
        flops_per_token = train_flops_per_token(cfg, n_params, args.seq_len,
                                                n_frozen=n_frozen)
        # ranks sharing a card share its peak
        peak = (peak_flops(torch.cuda.get_device_name(device))
                * min(mesh.size, torch.cuda.device_count())
                if device.type == "cuda" else None)

        t0 = time.monotonic()
        for step in range(start_step, args.steps):
            if _stop_agreed(preempted, mesh):
                if multi:
                    # a world cannot save from one rank's signal (the
                    # reference's rule): every rank leaves at this step
                    print("preempted: exiting (resume from last periodic "
                          "checkpoint)", flush=True)
                elif args.checkpoint_dir:
                    wait_for_checkpoints()  # drain async saves first
                    save_checkpoint(args.checkpoint_dir, step, state)
                    print(f"preempted: checkpoint saved at step {step}; "
                          "exiting for the supervisor to resume", flush=True)
                else:
                    print("preempted: exiting (no --checkpoint-dir)",
                          flush=True)
                return 0
            if step == profile_start:
                profiler = _start_profiler(device)
            if prefetcher is not None:
                _pstep, tokens = prefetcher.next()
            else:
                tokens = synthetic_tokens(
                    step, args.batch, args.seq_len, cfg.vocab_size, device
                )
            state, loss = train_step(state, tokens)
            loss_value = float(loss)  # the one host sync of a step
            if profiler is not None and step + 1 == profile_stop:
                _stop_profiler(profiler, args.profile_dir)
                profiler = None
            if args.checkpoint_dir and (step + 1) % args.checkpoint_every == 0:
                figures = save_checkpoint(
                    args.checkpoint_dir, step + 1, state,
                    wait=not args.checkpoint_async, mesh=mesh, layout=layout)
                if figures is not None:
                    print(f"checkpoint: step {step + 1} gathered in "
                          f"{figures['gather_s']:.3f} s, written in "
                          f"{figures['write_s']:.3f} s, "
                          f"{figures['host_bytes']} bytes on rank 0's host",
                          flush=True)
            if args.progress_file:
                _write_progress(args.progress_file, step + 1, loss_value)
            if (step + 1) % 10 == 0 or step == start_step:
                # one throughput computation feeds the metric export and
                # the log line, so they can never disagree
                rate = (step + 1 - start_step) / (time.monotonic() - t0)
                tokens_s = rate * args.batch * args.seq_len
                mfu = tokens_s * flops_per_token / peak if peak else None
                if client is not None and (step + 1) % 10 == 0:
                    metrics = {
                        "training_steps_total": 10,
                        "training_loss": loss_value,
                        "training_tokens_per_sec": tokens_s,
                    }
                    if mfu is not None:
                        metrics["training_mfu"] = mfu
                    _post(client, metrics)
                mfu_text = f"{mfu:.3f}" if mfu is not None else "n/a"
                print(f"step {step + 1}: loss={loss_value:.4f} "
                      f"({rate:.1f} steps/s, {tokens_s:.0f} tok/s, "
                      f"mfu={mfu_text})", flush=True)
            if args.eval_every > 0 and (step + 1) % args.eval_every == 0:
                params = (ema_params(state) if args.ema_decay
                          else state.params)
                if base_params is not None:
                    from ..models.lora import apply_lora

                    params = apply_lora(base_params, params, cfg, mesh=mesh)
                eval_loss = average_eval_loss(
                    params, cfg, dataset.n_eval_batches, dataset.eval_batch,
                    mesh=eval_mesh,
                    microbatches=(args.microbatches
                                  if args.pipeline_stages > 1 else 0),
                )
                print(f"step {step + 1}: eval_loss={eval_loss:.4f}",
                      flush=True)
                if client is not None:
                    _post(client, {"training_eval_loss": eval_loss})
    finally:
        signal.signal(signal.SIGTERM, prev_term)
        if prefetcher is not None:
            prefetcher.stop()
        if profiler is not None:
            profiler.stop()
        propagating = sys.exc_info()[0] is not None
        try:
            if args.checkpoint_async and args.checkpoint_dir:
                # an in-flight background save must commit before exit,
                # every rank failing if rank 0's write did (a collective
                # only on a clean exit: a failing world may have lost a
                # peer), but its error must not mask one propagating
                try:
                    wait_for_checkpoints(None if propagating else mesh)
                except Exception:
                    if not propagating:
                        raise
                    logging.getLogger("containerpilot.train").exception(
                        "async checkpoint commit failed"
                    )
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
    return 0


def _stop_agreed(preempted: threading.Event, mesh) -> bool:
    """Whether to leave at this step boundary: this rank's SIGTERM flag,
    or across ranks any rank's (a max over the world, so every rank
    leaves at the same step and none is left in a collective)."""
    stop = preempted.is_set()
    if mesh.size == 1:
        return stop
    flag = torch.tensor([float(stop)], device=mesh.device)
    return bool(mesh.all_reduce_world(flag).item() > 0)


def _lora_setup(args, cfg, optimizer, device, mesh):
    """The frozen base (restored params-only from --base-checkpoint-dir,
    else a fresh init; the rank's blocks across ranks) and the LoRA step
    over it -> (base, init_fn, train_step, abstract state)."""
    from ..models.transformer import init_params
    from ..parallel import (
        abstract_train_state,
        make_lora_train_step,
        param_sharding_rules,
        restore_params,
        shard_params,
    )

    multi = mesh.size > 1
    rules = param_sharding_rules(cfg, mesh) if multi else None
    if args.base_checkpoint_dir:
        restored = restore_params(args.base_checkpoint_dir,
                                  abstract_train_state(cfg), device=device,
                                  mesh=mesh, rules=rules)
        if restored is None:
            raise SystemExit(f"no checkpoint in {args.base_checkpoint_dir}")
        base, base_step = restored
        print(f"lora: frozen base from checkpoint step {base_step}",
              flush=True)
    else:
        base = init_params(0, cfg, device)
        if multi:
            base = shard_params(base, mesh, rules=rules)
        print("lora: fresh-init frozen base (demo mode)", flush=True)
    lora_init, lora_step, abstract = make_lora_train_step(
        cfg, args.lora_rank, args.learning_rate, optimizer=optimizer,
        mesh=mesh)
    print(f"lora: rank {args.lora_rank} adapters on attention q/v",
          flush=True)

    def train_step(state, tokens):
        return lora_step(state, base, tokens)

    return base, lora_init, train_step, abstract


def _post(client, metrics) -> None:
    from ..client import ControlClientError

    try:
        client.put_metric(metrics)
    except ControlClientError as exc:  # the supervisor may be reloading
        logging.getLogger("containerpilot.train").warning(
            "metric post failed: %s", exc
        )


def _start_profiler(device: torch.device):
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    return prof


def _stop_profiler(prof, directory: str) -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.stop()
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, "trace.json")
    prof.export_chrome_trace(path)
    print(f"profiler trace written to {path}", flush=True)


if __name__ == "__main__":
    raise SystemExit(main())
