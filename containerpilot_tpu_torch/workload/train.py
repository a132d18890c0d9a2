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
  a restart resumes at exactly that step and replays the same data.

Synthetic tokens for step N come from a ``torch.Generator`` seeded from
(1, N), so a resumed run replays its stream exactly; the stream differs
from the JAX trainer's ``jax.random`` one for the same seed. The
reference's ``enable_compile_cache`` has no counterpart: nothing is
jit-compiled here (the CUDA kernels build once into ``build/kernels``).

    python -m containerpilot_tpu_torch.workload.train --steps 20

Reference flags for work that is not ported yet (LoRA, pipeline and
tensor parallelism with its microbatches, zero1, fsdp, MoE, sliding
windows) exit with "not ported yet" when set.
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

# reference flags this slice does not run: dest -> (flag, default); any
# other value exits ("--pipeline-stages 1" means no pipeline, as in the
# reference)
_NOT_PORTED = {
    "lora_rank": ("--lora-rank", 0),
    "base_checkpoint_dir": ("--base-checkpoint-dir", ""),
    "pipeline_stages": ("--pipeline-stages", 0),
    "tensor_parallel": ("--tensor-parallel", 0),
    "zero1": ("--zero1", False),
    "fsdp": ("--fsdp", False),
    "moe_experts": ("--moe-experts", 0),
    "moe_capacity": ("--moe-capacity", 0.0),
    "window": ("--window", 0),
    "microbatches": ("--microbatches", 4),
}


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
    parser.add_argument("--loss-chunk", type=int, default=0,
                        help="stream the vocab projection + softmax over "
                        "sequence chunks of N (0 = whole-logits loss)")
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
    parser.add_argument("--accum-steps", type=int, default=1,
                        help="gradient accumulation: split each batch into "
                        "N sequential chunks (batch must divide)")
    parser.add_argument("--checkpoint-dir", default="")
    parser.add_argument("--checkpoint-every", type=int, default=50)
    parser.add_argument("--checkpoint-async", action="store_true",
                        help="commit checkpoints on a background thread "
                        "after the device->host copy")
    not_ported = parser.add_argument_group(
        "reference flags not ported yet (any value but the default exits)"
    )
    for dest, (flag, default) in _NOT_PORTED.items():
        if isinstance(default, bool):
            not_ported.add_argument(flag, dest=dest, action="store_true")
        else:
            not_ported.add_argument(flag, dest=dest, type=type(default),
                                    default=default)
    return parser


def refuse_not_ported(args: argparse.Namespace) -> None:
    for dest, (flag, default) in _NOT_PORTED.items():
        value = getattr(args, dest)
        if value != default and not (dest == "pipeline_stages" and value == 1):
            raise SystemExit(
                f"{flag} is not ported yet to the PyTorch/CUDA trainer "
                "(see ROADMAP.md)"
            )


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
    refuse_not_ported(args)

    from .. import resolve_device
    from ..models.transformer import TransformerConfig
    from ..parallel import (
        abstract_train_state,
        ema_params,
        init_train_state,
        make_optimizer,
        make_train_step,
        restore_checkpoint,
        save_checkpoint,
        wait_for_checkpoints,
        with_ema,
    )
    from .flops import count_params, peak_flops, train_flops_per_token
    from .modelcfg import average_eval_loss, derive_d_ff

    device = resolve_device(args.device)
    if args.batch % args.accum_steps:
        raise SystemExit(
            f"--batch {args.batch} not divisible by --accum-steps "
            f"{args.accum_steps}"
        )
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
        loss_chunk=args.loss_chunk,
    )
    print(f"device: {device}"
          + (f" ({torch.cuda.get_device_name(device)})"
             if device.type == "cuda" else ""), flush=True)
    optimizer = make_optimizer(
        args.learning_rate,
        warmup_steps=args.warmup_steps,
        decay_steps=args.decay_steps,
    )
    if args.ema_decay:
        optimizer = with_ema(optimizer, args.ema_decay)
    train_step = make_train_step(cfg, optimizer, accum_steps=args.accum_steps)

    state = None
    start_step = 0
    if args.checkpoint_dir:
        # restore into a meta-device skeleton: no throwaway init
        state = restore_checkpoint(
            args.checkpoint_dir, abstract_train_state(cfg, optimizer),
            device=device,
        )
        if state is not None:
            start_step = state.step
            print(f"resumed from checkpoint at step {start_step}", flush=True)
    if state is None:
        state = init_train_state(0, cfg, device, optimizer=optimizer)

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

        n_params = count_params(state.params)
        flops_per_token = train_flops_per_token(cfg, n_params, args.seq_len)
        peak = (peak_flops(torch.cuda.get_device_name(device))
                if device.type == "cuda" else None)

        t0 = time.monotonic()
        for step in range(start_step, args.steps):
            if preempted.is_set():
                if args.checkpoint_dir:
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
                save_checkpoint(args.checkpoint_dir, step + 1, state,
                                wait=not args.checkpoint_async)
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
                eval_loss = average_eval_loss(
                    params, cfg, dataset.n_eval_batches, dataset.eval_batch
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
        if args.checkpoint_async and args.checkpoint_dir:
            # an in-flight background save must commit before exit, but
            # its error must not mask one already propagating
            propagating = sys.exc_info()[0] is not None
            try:
                wait_for_checkpoints()
            except Exception:
                if not propagating:
                    raise
                logging.getLogger("containerpilot.train").exception(
                    "async checkpoint commit failed"
                )
    return 0


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
