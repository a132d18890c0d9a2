"""Supervised training worker of the port for the capstone mirror
(``tests/test_torch_capstone.py``), the counterpart of
``tests/capstone_worker.py`` built only from the port's pieces:

- rendezvous: ``parallel.distributed.initialize_from_catalog`` through a
  live catalog server (the supervisor's own daemon);
- training: ``parallel.make_train_step`` on a (data, model) mesh of
  processes (``--tp`` on model, the rest on data; ``--tp 0`` is pure
  data parallelism), gloo on the CPU;
- checkpoint/resume: ``parallel.checkpoint`` save/restore in LOCKSTEP on
  ONE SHARED directory (rank 0 decides the resume step and writes the
  gathered state);
- failure detection: ``parallel.StepWatchdog`` armed BEFORE the
  rendezvous with a startup grace: rank 0 hosts the rendezvous store, so
  when it dies a peer can wait inside ``init_process_group`` as silently
  as inside a collective, and the watchdog turns either wait into an
  exit the supervisor restarts.

Fault injection: ``--crash-step N`` exits 1 after completing step N,
once (a sentinel file remembers the crash across the supervisor's
restart). ``--min-step-s`` paces the steps to at least that long, as a
production step lasts, so the supervisor's health check sees the
worker pass before the crash. Writes ``final_loss``, ``params_digest``
(the sum of |params| over the gathered params) and ``resumed_from`` as
JSON to ``--out``.
"""
import argparse
import json
import os
import re
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def _done_step(directory: str) -> int:
    """The newest checkpoint step, read without importing torch (a
    reincarnation of a finished worker exits at once)."""
    try:
        entries = os.listdir(directory)
    except OSError:
        return -1
    steps = [int(m.group(1)) for e in entries
             if (m := re.match(r"^step_(\d+)$", e))]
    return max(steps, default=-1)


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--process-id", type=int, required=True)
    parser.add_argument("--num-processes", type=int, default=2)
    parser.add_argument("--catalog", default="")
    parser.add_argument("--coordinator-port", type=int, default=0)
    parser.add_argument("--steps", type=int, default=6)
    parser.add_argument("--global-batch", type=int, default=8)
    parser.add_argument("--checkpoint-dir", required=True)
    parser.add_argument("--out", required=True)
    parser.add_argument("--crash-step", type=int, default=-1)
    parser.add_argument("--crash-sentinel", default="")
    parser.add_argument("--step-timeout", type=float, default=30.0)
    parser.add_argument("--startup-timeout", type=float, default=120.0)
    parser.add_argument("--heartbeat-file", default="")
    parser.add_argument("--min-step-s", type=float, default=0.0)
    parser.add_argument("--tp", type=int, default=0,
                        help="model-axis size (0: every process on data)")
    args = parser.parse_args()

    # a reincarnation that finds training already finished must NOT
    # rendezvous (its peers may be done and gone); report and exit
    done_before = _done_step(args.checkpoint_dir)
    if done_before >= args.steps:
        print(f"worker {args.process_id}: already complete "
              f"(step {done_before})", flush=True)
        return 0

    os.environ.setdefault("OMP_NUM_THREADS", "1")
    import torch

    torch.set_num_threads(1)
    from containerpilot_tpu_torch.parallel import StepWatchdog

    # armed over the WHOLE startup window (rendezvous, restore, first
    # step) with a generous grace; each beat tightens the deadline
    dog = StepWatchdog(args.step_timeout).start(
        grace_s=max(args.startup_timeout, args.step_timeout))

    from containerpilot_tpu_torch.discovery.consul import ConsulBackend
    from containerpilot_tpu_torch.models.transformer import TransformerConfig
    from containerpilot_tpu_torch.parallel import (
        MeshPlan,
        abstract_train_state,
        gather_params,
        init_train_state,
        initialize_from_catalog,
        make_mesh,
        make_optimizer,
        make_train_step,
        restore_checkpoint,
        save_checkpoint,
    )

    if args.num_processes > 1:
        initialize_from_catalog(
            ConsulBackend(address=args.catalog), args.process_id,
            args.num_processes, coordinator_port=args.coordinator_port,
            advertise_address="127.0.0.1", timeout=180, poll_interval=0.2,
            device="cpu")
    tp = max(1, args.tp)
    assert args.num_processes % tp == 0, (args.num_processes, tp)
    plan = MeshPlan(data=args.num_processes // tp, model=tp)
    mesh = make_mesh(plan, device="cpu")
    assert args.global_batch % plan.data == 0

    cfg = TransformerConfig(
        vocab_size=64, d_model=32, n_heads=2, n_layers=1, d_ff=128,
        max_seq_len=16, dtype=torch.float32, flash_min_seq=0,
    )
    seq = cfg.max_seq_len
    lr = 1e-2
    step_fn = make_train_step(cfg, learning_rate=lr, mesh=mesh)
    layout = getattr(step_fn, "layout", None)
    start = 0
    state = restore_checkpoint(
        args.checkpoint_dir, abstract_train_state(cfg, make_optimizer(lr)),
        device="cpu", mesh=mesh, layout=layout)
    if state is not None:
        start = state.step
        print(f"worker {args.process_id}: resumed at step {start} "
              f"(mesh {plan.data}x{plan.model})", flush=True)
    else:
        state = init_train_state(0, cfg, "cpu", learning_rate=lr, mesh=mesh)

    def global_batch_for(step: int) -> torch.Tensor:
        # every process derives the IDENTICAL global batch and the step
        # takes its rows: data parity with one process by construction
        gen = torch.Generator().manual_seed(10_000 + step)
        return torch.randint(0, cfg.vocab_size, (args.global_batch, seq + 1),
                             generator=gen)

    final_loss = None
    for step in range(start, args.steps):
        t0 = time.monotonic()
        state, loss = step_fn(state, global_batch_for(step))
        final_loss = float(loss)
        dog.beat()
        if args.heartbeat_file:
            with open(args.heartbeat_file, "w") as fh:
                fh.write(str(step))
        # the lockstep save on the world's ONE shared directory
        save_checkpoint(args.checkpoint_dir, step + 1, state, mesh=mesh,
                        layout=layout)
        dog.beat()
        print(f"worker {args.process_id}: step {step} loss "
              f"{final_loss:.5f}", flush=True)
        if step == args.crash_step and args.crash_sentinel:
            if not os.path.exists(args.crash_sentinel):
                with open(args.crash_sentinel, "w") as fh:
                    fh.write(str(step))
                print(f"worker {args.process_id}: injected crash after "
                      f"step {step}", flush=True)
                sys.stdout.flush()
                os._exit(1)
        time.sleep(max(0.0, args.min_step_s - (time.monotonic() - t0)))
    full = gather_params(state.params, mesh, rules=getattr(layout, "rules",
                                                           None))
    digest = float(sum(t.double().abs().sum()
                       for t in _leaves(full)))
    dog.stop()
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
    with open(args.out, "w") as fh:
        json.dump({"process_id": args.process_id, "final_loss": final_loss,
                   "params_digest": digest, "resumed_from": start}, fh)
    print(f"worker {args.process_id}: done (loss {final_loss:.5f})",
          flush=True)
    return 0


def _leaves(tree):
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaves(tree[key])
    else:
        yield tree


if __name__ == "__main__":
    raise SystemExit(main())
