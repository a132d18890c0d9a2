"""Where a decode step of the PyTorch/CUDA port spends its time on one
GPU.

    python3 scripts/torch_decode_profile.py [--int8] [--batch 1] [--steps 16]
    python3 scripts/torch_decode_profile.py --slots 8 [--int8] [--windows 4]
    python3 scripts/torch_decode_profile.py --beam 4 [--int8] [--steps 16]
    python3 scripts/torch_decode_profile.py --draft-layers 4 [--speculate 4]
        [--int8] [--steps 16]

Builds the 1.2B flagship (vocab 32768, d_model 2048, 16 heads, 16
layers, d_ff 8192; seeded random weights, bf16), prefills ``--batch``
rows of 1024-token prompts, then runs ``--steps`` greedy decode steps
under ``torch.profiler`` and prints one JSON line: wall ms per step
(host clock, synchronized), device kernel ms per step (the sum of CUDA
kernel times the profiler saw), the device's idle share, kernel
launches per step, the device ms and launches per step of the int8
kernel K2 (kernels named ``int8_matmul``; 0 without ``--int8``), and
the ten kernels with the most device time. Needs a card.

With ``--slots S`` it profiles the slot engine's step program instead:
S slots (chunk 8, window 4) admitted with 1024-token prompts, one warm
window, then ``--windows`` steady windows dispatched as the engine
dispatches them (each window four replays of the captured round graph,
the next window enqueued before the previous one's tokens are fetched).
The same numbers come per decode step (one token for every slot), plus
launches per window.

With ``--beam W`` it profiles ``--steps`` steps of beam search
(models/beam.py's loop: a W-row decode step, the log-softmax, the
stable sort of W x vocab scores and the cache reorder) after a
1024-token prefill; with ``--draft-layers N`` it profiles ``--steps``
rounds of the speculative step program (a draft of the first N layers
proposing ``--speculate`` tokens, one verify chunk, the round's one
host fetch and the rewind) after a 1024-token admission, and also
reports the tokens a round emitted.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch


def profile_steps(args, cfg, params, gen):
    """``--steps`` eager decode steps of a ``--batch``-row batch."""
    from torch.profiler import ProfilerActivity, profile

    from containerpilot_tpu_torch.models import decode

    prompt = torch.randint(0, cfg.vocab_size, (args.batch, 1024),
                           generator=gen, device="cuda")
    with torch.inference_mode():
        logits, cache = decode.prefill(params, prompt, cfg, 2048)
        token = torch.argmax(logits, dim=-1)
        for _ in range(4):  # warm
            logits, cache = decode.decode_step(params, cache, token, cfg)
            token = torch.argmax(logits, dim=-1)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(args.steps):
                logits, cache = decode.decode_step(params, cache, token, cfg)
                token = torch.argmax(logits, dim=-1)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    return prof, wall, args.steps


def profile_slots(args, cfg, params, gen):
    """``--windows`` steady windows of the slot engine's step program
    with ``--slots`` slots admitted; returns (profiler, wall seconds,
    decode steps, windows)."""
    from torch.profiler import ProfilerActivity, profile

    from containerpilot_tpu_torch.models import decode, stepprog
    from containerpilot_tpu_torch.workload.serve_slots import _Request

    prog = stepprog.make_step_program(cfg, params, 2048, args.slots, 8,
                                      rounds=4)
    with torch.inference_mode():
        for slot in range(args.slots):
            prompt = torch.randint(0, cfg.vocab_size, (1, 1024),
                                   generator=gen, device="cuda")
            logits, cache = decode.prefill(params, prompt, cfg, 2048)
            prog.admit(slot, _Request(
                tokens=prompt[0].tolist(), max_new=1024, temperature=0.0,
                top_k=0, top_p=0.0, eos_id=-1, pad_id=0, seed=0,
                bias_idx=[-1] * decode.BIAS_SLOTS_MAX,
                bias_val=[0.0] * decode.BIAS_SLOTS_MAX), logits, cache)
            del cache
    budgets = [1024] * args.slots
    prog.tokens(prog.dispatch(budgets, True))  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pending = prog.dispatch(budgets, True)
        for _ in range(args.windows - 1):
            nxt = prog.dispatch(budgets, True)
            prog.tokens(pending)
            pending = nxt
        prog.tokens(pending)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return prof, wall, args.windows * prog.rounds * prog.chunk, args.windows


def profile_beam(args, cfg, params, gen):
    """``--steps`` steps of a ``--beam``-wide beam search."""
    from torch.profiler import ProfilerActivity, profile

    from containerpilot_tpu_torch.models import beam, decode

    prompt = torch.randint(0, cfg.vocab_size, (1, 1024), generator=gen,
                           device="cuda")
    with torch.inference_mode():
        for steps in (4, args.steps):  # warm, then profiled
            logits, cache = decode.prefill(params, prompt, cfg, 2048)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                tokens, _score = beam._beam_loop(
                    params, cache, logits, cfg, steps + 1, args.beam, -1, 0,
                    0.0)
                tokens.tolist()
                wall = time.perf_counter() - t0
            del cache
    return prof, wall, args.steps


def profile_speculative(args, cfg, params, gen):
    """``--steps`` rounds of the speculative step program; returns
    (profiler, wall seconds, rounds, tokens emitted)."""
    from torch.profiler import ProfilerActivity, profile

    from containerpilot_tpu_torch.models import decode, speculative
    from containerpilot_tpu_torch.workload.serve_slots import _Request

    draft, draft_cfg = speculative.layer_prefix_draft(params, cfg,
                                                      args.draft_layers)
    prog = speculative.SpeculativeStepProgram(
        cfg, draft_cfg, params, draft, 2048, speculate=args.speculate)
    prompt = torch.randint(0, cfg.vocab_size, (1, 1024), generator=gen,
                           device="cuda")
    with torch.inference_mode():
        logits, cache = decode.prefill(params, prompt, cfg, 2048)
        prog.admit(0, _Request(
            tokens=prompt[0].tolist(), max_new=1024, temperature=0.0,
            top_k=0, top_p=0.0, eos_id=-1, pad_id=0, seed=0), logits, cache)
    budgets = [1024]
    for _ in range(2):  # warm
        prog.tokens(prog.dispatch(budgets, False))
    torch.cuda.synchronize()
    emitted = 0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            _toks, valid, _run = prog.tokens(prog.dispatch(budgets, False))
            emitted += int(valid[0])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return prof, wall, args.steps, emitted


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--int8", action="store_true")
    parser.add_argument("--batch", type=int, default=1)
    parser.add_argument("--steps", type=int, default=16)
    parser.add_argument("--slots", type=int, default=0)
    parser.add_argument("--windows", type=int, default=4)
    parser.add_argument("--beam", type=int, default=0)
    parser.add_argument("--draft-layers", type=int, default=0)
    parser.add_argument("--speculate", type=int, default=4)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from containerpilot_tpu_torch.models import quantized
    from containerpilot_tpu_torch.models import transformer as tf
    from containerpilot_tpu_torch.ops import _build

    _build.build_all()
    cfg = tf.TransformerConfig(vocab_size=32768, d_model=2048, n_heads=16,
                               n_layers=16, d_ff=8192, max_seq_len=2048)
    params = tf.init_params(0, cfg, device="cuda")
    if args.int8:
        params = quantized.quantize_model_params(params)
    params = quantized.cast_params(params, cfg.dtype)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    windows = emitted = 0
    if args.slots:
        prof, wall, steps, windows = profile_slots(args, cfg, params, gen)
    elif args.beam:
        prof, wall, steps = profile_beam(args, cfg, params, gen)
    elif args.draft_layers:
        prof, wall, steps, emitted = profile_speculative(args, cfg, params,
                                                         gen)
    else:
        prof, wall, steps = profile_steps(args, cfg, params, gen)
    kernels = [
        e for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA
    ]
    device_us = sum(e.time_range.elapsed_us() for e in kernels)
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    k2 = [e for e in kernels if "int8_matmul" in e.name]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(json.dumps({
        "int8": args.int8,
        "batch": args.slots or args.beam or args.batch,
        "slots": args.slots,
        "beam": args.beam,
        "draft_layers": args.draft_layers,
        "speculate": args.speculate if args.draft_layers else None,
        # a step is a speculative round with --draft-layers
        "tokens_per_step": emitted / steps if args.draft_layers else None,
        "steps": steps,
        "windows": windows,
        "kernel_launches_per_window": len(kernels) / windows if windows
        else None,
        "wall_ms_per_step": wall * 1e3 / steps,
        "device_kernel_ms_per_step": device_us / 1e3 / steps,
        "device_idle_share": 1.0 - device_us / 1e6 / wall,
        "kernel_launches_per_step": len(kernels) / steps,
        "int8_matmul_ms_per_step": sum(
            e.time_range.elapsed_us() for e in k2) / 1e3 / steps,
        "int8_matmul_launches_per_step": len(k2) / steps,
        "top_kernels_ms_per_step": [
            [name[:80], us / 1e3 / steps] for name, us in top
        ],
        "card": smi,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
