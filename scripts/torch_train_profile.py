"""Where a training step of the PyTorch/CUDA port spends its time on one
GPU.

    python3 scripts/torch_train_profile.py [--steps 3] [--remat full]

Builds the training configuration and batch that ``chip_smoke.py``
trains (its ``TRAIN_CFG``, ``TRAIN_BATCH`` and ``TRAIN_SEQ``: bench.py:
121-133, vocab 32768, d_model 1024, 8 heads, 8 layers, d_ff 4096, seq
2048, batch 8, flash crossover AUTO; seeded random float32 masters),
with ``--remat`` in place of its remat, runs two warm steps of
``parallel.train.make_train_step``, then ``--steps`` steps under
``torch.profiler`` and prints one JSON line: wall ms per step (host
clock, synchronized), device kernel ms per step, the device's idle
share, kernel launches per step, device ms per step by group (the
hand-written kernels K1/K3/K4, matrix products, everything else) and
the ten kernels with the most device time. Needs a card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

# kernel-name substrings -> group (first match wins)
GROUPS = (
    ("K1 flash_fwd", "flash_fwd_kernel"),
    ("K3 flash_bwd_dq", "flash_bwd_dq_kernel"),
    ("K4 flash_bwd_dkdv", "flash_bwd_dkdv_kernel"),
    ("matrix products", "gemm"),
    ("matrix products", "nvjet"),
    ("matrix products", "xmma"),
    ("matrix products", "cutlass"),
)


def group_of(name: str) -> str:
    low = name.lower()
    for group, key in GROUPS:
        if key in low:
            return group
    return "other"


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", type=int, default=3)
    parser.add_argument("--remat", default="full",
                        choices=("full", "dots", "none"))
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from torch.profiler import ProfilerActivity, profile

    # the configuration and batch chip_smoke.py trains, defined once there
    from chip_smoke import TRAIN_BATCH, TRAIN_CFG, TRAIN_SEQ
    from containerpilot_tpu_torch.models import transformer as tf
    from containerpilot_tpu_torch.ops import _build
    from containerpilot_tpu_torch.parallel import train as tr

    _build.build_all()
    cfg = tf.TransformerConfig(**{**TRAIN_CFG, "remat": args.remat})
    state = tr.init_train_state(0, cfg, "cuda")
    step = tr.make_train_step(cfg)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ + 1),
                           generator=gen, device="cuda")
    for _ in range(2):  # warm
        state, loss = step(state, tokens)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            state, loss = step(state, tokens)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [
        e for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA
    ]
    device_us = sum(e.time_range.elapsed_us() for e in kernels)
    by_name, by_group = {}, {}
    for e in kernels:
        us = e.time_range.elapsed_us()
        by_name[e.name] = by_name.get(e.name, 0.0) + us
        g = group_of(e.name)
        by_group[g] = by_group.get(g, 0.0) + us
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    steps = args.steps
    print(json.dumps({
        "remat": args.remat,
        "steps": steps,
        "loss": float(loss),
        "wall_ms_per_step": wall * 1e3 / steps,
        "device_kernel_ms_per_step": device_us / 1e3 / steps,
        "device_idle_share": 1.0 - device_us / 1e6 / wall,
        "kernel_launches_per_step": len(kernels) / steps,
        "group_ms_per_step": {
            g: us / 1e3 / steps
            for g, us in sorted(by_group.items(), key=lambda kv: -kv[1])
        },
        "top_kernels_ms_per_step": [
            [name[:80], us / 1e3 / steps] for name, us in top
        ],
        "peak_memory_bytes": torch.cuda.max_memory_allocated(),
        "card": smi,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
