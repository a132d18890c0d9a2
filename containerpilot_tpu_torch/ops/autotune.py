"""Flash-attention crossover autotuner: measure, choose, persist (the
port's counterpart of ``containerpilot_tpu/ops/autotune.py``).

Produces the per-card table ``ops/tuning.py`` serves
(``ops/tuned/<platform>.json``). For each sequence length it times the
flash kernels against the plain path that ``flash_eligible`` routes to
below the crossover (``ops/attention.py`` ``causal_attention``), in two
kinds:

- ``fwd`` (inference/prefill): K1 alone, ``flash_attention_forward``;
- ``train`` (one differentiable call): K1 forward plus K3 and K4
  through ``flash_attention``'s backward, against autograd through the
  plain path;

and records the crossover that ``TransformerConfig.flash_min_seq =
AUTO`` resolves to. The reference also searches (block_q, block_k)
pairs; the port's kernels tile by their own 64 whatever pair they are
given, so only the default pair is timed, and the table keeps the
reference's schema (``blocks`` holds the default pair,
``speedup_vs_default`` is 1.0). In ``measurements`` the plain path's
times keep the reference's ``xla_fwd_ms``/``xla_train_ms`` keys, so
both packages' ``build_table`` read one dict.

    python -m containerpilot_tpu_torch.ops.autotune --write

Times come from CUDA events around ``n`` back-to-back calls after a
warm-up call, the best of ``reps`` repetitions, divided by ``n``.
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import subprocess
from typing import Dict, Iterable, List

log = logging.getLogger("containerpilot.autotune")

from .tuning import DEFAULT_BLOCK

DEFAULT_PAIR = (DEFAULT_BLOCK, DEFAULT_BLOCK)
# 128-multiples below the untuned crossover (1024) as well as above it
DEFAULT_SEQS = (128, 256, 384, 512, 640, 768, 896, 1024, 2048, 4096, 8192)


def _time_ms(fn, n: int = 5, reps: int = 3) -> float:
    """Device milliseconds a call: CUDA events around ``n`` back-to-back
    calls (one warm-up call first), the best of ``reps``, over ``n``."""
    import torch

    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        stop.record()
        stop.synchronize()
        best = min(best, start.elapsed_time(stop))
    return best / n


def measure(
    seqs: Iterable[int],
    batch: int = 2,
    heads: int = 8,
    head_dim: int = 128,
    n: int = 5,
    reps: int = 3,
    device: str = "cuda",
) -> dict:
    """Raw measurements: per seq, the plain path's fwd/train times and
    the flash kernels' at the default pair (ms), in the reference's
    results schema."""
    import torch

    from .. import resolve_device
    from .attention import causal_attention
    from .flash import flash_attention, flash_attention_forward

    dev = resolve_device(device)
    results: dict = {}
    for seq in seqs:
        gen = torch.Generator(device=dev).manual_seed(seq)
        q, k, v, cot = (
            torch.randn(batch, seq, heads, head_dim, generator=gen,
                        device=dev, dtype=torch.bfloat16)
            for _ in range(4)
        )
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]

        def train_of(attn):
            def step():
                for t in leaves:
                    t.grad = None
                out = attn(*leaves)
                (out.float() * cot.float()).sum().backward()
            return step

        bq, bk = DEFAULT_PAIR
        with torch.no_grad():
            plain_fwd = _time_ms(lambda: causal_attention(q, k, v), n, reps)
            flash_fwd = _time_ms(
                lambda: flash_attention_forward(q, k, v, bq, bk), n, reps)
        entry = {
            "xla_fwd_ms": plain_fwd,
            "xla_train_ms": _time_ms(train_of(causal_attention), n, reps),
            "flash": {
                f"{bq}x{bk}": {
                    "fwd_ms": flash_fwd,
                    "train_ms": _time_ms(
                        train_of(lambda a, b, c: flash_attention(
                            a, b, c, block_q=bq, block_k=bk)),
                        n, reps),
                },
            },
        }
        results[str(seq)] = entry
        log.info("autotune seq %d: %s", seq, json.dumps(entry))
    return results


def build_table(results: dict, platform: str) -> dict:
    """Choose per-seq blocks and the flash/plain crossover per kind, as
    the reference's ``build_table`` does.

    The crossover is the smallest measured seq from which flash beats
    the plain path at EVERY measured seq onward; with no win it lies
    past the largest measured seq. A non-default block pair enters the
    table only if it beats the 128/128 default at that seq, and each
    entry carries its ``speedup_vs_default``."""
    default_key = f"{DEFAULT_PAIR[0]}x{DEFAULT_PAIR[1]}"
    blocks: Dict[str, Dict[str, list]] = {"train": {}, "fwd": {}}
    speedup: Dict[str, Dict[str, float]] = {"train": {}, "fwd": {}}
    wins: Dict[str, Dict[int, bool]] = {"train": {}, "fwd": {}}
    for seq_s, entry in results.items():
        seq = int(seq_s)
        for kind, flash_key, plain_key in (
            ("train", "train_ms", "xla_train_ms"),
            ("fwd", "fwd_ms", "xla_fwd_ms"),
        ):
            best_pair, best_ms = None, float("inf")
            for pair, times in entry["flash"].items():
                if times[flash_key] < best_ms:
                    best_ms = times[flash_key]
                    best_pair = [int(x) for x in pair.split("x")]
            if best_pair is None:
                continue
            default_times = entry["flash"].get(default_key)
            if default_times is not None:
                default_ms = default_times[flash_key]
                if best_pair != list(DEFAULT_PAIR) and best_ms >= default_ms:
                    best_pair, best_ms = list(DEFAULT_PAIR), default_ms
                speedup[kind][seq_s] = round(default_ms / best_ms, 4)
            else:
                log.warning(
                    "autotune seq %s %s: %s baseline unmeasured; "
                    "honesty guard skipped", seq_s, kind, default_key,
                )
            blocks[kind][seq_s] = best_pair
            wins[kind][seq] = best_ms <= entry[plain_key]

    min_seq: Dict[str, int] = {}
    for kind, seq_wins in wins.items():
        measured = sorted(seq_wins)
        crossover = 0
        for seq in reversed(measured):
            if seq_wins[seq]:
                crossover = seq
            else:
                break
        # never extrapolate below the smallest measured win
        min_seq[kind] = crossover if crossover else (
            (measured[-1] + 1) if measured else 0
        )
    return {
        "platform": platform,
        "flash_min_seq": min_seq,
        "blocks": blocks,
        "speedup_vs_default": speedup,
        "measurements": results,
    }


def card_identity() -> List[str]:
    """``nvidia-smi --query-gpu=name,power.limit`` lines, one per card
    (empty where ``nvidia-smi`` is absent)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=False,
        ).stdout
    except (OSError, subprocess.TimeoutExpired):
        return []
    return [line.strip() for line in out.splitlines() if line.strip()]


def main(argv=None) -> int:
    from . import tuning

    parser = argparse.ArgumentParser(description="flash crossover autotuner")
    parser.add_argument("--seqs", default=",".join(map(str, DEFAULT_SEQS)))
    parser.add_argument("--batch", type=int, default=2)
    parser.add_argument("--heads", type=int, default=8)
    parser.add_argument("--head-dim", type=int, default=128)
    parser.add_argument("--n", type=int, default=5)
    parser.add_argument("--reps", type=int, default=3)
    parser.add_argument("--device", default="cuda")
    parser.add_argument(
        "--write", action="store_true",
        help="persist to ops/tuned/<platform>.json (the auto-discovery "
        "path); otherwise print the table to stdout only",
    )
    parser.add_argument("--out", default="", help="explicit output path")
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    seqs = [int(s) for s in args.seqs.split(",") if s]
    results = measure(
        seqs, batch=args.batch, heads=args.heads, head_dim=args.head_dim,
        n=args.n, reps=args.reps, device=args.device,
    )
    table = build_table(results, tuning.platform_slug(args.device))
    table["card"] = card_identity()
    table["shape"] = {"batch": args.batch, "heads": args.heads,
                      "head_dim": args.head_dim, "dtype": "bfloat16"}
    print(json.dumps(table, indent=1))
    if args.write or args.out:
        path = args.out or os.path.join(
            os.path.dirname(os.path.abspath(__file__)), "tuned",
            f"{table['platform']}.json",
        )
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        with open(path, "w") as fh:
            json.dump(table, fh, indent=1)
        print(f"wrote {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
