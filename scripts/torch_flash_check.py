"""Build the flash kernels K1 (forward), K3 (dq) and K4 (dk/dv) and hold
them against their plain versions on one GPU.

    python3 scripts/torch_flash_check.py [--ptxas] [--fwd] [--bwd] [--small] [--all]

Prints the card's name and power limit, then with ``--ptxas`` what
``nvcc -Xptxas -v`` reports for ``csrc/flash_fwd.cu``,
``csrc/flash_bwd_dq.cu`` and ``csrc/flash_bwd_dkdv.cu`` (registers,
shared memory and spills of each instantiation), then one JSON line per
shape from ``chip_smoke.py``'s checks: with ``--fwd`` K1's
(``check_flash``: max error of out and lse against the float32 plain
version, held at 2e-2), with ``--bwd`` K3's and K4's
(``check_flash_bwd``: held at 1e-2 x max|ref|); neither flag means both.
Each line also has a repeat launch's bit equality, kernel ms, TFLOP/s,
bound, plain ms and the SDPA yardstick. ``--small`` checks a few small
shapes first; by default only the training shape (b=8, s=2048, h=8,
hd=128) is checked, ``--all`` runs every shape of
``chip_smoke.FWD_CASES`` / ``chip_smoke.BWD_CASES``. Exits non-zero if
any shape fails. Needs a card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import traceback

import torch

# (b, s, h, kv_heads, hd, window)
FWD_SMALL_CASES = [
    (1, 128, 1, 1, 128, 0),
    (1, 256, 2, 2, 64, 0),
    (2, 512, 4, 2, 128, 0),
    (1, 512, 2, 2, 128, 64),
    (1, 512, 2, 1, 64, 192),
]
# (b, s, h, hd, window)
BWD_SMALL_CASES = [
    (1, 128, 1, 128, 0),
    (1, 256, 2, 64, 0),
    (2, 512, 2, 128, 0),
    (1, 512, 2, 128, 64),
    (1, 512, 2, 64, 192),
]
SOURCES = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkdv")


def ptxas_report(build) -> None:
    with tempfile.TemporaryDirectory() as tmp:
        for name in SOURCES:
            src, _ = build._target(name)
            proc = subprocess.run(
                [build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
                 os.path.join(tmp, f"{name}.so"), src],
                capture_output=True, text=True,
            )
            lines = [ln.strip() for ln in (proc.stdout + proc.stderr).splitlines()
                     if ln.strip()]
            print(json.dumps({"ptxas": name, "rc": proc.returncode,
                              "lines": lines}), flush=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {name}")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--ptxas", action="store_true")
    parser.add_argument("--fwd", action="store_true")
    parser.add_argument("--bwd", action="store_true")
    parser.add_argument("--small", action="store_true")
    parser.add_argument("--all", action="store_true")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    from chip_smoke import (
        BWD_CASES,
        FWD_CASES,
        TRAIN_FWD_CASE,
        check_flash,
        check_flash_bwd,
    )
    from containerpilot_tpu_torch.ops import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    if args.ptxas:
        ptxas_report(_build)
    both = not (args.fwd or args.bwd)
    cases = []
    if args.fwd or both:
        cases += [(check_flash, c) for c in (
            (FWD_SMALL_CASES if args.small else [])
            + (FWD_CASES if args.all else [TRAIN_FWD_CASE]))]
    if args.bwd or both:
        cases += [(check_flash_bwd, c) for c in (
            (BWD_SMALL_CASES if args.small else [])
            + (BWD_CASES if args.all else BWD_CASES[:1]))]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    failed = 0
    for check, case in cases:
        try:
            row = check(gen, *case)
        except Exception:  # report every shape, then fail
            failed += 1
            print(json.dumps({"check": check.__name__, "case": case,
                              "error": traceback.format_exc()}), flush=True)
            torch.cuda.synchronize()
            continue
        print(json.dumps({"check": check.__name__, **row}), flush=True)
    print(json.dumps({"failed": failed, "cases": len(cases), "card": smi}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
