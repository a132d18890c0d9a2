"""Time the flash forward K1 of this checkout against another checkout's,
on one GPU, in turns.

    python3 scripts/torch_flash_ab.py --other DIR

``DIR`` is another checkout of the repository (for example the parent
commit unpacked with ``git archive`` into a git-ignored directory). Each
tree runs its own ``chip_smoke.check_flash`` (which builds that tree's
kernel, checks it against the plain version and times it) at the
serving path's shape (b=1, s=1024, h=16, hd=128) and the training path's
(b=8, s=2048, h=8, hd=128), in a process of its own, in the order other,
this, this, other, so both versions are timed on one card under the same
conditions. Prints the card's name and power limit, then one JSON line
per tree and shape: kernel ms, SDPA ms, max error. Needs a card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

SHAPES = [(1, 1024, 16, 16, 128, 0), (8, 2048, 8, 8, 128, 0)]
RUN = """
import json, sys, torch
sys.path.insert(0, ".")
import chip_smoke
gen = torch.Generator(device="cuda")
gen.manual_seed(0)
for case in {shapes!r}:
    row = chip_smoke.check_flash(gen, *case)
    print(json.dumps({{"tree": {tree!r}, "case": case, "ms": row["ms"],
                      "library_ms": row["library_ms"],
                      "max_abs_err": row["max_abs_err"]}}), flush=True)
"""


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--other", required=True,
                        help="root of the other checkout")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    trees = {"other": os.path.abspath(args.other), "this": here}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    for tree in ("other", "this", "this", "other"):
        proc = subprocess.run(
            [sys.executable, "-c", RUN.format(shapes=SHAPES, tree=tree)],
            cwd=trees[tree], timeout=600,
        )
        if proc.returncode != 0:
            print(json.dumps({"tree": tree, "failed": proc.returncode}))
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
