"""Run the port's lint gate on a host, as ``chip_smoke.py``'s ``lint``
phase runs it (``chip_smoke.drive_lint``: ``python -m
containerpilot_tpu_torch.analysis`` in a subprocess), ``--repeat`` times
with nothing beside it.

    python3 scripts/torch_lint_check.py             # 2 runs
    python3 scripts/torch_lint_check.py --repeat 3

Prints the card's name and power limit as nvidia-smi gives them (when
there is a card), then one JSON line a run: exit code, seconds, findings
and baselined entries. A run whose gate fails raises, and the script
exits non-zero.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--repeat", type=int, default=2)
    args = parser.parse_args()
    import chip_smoke

    if shutil.which("nvidia-smi"):
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip(), flush=True)
    for _ in range(args.repeat):
        print(json.dumps(chip_smoke.drive_lint()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
