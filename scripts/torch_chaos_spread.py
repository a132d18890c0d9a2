"""Read how ``chip_smoke.py``'s chaos_promoted phase depends on what
shares the host: the port's chaos CLI running ``kill_under_burst_promoted``
with its replicas on the card, first alone (nothing else running), then
beside chip_smoke's phase 19 (``serve_fleet_handoff``: three serve CLIs
and the port's gateway), each ``--repeat`` times.

    python3 scripts/torch_chaos_spread.py               # 2 alone, 2 beside
    python3 scripts/torch_chaos_spread.py --repeat 3 --out spread.json

Every run goes through chip_smoke's own drive functions, so each holds the
phase's checks (every check of the scenario's report, the slow boot
armed once, a promotion, no client-visible 5xx; phase 19's gateway
checks); a run that fails is recorded with its error and the script
goes on. Prints the card's name and power limit, one JSON line a run
(its goodput fraction, goodput over admitted requests, TTFT p50/p99,
promotions, loop lag and seconds) and the spread of each figure by
placement; writes the lot to ``--out`` when given. Exits non-zero when
any run failed.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

FIGURES = ("goodput_fraction", "admitted_goodput_fraction", "ttft_p50_ms",
           "ttft_p99_ms", "promotions", "loop_lag_max_ms", "seconds")


def _figures(chaos):
    return {
        "goodput_fraction": chaos["goodput_fraction"],
        "admitted_goodput_fraction": chaos["admitted_goodput_fraction"],
        "ttft_p50_ms": chaos["ttft_ms"]["p50"],
        "ttft_p99_ms": chaos["ttft_ms"]["p99"],
        "promotions": chaos["promotions"],
        "loop_lag_max_ms": chaos["loop_lag_max_ms"],
        "seconds": chaos["seconds"],
    }


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--repeat", type=int, default=2)
    parser.add_argument("--out", help="write every run's figures here")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from containerpilot_tpu_torch.ops import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    card = {"kind": torch.cuda.get_device_name(0), "nvidia_smi": smi}
    print(smi, flush=True)
    print(json.dumps({"build_s": _build.build_all()}), flush=True)

    runs = []

    def record(placement, i, fn):
        t0 = time.perf_counter()
        try:
            row = {"placement": placement, "run": i, "ok": True, **fn()}
        except Exception as exc:  # noqa: BLE001 - recorded, then reported
            row = {"placement": placement, "run": i, "ok": False,
                   "error": repr(exc)[:2000],
                   "seconds": time.perf_counter() - t0}
        runs.append(row)
        print(json.dumps(row, default=str), flush=True)

    def alone():
        with tempfile.TemporaryDirectory() as tmp:
            return _figures(cs.drive_chaos_promoted(tmp, card))

    def beside_phase19():
        with tempfile.TemporaryDirectory() as tmp, \
                tempfile.TemporaryDirectory() as ctmp, \
                ThreadPoolExecutor(1) as pool:
            chaos = pool.submit(cs.drive_chaos_promoted, ctmp, card)
            t0 = time.perf_counter()
            handoff = cs.drive_fleet_handoff(tmp, card)
            phase_s = time.perf_counter() - t0
            row = _figures(chaos.result())
        row["phase19_seconds"] = phase_s
        row["phase19_drain"] = handoff["gateway"]["drain"]
        return row

    for i in range(args.repeat):
        record("alone", i, alone)
    for i in range(args.repeat):
        record("beside_phase19", i, beside_phase19)

    spread = {}
    for placement in ("alone", "beside_phase19"):
        ok = [r for r in runs if r["placement"] == placement and r["ok"]]
        spread[placement] = {
            "passed": f"{len(ok)}/{args.repeat}",
            **{k: [min(r[k] for r in ok), max(r[k] for r in ok)]
               for k in FIGURES if ok},
        }
    if args.out:
        with open(args.out, "w") as fh:
            json.dump({"card": card, "runs": runs, "spread": spread}, fh,
                      indent=1, default=str)
    print(json.dumps(spread), flush=True)
    return 0 if all(r["ok"] for r in runs) else 1


if __name__ == "__main__":
    sys.exit(main())
