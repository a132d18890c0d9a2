"""CLI: ``python -m containerpilot_tpu_torch.chaos`` — run chaos
scenarios against the port's replicas.

    # one scenario, seeded, report to stdout, replicas on the card
    python -m containerpilot_tpu_torch.chaos --scenario kill_spare --seed 7

    # the quick suite on the CPU, report to a file
    python -m containerpilot_tpu_torch.chaos --suite quick --device cpu \
        --json report.json

    # everything, including the slow compound-fault marathons
    python -m containerpilot_tpu_torch.chaos --suite full

``--device`` defaults to ``cuda`` and fails loudly when no card is
present; it never falls back to the CPU.

Exit status: 0 when every scenario's invariants passed, 1 otherwise
(the report still prints — a failed run's evidence is the point).
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile
from typing import List, Optional

from .scenarios import (
    SCENARIOS,
    full_scenarios,
    quick_scenarios,
    run_scenario,
)


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m containerpilot_tpu_torch.chaos",
        description="trace-driven load + chaos scenarios, "
        "scored on SLO-goodput",
    )
    parser.add_argument(
        "--scenario", action="append", default=[],
        help="scenario name (repeatable); see --list",
    )
    parser.add_argument(
        "--suite", choices=("quick", "full"), default=None,
        help="run a whole suite instead of named scenarios",
    )
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument(
        "--json", metavar="PATH", default=None,
        help="write the JSON report here ('-' for stdout; default: "
        "pretty-print a summary)",
    )
    parser.add_argument(
        "--list", action="store_true", help="list scenarios and exit"
    )
    parser.add_argument(
        "--device", default="cuda",
        help="where the replicas run (default: cuda; raises without a "
        "card, never falls back to the CPU)",
    )
    args = parser.parse_args(argv)

    if args.list:
        for name, spec in SCENARIOS.items():
            tier = "quick" if spec.quick else "slow "
            print(f"{tier}  {name:<18} {spec.description}")
        return 0

    names = list(args.scenario)
    if args.suite == "quick":
        names += quick_scenarios()
    elif args.suite == "full":
        names += full_scenarios()
    if not names:
        names = quick_scenarios()
    unknown = [n for n in names if n not in SCENARIOS]
    if unknown:
        parser.error(
            f"unknown scenario(s) {unknown}; --list shows the registry"
        )

    from .. import resolve_device

    resolve_device(args.device)  # no card, no run: say so up front
    reports = []
    for name in names:
        with tempfile.TemporaryDirectory(prefix="chaos-catalog-") as d:
            report = run_scenario(
                name, d, seed=args.seed, device=args.device
            )
        reports.append(report)
        verdict = "PASS" if report["passed"] else "FAIL"
        print(
            f"[{verdict}] {name}: goodput "
            f"{report['score']['goodput_fraction']} "
            f"({report['score']['goodput_rps']} rps), "
            f"5xx={report['score']['count_5xx']}, "
            f"requests={report['score']['requests']}, "
            f"loop_lag_max={report['loop_lag_max_ms']}ms",
            file=sys.stderr,
        )
        for check in report["checks"]:
            if not check["ok"]:
                print(
                    f"       FAILED {check['name']}: {check['detail']}",
                    file=sys.stderr,
                )

    passed = all(r["passed"] for r in reports)
    payload = {
        "suite": args.suite or "named",
        "seed": args.seed,
        "passed": passed,
        "scenarios": reports,
    }
    if args.json == "-":
        print(json.dumps(payload, indent=2))
    elif args.json:
        with open(args.json, "w", encoding="utf-8") as f:
            json.dump(payload, f, indent=2)
        print(f"report -> {args.json}", file=sys.stderr)
    else:
        print(json.dumps(payload, indent=2))
    return 0 if passed else 1


if __name__ == "__main__":
    raise SystemExit(main())
