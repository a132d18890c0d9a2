"""CLI: ``python -m containerpilot_tpu_torch.analysis`` — the port's
lint gate (``make lint-torch``), the counterpart of ``python -m
containerpilot_tpu.analysis``: it byte-compiles and scans the port's
package root against ``containerpilot_tpu_torch/analysis/baseline.json``.

Exit status:
    0  byte-compile clean AND no findings beyond the baseline
    1  new findings (or --write-baseline wrote nothing because the
       scan itself failed)
    2  a module failed to byte-compile / parse

Modes:
    (default)          scan the whole package against the baseline
    --files F [F ...]  report findings for those files only, still
                       filtered through the baseline. The call graph
                       is always built over the FULL package (plus
                       any listed out-of-package files), so the
                       interprocedural rules see every edge — only
                       the findings are filtered to the diff
    --write-baseline   regenerate analysis/baseline.json from a fresh
                       full scan (the `make lint-torch-baseline` body),
                       reporting which entries were added or removed
    --list-rules       print the rule catalog (id + first doc line)
"""
from __future__ import annotations

import argparse
import compileall
import os
import sys
from typing import List, Optional

from .callgraph import PROJECT_RULES, build_project_from_paths
from .cpcheck import (
    ALL_RULES,
    Finding,
    baseline_path,
    diff_against_baseline,
    explain_stale,
    iter_package_files,
    load_baseline,
    scan_package,
    scan_project,
    write_baseline,
)


def _package_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m containerpilot_tpu_torch.analysis",
        description="cpcheck: repo-specific AST invariant analysis",
    )
    parser.add_argument(
        "--files", nargs="+", metavar="FILE",
        help="report findings for these files only (the call graph "
             "still spans the whole package)",
    )
    parser.add_argument(
        "--baseline", default=None,
        help=f"baseline path (default: {baseline_path()})",
    )
    parser.add_argument(
        "--write-baseline", action="store_true",
        help="regenerate the baseline from a fresh full scan and exit",
    )
    parser.add_argument(
        "--no-compileall", action="store_true",
        help="skip the byte-compile pass (cpcheck rules only)",
    )
    parser.add_argument(
        "--list-rules", action="store_true",
        help="print the rule catalog and exit",
    )
    args = parser.parse_args(argv)

    if args.write_baseline and args.files:
        # a partial scan must never replace the full ledger (it would
        # silently delete every other file's justified entries)
        parser.error("--write-baseline requires a full package scan; "
                     "drop --files")

    if args.list_rules:
        for rule in list(ALL_RULES) + list(PROJECT_RULES):
            doc = (rule.__doc__ or "").strip().splitlines()
            first = doc[0] if doc else ""
            print(f"{rule.rule_id}: {first}")
        return 0

    root = _package_root()
    repo = os.path.dirname(root)

    if not args.no_compileall and not args.files:
        # parse errors beat style errors
        if not compileall.compile_dir(root, quiet=1):
            print("cpcheck: byte-compilation failed", file=sys.stderr)
            return 2

    try:
        if args.files:
            # full-package forest + the listed files: the diff mode
            # must see every call edge (a changed helper can create a
            # reachability finding whose witness spans unchanged
            # files), then report only on the files asked about
            listed = [
                os.path.normpath(os.path.abspath(p))
                for p in args.files
            ]
            paths = list(dict.fromkeys(
                [
                    os.path.normpath(p)
                    for p in iter_package_files(root)
                ] + listed
            ))
            project = build_project_from_paths(paths, repo)
            rel_listed = {
                os.path.relpath(p, repo).replace(os.sep, "/")
                for p in listed
            }
            findings: List[Finding] = [
                f for f in scan_project(project)
                if f.file in rel_listed
            ]
        else:
            findings = scan_package(root, relative_to=repo)
    except SyntaxError as exc:
        print(f"cpcheck: parse failure: {exc}", file=sys.stderr)
        return 2

    entries = load_baseline(args.baseline)
    new, stale = diff_against_baseline(findings, entries)

    if args.write_baseline:
        path = write_baseline(findings, args.baseline)
        print(
            f"cpcheck: wrote {len(findings)} baseline entr"
            f"{'y' if len(findings) == 1 else 'ies'} to {path}"
        )
        if new:
            print(f"cpcheck: {len(new)} entr"
                  f"{'y' if len(new) == 1 else 'ies'} added:")
            for f in new:
                print(f"    {f.file} [{f.scope}] {f.rule}")
        if stale:
            print(f"cpcheck: {len(stale)} stale entr"
                  f"{'y' if len(stale) == 1 else 'ies'} removed:")
            for line in explain_stale(new, stale):
                print(f"    {line}")
        return 0

    scanned = (
        f"{len(args.files)} file(s)" if args.files else "package"
    )
    if new:
        print(
            f"cpcheck: {len(new)} new finding(s) over {scanned} "
            f"(baseline: {len(entries)} known):"
        )
        for f in new:
            print(f.render())
        if stale and not args.files:
            # a 'new' finding paired with a stale entry usually means
            # an edit moved a baselined line, not fresh debt — say so
            print(f"\ncpcheck: {len(stale)} stale baseline entr"
                  f"{'y' if len(stale) == 1 else 'ies'}:")
            for line in explain_stale(new, stale):
                print(f"    {line}")
        print(
            "\ncpcheck: fix the finding, add an inline "
            "`# cpcheck: disable=<RULE>` with a justification, or — "
            "for genuinely pre-existing debt — "
            "`make lint-torch-baseline`.",
        )
        return 1
    if stale and not args.files:
        # full scans know an entry is truly gone; partial scans don't
        print(
            f"cpcheck: warning: {len(stale)} stale baseline entr"
            f"{'y' if len(stale) == 1 else 'ies'}:"
        )
        for line in explain_stale(new, stale):
            print(f"    {line}")
    print(
        f"cpcheck: clean ({scanned}; {len(findings)} finding(s), "
        f"all baselined)"
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
