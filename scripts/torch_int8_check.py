"""Build the int8 dequant GEMM K2 and hold it against its plain version
on one GPU.

    python3 scripts/torch_int8_check.py [--ptxas] [--small] [--all] [--other DIR]

Prints the card's name and power limit, then with ``--ptxas`` what
``nvcc -Xptxas -v`` reports for ``csrc/int8_matmul.cu`` (registers,
shared memory and spills of each instantiation), then one JSON line per
shape from ``chip_smoke.check_int8``: max error against
``int8_matmul_kernel_reference`` (held at ``INT8_REL_TOL`` x max|ref|),
a repeat launch's bit equality, the launch plan, kernel ms, GB/s, share
of the bound, the plain version's ms and ``torch.matmul`` on bf16
weights, plus the host microseconds a wrapper call costs (enqueue only,
no synchronise). Then one line per row count of a decode layer's 7
projections summed. ``--small`` checks a few small shapes first; by
default the decode layer's projections at m = 1, 8, 16 and 256 are
checked, ``--all`` adds every m of ``chip_smoke.INT8_M_CASES``.

``--other DIR`` instead times K2 of another checkout (for example the
parent commit unpacked with ``git archive`` into a git-ignored
directory) and of this one, each tree's own ``chip_smoke.check_int8`` in
a process of its own, in the order other, this, this, other, and prints
one JSON line per tree and row count: the decode layer's K2 ms and
``torch.matmul``'s. Exits non-zero if any shape fails. Needs a card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

import torch

# (m, k, n): tiny tiles, one split, ragged m, several row tiles
SMALL_CASES = [
    (1, 64, 128),
    (3, 128, 256),
    (8, 512, 128),
    (20, 256, 384),
    (130, 512, 256),
]
AB_M = (1, 8, 16, 256)
RUN = """
import json, sys, torch
sys.path.insert(0, ".")
import chip_smoke
proj = {{(2048, 2048): 4, (2048, 8192): 2, (8192, 2048): 1}}
gen = torch.Generator(device="cuda")
gen.manual_seed(0)
for m in {ms!r}:
    rows = [(w, chip_smoke.check_int8(gen, m, k, n)) for (k, n), w in proj.items()]
    print(json.dumps({{"tree": {tree!r}, "m": m,
                      "layer_ms": sum(w * r["ms"] for w, r in rows),
                      "layer_library_ms": sum(w * r["library_ms"] for w, r in rows),
                      "max_abs_err": max(r["max_abs_err"] for _, r in rows)}}),
          flush=True)
"""


def ptxas_report(build) -> None:
    with tempfile.TemporaryDirectory() as tmp:
        src, _ = build._target("int8_matmul")
        proc = subprocess.run(
            [build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
             os.path.join(tmp, "int8_matmul.so"), src],
            capture_output=True, text=True,
        )
        lines = [ln.strip() for ln in (proc.stdout + proc.stderr).splitlines()
                 if ln.strip()]
        print(json.dumps({"ptxas": "int8_matmul", "rc": proc.returncode,
                          "lines": lines}), flush=True)
        if proc.returncode != 0:
            raise RuntimeError("nvcc failed for int8_matmul")


def host_us(gen, m, k, n, calls: int = 200) -> float:
    """Host microseconds of one wrapper call (checks, workspace lookup,
    tensor maps, launch), enqueued back to back without a synchronise."""
    from containerpilot_tpu_torch.ops import quant

    x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
    w_q, scales = quant.quantize_int8(
        torch.randn((k, n), generator=gen, device="cuda"))
    for _ in range(10):
        quant.int8_matmul_padded(x, w_q, scales)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        quant.int8_matmul_padded(x, w_q, scales)
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return elapsed / calls * 1e6


def run_other(other: str, here: str) -> int:
    trees = {"other": os.path.abspath(other), "this": here}
    for tree in ("other", "this", "this", "other"):
        proc = subprocess.run(
            [sys.executable, "-c", RUN.format(ms=AB_M, tree=tree)],
            cwd=trees[tree], timeout=600,
        )
        if proc.returncode != 0:
            print(json.dumps({"tree": tree, "failed": proc.returncode}))
            return 1
    return 0


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--ptxas", action="store_true")
    parser.add_argument("--small", action="store_true")
    parser.add_argument("--all", action="store_true")
    parser.add_argument("--other", help="root of another checkout to time")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    from chip_smoke import (
        INT8_LAYER_M,
        INT8_M_CASES,
        INT8_PROJ,
        check_int8,
        int8_per_layer,
    )
    from containerpilot_tpu_torch.ops import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    if args.other:
        return run_other(args.other, root)
    if args.ptxas:
        ptxas_report(_build)
    cases = list(SMALL_CASES) if args.small else []
    cases += [(m, k, n) for m in (INT8_M_CASES if args.all else INT8_LAYER_M)
              for (k, n) in INT8_PROJ]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    failed = 0
    rows = []
    for case in cases:
        try:
            row = check_int8(gen, *case)
            row["host_us"] = host_us(gen, *case)
        except Exception:  # report every shape, then fail
            failed += 1
            print(json.dumps({"case": case, "error": traceback.format_exc()}),
                  flush=True)
            torch.cuda.synchronize()
            continue
        rows.append(row)
        print(json.dumps(row), flush=True)
    for m in INT8_LAYER_M:
        if sum(r["shape"]["m"] == m and (r["shape"]["k"], r["shape"]["n"])
               in INT8_PROJ for r in rows) == len(INT8_PROJ):
            print(json.dumps({"decode_layer_m": m,
                              **int8_per_layer(rows, m)}), flush=True)
    print(json.dumps({"failed": failed, "cases": len(cases), "card": smi}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
