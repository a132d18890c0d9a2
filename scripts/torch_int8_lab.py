"""Experiments on the int8 dequant GEMM K2 on one GPU: variants of its
source against each other, and the timeline of one launch.

    python3 scripts/torch_int8_lab.py variants [FILE]
    python3 scripts/torch_int8_lab.py timeline

``variants`` reads a JSON object (from FILE, default ``VARIANTS`` below)
that names variants of ``csrc/int8_matmul.cu``: each is a list of
``[old, new]`` text substitutions on the source (an empty list is the
source as it is), or ``{"subs": [...], "plan": [min_k, resident]}`` to
also change the split rule (at least ``min_k`` stages a split, and
rows / 4 of them, splitting while the grid stays within ``resident``
blocks). Every variant is built into ``build/lab/`` (one nvcc each, all
at once), checked against the plain version (1% of max|ref|, repeat
bit-equal) and graph-timed as ``chip_smoke.cuda_ms`` times K2, summed
over a flagship decode layer's 7 projections at m = 1, 8, 16, 64, 256,
in the order A B ... B A. One JSON line per variant.

``timeline`` builds the source with ``%globaltimer`` stamps per block
and prints, for single launches at the main path's shapes (after an L2
flush): block start, first full stage, main loop, per-stage time, the
split-k epilogue and the last thread's sum, in microseconds (min,
median, max over blocks); then the host microseconds of a wrapper call
and of its parts, and of the two tensor-map encodes. Needs a card.
"""
from __future__ import annotations

import ctypes
import json
import os
import statistics
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAYER_M = (1, 8, 16, 64, 256)
# design choices of the kernel, each undone on the source as it stands
VARIANTS = {
    "as_built": [],
    "ring_8": [["static constexpr int STAGES = 4;",
                "static constexpr int STAGES = 8;"]],
    "no_pdl": [["programmaticStreamSerializationAllowed = 1;",
                "programmaticStreamSerializationAllowed = 0;"]],
    "cvt_pack": [["  return __byte_perm(lo, hi, 0x7632);",
                  "  return sm90::pack_bf16(__uint_as_float(lo), "
                  "__uint_as_float(hi));"]],
    "trigger_at_start": [
        ['    asm volatile("griddepcontrol.launch_dependents;" ::: "memory");\n',
         ""],
        ["  __syncthreads();\n",
         '  __syncthreads();\n'
         '  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");\n']],
    "splits_2_stages": {"subs": [], "plan": [2, 264]},
}


def _write_source(name: str, src: str) -> str:
    os.makedirs(os.path.join(ROOT, "build", "lab"), exist_ok=True)
    cu = os.path.join(ROOT, "build", "lab", f"{name}.cu")
    with open(cu, "w") as fh:
        fh.write(src)
    return cu


def _nvcc(build, cu: str):
    return subprocess.Popen(
        [build._nvcc(), *build.NVCC_FLAGS, "-I", build.CSRC, "-o",
         cu[:-3] + ".so", cu])


def _substitute(src: str, subs) -> str:
    for old, new in subs:
        if old not in src:
            raise SystemExit(f"substitution not found: {old!r}")
        src = src.replace(old, new)
    return src


def _launcher(quant, fn, plan_rule):
    """K2 through the C entry ``fn`` with ``plan_rule`` (or _plan)."""
    def plan_of(m, k, n):
        if plan_rule is None:
            return quant._plan(m, k, n)
        min_k, resident = plan_rule
        p = quant._plan(m, k, n)
        tiles = p.row_tiles * (n // quant.KERNEL_TILE_N)
        k_tiles = k // quant.KERNEL_TILE_K
        need = max(min_k, p.rows // 4)
        s = 1
        while (k_tiles % (2 * s) == 0 and k_tiles // (2 * s) >= need
               and tiles * 2 * s <= resident):
            s *= 2
        return quant.Plan(p.rows, p.row_tiles, s, (p.row_tiles, s, p.grid[2]))

    def run(x, w_q, scales):
        m, k = x.shape
        n = w_q.shape[1]
        plan = plan_of(m, k, n)
        out = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
        ws = counters = None
        if plan.splits > 1:
            ws, counters = (t.data_ptr() for t in quant._workspace(x.device, plan))
        err = fn(x.data_ptr(), w_q.data_ptr(), scales.data_ptr(),
                 out.data_ptr(), ws, counters, m, k, n, plan.rows,
                 plan.row_tiles, plan.splits,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: {err}")
        return out
    return run


def variants(path) -> int:
    import chip_smoke
    from containerpilot_tpu_torch.ops import _build as build
    from containerpilot_tpu_torch.ops import quant

    spec = VARIANTS
    if path:
        with open(path) as fh:
            spec = json.load(fh)
    base = open(os.path.join(build.CSRC, "int8_matmul.cu")).read()
    runs, procs = {}, []
    for name, v in spec.items():
        subs, rule = (v, None) if isinstance(v, list) else (v["subs"], v.get("plan"))
        cu = _write_source(name, _substitute(base, subs))
        procs.append((name, cu, rule, _nvcc(build, cu)))
    for name, cu, rule, proc in procs:
        if proc.wait() != 0:
            raise SystemExit(f"nvcc failed for variant {name}")
        fn = quant._entry(ctypes.CDLL(cu[:-3] + ".so"))
        runs[name] = _launcher(quant, fn, rule)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    weights = {
        (k, n): [quant.quantize_int8(
            torch.randn((k, n), generator=gen, device="cuda") * k ** -0.5)
            for _ in range(chip_smoke.copies_for(k * n))]
        for (k, n) in chip_smoke.INT8_PROJ
    }
    xs = {(m, k): torch.randn((m, k), generator=gen, device="cuda").to(
        torch.bfloat16) for m in LAYER_M for k in (2048, 8192)}
    names = list(spec)
    times = {name: {m: [] for m in LAYER_M} for name in names}
    for name in names + names[::-1]:
        run = runs[name]
        for m in LAYER_M:
            total = 0.0
            for (k, n), count in chip_smoke.INT8_PROJ.items():
                sets = [(xs[(m, k)], w, s) for w, s in weights[(k, n)]]
                ref = quant.int8_matmul_kernel_reference(*sets[0]).float()
                got = run(*sets[0])
                err = (got.float() - ref).abs().max() / ref.abs().max()
                if not (err <= chip_smoke.INT8_REL_TOL
                        and torch.equal(got, run(*sets[0]))):
                    raise SystemExit(f"{name} wrong at {(m, k, n)}: {err}")
                total += count * chip_smoke.cuda_ms(run, sets, iters=50)
            times[name][m].append(total)
    for name in names:
        print(json.dumps({"variant": name, "layer_ms_a_b": {
            m: v for m, v in times[name].items()}}), flush=True)
    return 0


STAMPS = [
    ('#include "sm90.cuh"\n',
     '#include "sm90.cuh"\n#include <chrono>\n'
     '__device__ unsigned long long g_stamp[65536][5];\n'
     '__device__ __forceinline__ unsigned long long gtime() {\n'
     '  unsigned long long t;\n'
     '  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));\n'
     '  return t;\n}\n'
     '#define BID (blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z))\n'),
    ("  __syncthreads();\n",
     "  __syncthreads();\n"
     "  if (threadIdx.x == 0) { g_stamp[BID][0] = gtime(); g_stamp[BID][4] = 0; }\n"),
    ("      sm90::mbar_wait(&full[s], (j / STAGES) & 1);\n      __syncwarp();",
     "      sm90::mbar_wait(&full[s], (j / STAGES) & 1);\n      __syncwarp();\n"
     "      if (j == 0 && t == 0) g_stamp[BID][1] = gtime();"),
    ("    if (splits > 1) {\n      // Each thread",
     "    if (t == 0) g_stamp[BID][2] = gtime();\n"
     "    if (splits > 1) {\n      // Each thread"),
    ("      if (arrived != splits - 1) return;",
     "      if (t == 0) g_stamp[BID][3] = gtime();\n"
     "      if (arrived != splits - 1) return;"),
    ("        *reinterpret_cast<uint2*>(out + (size_t)row * n + n0 + 4 * g) = v;\n"
     "      }\n    }\n",
     "        *reinterpret_cast<uint2*>(out + (size_t)row * n + n0 + 4 * g) = v;\n"
     "      }\n    }\n    if (t == 0) g_stamp[BID][4] = gtime();\n"),
    ('const char* int8_matmul_error_string(int err) {',
     'int stamps_read(void* dst, int n) {\n'
     '  return (int)cudaMemcpyFromSymbol(dst, g_stamp, (size_t)n * 40);\n}\n'
     'double encode_us(const void* w, const void* x) {\n'
     '  CUtensorMap map;\n'
     '  auto t0 = std::chrono::steady_clock::now();\n'
     '  for (int i = 0; i < 1000; ++i) {\n'
     '    sm90::make_int8_map(&map, w, 2048, 2048, 64);\n'
     '    sm90::make_bf16_map(&map, x, 1, 2048, 8);\n  }\n'
     '  return std::chrono::duration<double, std::micro>(\n'
     '      std::chrono::steady_clock::now() - t0).count() / 1000;\n}\n'
     'const char* int8_matmul_error_string(int err) {'),
]


def _spread(vals):
    vals = sorted(vals)
    return [round(vals[0], 3), round(statistics.median(vals), 3),
            round(vals[-1], 3)]


def _host_us(fn, calls: int = 500) -> float:
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return elapsed / calls * 1e6


def timeline() -> int:
    from containerpilot_tpu_torch.ops import _build as build
    from containerpilot_tpu_torch.ops import quant

    src = _substitute(open(os.path.join(build.CSRC, "int8_matmul.cu")).read(),
                      STAMPS)
    cu = _write_source("timeline", src)
    if _nvcc(build, cu).wait() != 0:
        raise SystemExit("nvcc failed for the timeline build")
    lib = ctypes.CDLL(cu[:-3] + ".so")
    lib.stamps_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.encode_us.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.encode_us.restype = ctypes.c_double
    run = _launcher(quant, quant._entry(lib), None)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    for m, k, n in [(1, 2048, 2048), (1, 2048, 8192), (1, 8192, 2048),
                    (16, 2048, 8192), (64, 2048, 8192), (256, 2048, 2048),
                    (256, 8192, 2048)]:
        x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
        w_q, scales = quant.quantize_int8(
            torch.randn((k, n), generator=gen, device="cuda"))
        for _ in range(3):
            run(x, w_q, scales)
        flush.zero_()
        torch.cuda.synchronize()
        run(x, w_q, scales)
        torch.cuda.synchronize()
        plan = quant._plan(m, k, n)
        blocks = plan.grid[0] * plan.grid[1] * plan.grid[2]
        buf = (ctypes.c_ulonglong * (blocks * 5))()
        if lib.stamps_read(buf, blocks) != 0:
            raise SystemExit("reading the stamps failed")
        rows = [buf[5 * b:5 * b + 5] for b in range(blocks)]
        t0 = min(r[0] for r in rows)
        us = [[(v - t0) / 1e3 for v in r] for r in rows]
        stages = k // quant.KERNEL_TILE_K // plan.splits
        split = plan.splits > 1
        summed = [r for r, raw in zip(us, rows) if raw[4]]
        print(json.dumps({
            "shape": [m, k, n], "plan": list(plan[:3]), "blocks": blocks,
            "block_start": _spread([r[0] for r in us]),
            "first_stage_after_start": _spread([r[1] - r[0] for r in us]),
            "main_loop": _spread([r[2] - r[1] for r in us]),
            "per_stage": _spread([(r[2] - r[1]) / max(1, stages - 1)
                                  for r in us]),
            "partials_to_counter": _spread([r[3] - r[2] for r in us])
            if split else None,
            "last_thread_sum": _spread([r[4] - r[3] for r in summed])
            if split else None,
            "end": round(max(r[4] for r in summed), 3),
        }), flush=True)
    x = torch.randn((1, 2048), device="cuda").to(torch.bfloat16)
    w_q, scales = quant.quantize_int8(torch.randn((2048, 2048), device="cuda"))
    dense = (w_q.float() * scales).to(torch.bfloat16)
    print(json.dumps({
        "encode_us_two_maps": lib.encode_us(w_q.data_ptr(), x.data_ptr()),
        "host_us_wrapper": _host_us(
            lambda: quant.int8_matmul_padded(x, w_q, scales)),
        "host_us_checks_and_plan": _host_us(
            lambda: quant._kernel_plan(x, w_q, scales)),
        "host_us_torch_empty": _host_us(lambda: torch.empty(
            (1, 2048), dtype=torch.bfloat16, device="cuda")),
        "host_us_torch_matmul": _host_us(lambda: torch.matmul(x, dense)),
    }), flush=True)
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    if len(sys.argv) >= 2 and sys.argv[1] == "variants":
        return variants(sys.argv[2] if len(sys.argv) > 2 else None)
    if len(sys.argv) == 2 and sys.argv[1] == "timeline":
        return timeline()
    print(__doc__, file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main())
