"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a card and the CUDA
toolkit. Phases, each printing one JSON line:

1. device: the card's name, and its name and power limit as nvidia-smi
   reports them;
2. build: compiles every kernel under containerpilot_tpu_torch/csrc/
   (one nvcc per source, all at once) and prints the seconds;
3. kernels: each hand-written kernel against its plain torch version on
   the card, in bf16, at the shapes the serving path gives it, with its
   time, the plain version's, one PyTorch call computing the same
   function (the yardstick; never used by the port) and the least time
   the card could take (bytes at 3.35 TB/s or operations at
   989 TFLOP/s, whichever is larger);
4. serve_bf16: the 1.2B flagship config (vocab 32768, d_model 2048, 16
   heads, 16 layers, d_ff 8192, max_len 2048), seeded random weights,
   served by the port's InferenceServer over HTTP on 127.0.0.1:0: health,
   greedy 1024-token prompts (the flash kernel's path), a repeat, a
   4-row batch, a seeded sampled request, /v1/model; the flash kernel's
   launch count is zeroed just before and read just after; the logits
   through the kernel are held against the plain attention path;
5. serve_int8: the same model after quantize_model_params, the int8
   kernel's count zeroed before and read after; its decode logits are
   held against the same model decoded on the CPU (the plain versions).

Then the kernel summary line, the nvidia-smi line, and last
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero;
without CUDA, or without the package beside this file, it exits
non-zero before printing any result.
"""
from __future__ import annotations

import asyncio
import json
import math
import os
import subprocess
import sys
import time

import torch

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
BF16_FLOP_PER_S = 989e12    # H100 SXM dense bf16 tensor-core peak

FLAGSHIP = dict(vocab_size=32768, d_model=2048, n_heads=16, n_layers=16,
                d_ff=8192, max_seq_len=2048)
MAX_LEN = 2048
PROMPT_LEN = 1024
FLASH_TOL = 2e-2      # abs, bf16 outputs of magnitude <~4 (one bf16 step)
INT8_REL_TOL = 1e-2   # abs err / max|ref|: ~two bf16 rounding steps
E2E_REL_TOL = 5e-2    # logits, kernel path vs plain path, 16 bf16 layers


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, arg_sets, iters: int = 20) -> float:
    """Mean device ms of fn over ``iters`` launches, cycling through
    arg_sets (several copies, so inputs come from device memory rather
    than L2). The launches are captured in one CUDA graph and replayed
    between two CUDA events, so host overhead between launches (Python,
    ctypes, dispatch) is not counted: this is kernel time."""
    for args in arg_sets:  # warm pass (lazy init, workspaces)
        fn(*args)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(*arg_sets[i % len(arg_sets)])
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    graph.replay()  # first replay uploads the graph
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / iters


def copies_for(nbytes: int) -> int:
    return max(1, min(8, math.ceil(200e6 / max(nbytes, 1))))


def bound(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def check_flash(gen, b, s, h, kv, hd, window):
    from containerpilot_tpu_torch.ops import flash

    def make():
        shape_q, shape_kv = (b, s, h, hd), (b, s, kv, hd)
        return tuple(
            torch.randn(shp, generator=gen, device="cuda").to(torch.bfloat16)
            for shp in (shape_q, shape_kv, shape_kv)
        )

    q, k, v = make()
    out, lse = flash.flash_attention_forward_with_lse(q, k, v, window=window)
    torch.cuda.synchronize()
    ref, ref_lse = flash.flash_attention_forward_reference(
        q, k, v, window=window
    )
    err = (out.float() - ref.float()).abs().max().item()
    lse_err = (lse - ref_lse).abs().max().item()
    if not (err <= FLASH_TOL and lse_err <= FLASH_TOL):
        raise AssertionError(
            f"flash kernel disagrees at {(b, s, h, kv, hd, window)}: "
            f"out {err}, lse {lse_err} (tol {FLASH_TOL})"
        )
    sets = [(q, k, v)] + [
        make() for _ in range(copies_for(q.nbytes * 4) - 1)
    ]
    ms = cuda_ms(lambda a, c, d: flash.flash_attention_forward_with_lse(
        a, c, d, window=window), sets)
    plain_ms = cuda_ms(lambda a, c, d: flash.flash_attention_forward_reference(
        a, c, d, window=window), sets[:2], iters=5)
    mask = None
    if window > 0:
        idx = torch.arange(s, device="cuda")
        mask = (idx[:, None] >= idx[None, :]) & (
            idx[:, None] - idx[None, :] < window
        )
    sdpa_sets = [
        tuple(t.transpose(1, 2) for t in st) for st in sets
    ]

    def sdpa(a, c, d):
        return torch.nn.functional.scaled_dot_product_attention(
            a, c, d, attn_mask=mask, is_causal=mask is None,
            enable_gqa=kv != h,
        )

    library_ms = cuda_ms(sdpa, sdpa_sets)
    # exact (q, k) pairs this mask keeps, per head
    pos = torch.arange(s)
    seen = torch.clamp(pos + 1, max=window) if window > 0 else pos + 1
    pairs = int(seen.sum())
    flops = 4.0 * hd * pairs * h * b
    nbytes = 2 * (q.numel() * 2 + k.numel() + v.numel()) + lse.numel() * 4
    bound_ms, bound_by = bound(nbytes, flops)
    return {
        "shape": {"b": b, "s": s, "h": h, "kv": kv, "hd": hd,
                  "window": window},
        "max_abs_err": err, "lse_max_abs_err": lse_err, "tol": FLASH_TOL,
        "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "bound_ms": bound_ms, "bound_by": bound_by,
    }


def check_int8(gen, m, k, n):
    from containerpilot_tpu_torch.ops import quant

    def make():
        w = torch.randn((k, n), generator=gen, device="cuda") * k ** -0.5
        w_q, scales = quant.quantize_int8(w)
        return w_q.contiguous(), scales.contiguous()

    x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
    w_q, scales = make()
    out = quant.int8_matmul_padded(x, w_q, scales)
    torch.cuda.synchronize()
    ref = quant.int8_matmul_kernel_reference(x, w_q, scales)
    err = (out.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    if not err <= INT8_REL_TOL * scale:
        raise AssertionError(
            f"int8 kernel disagrees at m={m} k={k} n={n}: {err} "
            f"(tol {INT8_REL_TOL} x {scale})"
        )
    sets = [(x, w_q, scales)] + [
        (x, *make()) for _ in range(copies_for(k * n) - 1)
    ]
    ms = cuda_ms(quant.int8_matmul_padded, sets, iters=50)
    plain_ms = cuda_ms(quant.int8_matmul_kernel_reference, sets[:2], iters=10)
    dense = [
        (a, (wq.float() * s[None, :]).to(torch.bfloat16))
        for a, wq, s in sets
    ]
    library_ms = cuda_ms(torch.matmul, dense, iters=50)
    nbytes = m * k * 2 + k * n + n * 4 + m * n * 2
    bound_ms, bound_by = bound(nbytes, 2.0 * m * k * n)
    return {
        "shape": {"m": m, "k": k, "n": n},
        "max_abs_err": err, "ref_max_abs": scale,
        "tol": f"{INT8_REL_TOL} x max|ref|",
        "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "bound_ms": bound_ms, "bound_by": bound_by,
    }


# ---------------------------------------------------------------------------
# phases 4-5: the serving path over HTTP
# ---------------------------------------------------------------------------

async def http(port, method, path, body=None):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    payload = json.dumps(body).encode() if body is not None else b""
    writer.write(
        f"{method} {path} HTTP/1.1\r\nHost: 127.0.0.1\r\n"
        f"Connection: close\r\nContent-Length: {len(payload)}\r\n\r\n"
        .encode() + payload
    )
    await writer.drain()
    raw = await reader.read()
    writer.close()
    await writer.wait_closed()
    head, _, data = raw.partition(b"\r\n\r\n")
    status = int(head.split()[1])
    if status != 200:
        raise AssertionError(f"{method} {path} -> {status}: {data[:200]!r}")
    return data


async def generate_tokens(port, body):
    t0 = time.perf_counter()
    data = await http(port, "POST", "/v1/generate", body)
    return json.loads(data)["tokens"], time.perf_counter() - t0


def check_rows(rows, n_rows, max_new, vocab):
    if len(rows) != n_rows or any(len(r) != max_new for r in rows):
        raise AssertionError(f"unexpected output shape: {rows!r:.200}")
    if any(not 0 <= t < vocab for r in rows for t in r):
        raise AssertionError("token id outside the vocabulary")


async def drive_server(cfg, params, prompt, label, device="cuda",
                       max_len=MAX_LEN):
    """Serve over HTTP; returns the phase's measurements. Counters are
    zeroed by the caller just before and read just after."""
    from containerpilot_tpu_torch.workload.serve import InferenceServer

    server = InferenceServer(cfg, params, "127.0.0.1", 0, max_len,
                             max_batch_rows=8, device=device)
    t0 = time.perf_counter()
    await server.run()
    warm_s = time.perf_counter() - t0
    try:
        port = server.port
        assert (await http(port, "GET", "/health")) == b"ok\n"
        out = {"phase": label, "warmup_s": warm_s}
        greedy = {"tokens": [prompt], "max_new_tokens": 32}
        rows, t32 = await generate_tokens(port, greedy)
        check_rows(rows, 1, 32, cfg.vocab_size)
        again, t32b = await generate_tokens(port, greedy)
        if again != rows:
            raise AssertionError("repeated greedy request gave other tokens")
        _, t1 = await generate_tokens(port, {**greedy, "max_new_tokens": 1})
        _, t1b = await generate_tokens(port, {**greedy, "max_new_tokens": 1})
        t32, t1 = min(t32, t32b), min(t1, t1b)
        out.update({
            "request_ms_prompt1024_new1": t1 * 1e3,
            "request_ms_prompt1024_new32": t32 * 1e3,
            "decode_tok_s_batch1": 31 / (t32 - t1),
        })
        batch = [prompt] + [
            [(t * 7 + r) % cfg.vocab_size for t in prompt]
            for r in range(1, 4)
        ]
        rows4, t4 = await generate_tokens(
            port, {"tokens": batch, "max_new_tokens": 16}
        )
        check_rows(rows4, 4, 16, cfg.vocab_size)
        out["request_ms_batch4_prompt1024_new16"] = t4 * 1e3
        sampled = {"tokens": [prompt[:64]], "max_new_tokens": 16,
                   "temperature": 0.8, "top_k": 40, "seed": 7}
        s1, _ = await generate_tokens(port, sampled)
        s2, _ = await generate_tokens(port, sampled)
        check_rows(s1, 1, 16, cfg.vocab_size)
        if s1 != s2:
            raise AssertionError("seeded sampling is not deterministic")
        info = json.loads(await http(port, "GET", "/v1/model"))
        if (info["n_layers"] != cfg.n_layers
                or not info["device"].startswith(device)):
            raise AssertionError(f"/v1/model says {info}")
        out["greedy_tokens_head"] = rows[0][:8]
        return out
    finally:
        await server.stop()


def logits_rel_err(a, b) -> float:
    return ((a.float() - b.float()).abs().max()
            / b.float().abs().max()).item()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs a "
              "card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from containerpilot_tpu_torch.models import decode, quantized
    from containerpilot_tpu_torch.models import transformer as tf
    from containerpilot_tpu_torch.ops import _build, flash, quant

    t_start = time.perf_counter()
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    card = {"kind": kind, "nvidia_smi": smi}
    emit({"phase": "device", **card, "torch": torch.__version__,
          "cuda": torch.version.cuda, "count": torch.cuda.device_count()})

    emit({"phase": "build", "seconds": _build.build_all(),
          "sources": _build.sources()})

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    flash_cases = [
        (1, 1024, 16, 16, 128, 0),    # the serving path's prefill
        (4, 1024, 16, 16, 128, 0),    # the 4-row batch
        (1, 1024, 16, 4, 128, 0),     # GQA
        (1, 1024, 16, 16, 128, 256),  # sliding window
        (1, 1024, 16, 16, 128, 64),   # rows fully masked in a visited tile
    ]
    flash_rows = [check_flash(gen, *c) for c in flash_cases]
    emit({"phase": "kernels", "kernel": "flash_fwd", "results": flash_rows,
          **card})
    proj = {(2048, 2048): 4, (2048, 8192): 2, (8192, 2048): 1}
    int8_rows = [
        check_int8(gen, m, k, n) for m in (1, 8, 16, 256) for (k, n) in proj
    ]
    emit({"phase": "kernels", "kernel": "int8_matmul", "results": int8_rows,
          **card})

    # ---- serve bf16 -----------------------------------------------------
    cfg = tf.TransformerConfig(**FLAGSHIP)
    masters = tf.init_params(0, cfg, device="cuda")
    params = quantized.cast_params(masters, cfg.dtype)
    prompt = torch.randint(
        0, cfg.vocab_size, (PROMPT_LEN,), generator=gen, device="cuda"
    ).tolist()
    flash.LAUNCHES = 0
    serve_bf16 = asyncio.run(drive_server(cfg, params, prompt, "serve_bf16"))
    k1_launches = flash.LAUNCHES
    if k1_launches < cfg.n_layers:
        raise AssertionError(
            f"flash kernel launched {k1_launches} times on the serving path"
        )
    toks = torch.tensor([prompt], device="cuda")
    with torch.inference_mode():
        via_kernel = tf.forward(params, toks, cfg)[0, -64:]
        plain_cfg = tf.TransformerConfig(**FLAGSHIP, flash_min_seq=0)
        via_plain = tf.forward(params, toks, plain_cfg)[0, -64:]
    e2e = logits_rel_err(via_kernel, via_plain)
    if not (torch.isfinite(via_kernel).all() and e2e <= E2E_REL_TOL):
        raise AssertionError(f"flash-path logits off the plain path: {e2e}")
    serve_bf16.update({
        "flash_launches": k1_launches, "logits_rel_err_vs_plain": e2e,
        "resident_param_bytes": quantized.param_bytes(params), **card,
    })
    emit(serve_bf16)
    del params, via_kernel, via_plain

    # ---- serve int8 -----------------------------------------------------
    qparams = quantized.cast_params(
        quantized.quantize_model_params(masters), cfg.dtype
    )
    del masters
    torch.cuda.empty_cache()
    quant.LAUNCHES = 0
    flash.LAUNCHES = 0
    serve_int8 = asyncio.run(drive_server(cfg, qparams, prompt, "serve_int8"))
    k2_launches = quant.LAUNCHES
    if k2_launches < 7 * cfg.n_layers:
        raise AssertionError(
            f"int8 kernel launched {k2_launches} times on the serving path"
        )
    # small input: prefill 16 tokens + 3 decode steps on the card (int8
    # kernel) and on the CPU (its plain version), same weights
    short = torch.tensor([prompt[:16]])
    cpu_params = {k: v for k, v in qparams.items() if k != "layers"}
    cpu_params = {k: v.cpu() for k, v in cpu_params.items()}
    cpu_params["layers"] = {k: v.cpu() for k, v in qparams["layers"].items()}
    worst = 0.0
    with torch.inference_mode():
        runs = []
        for p, dev in ((qparams, "cuda"), (cpu_params, "cpu")):
            logits, cache = decode.prefill(p, short.to(dev), cfg, 32)
            steps = []
            for i in range(3):
                logits, cache = decode.decode_step(
                    p, cache, short[:, i].to(dev), cfg
                )
                steps.append(logits.float().cpu())
            runs.append(steps)
        for gpu_l, cpu_l in zip(*runs):
            if not torch.isfinite(gpu_l).all():
                raise AssertionError("non-finite int8 decode logits")
            worst = max(worst, logits_rel_err(gpu_l, cpu_l))
    if worst > E2E_REL_TOL:
        raise AssertionError(f"int8 decode logits off the CPU path: {worst}")
    serve_int8.update({
        "int8_launches": k2_launches, "flash_launches": flash.LAUNCHES,
        "decode_logits_rel_err_vs_cpu": worst,
        "resident_param_bytes": quantized.param_bytes(qparams), **card,
    })
    emit(serve_int8)

    # ---- summary --------------------------------------------------------
    main_flash = flash_rows[0]
    layer_set = [r for r in int8_rows if r["shape"]["m"] == 1]
    weight = [proj[(r["shape"]["k"], r["shape"]["n"])] for r in layer_set]

    def per_layer(key):
        return sum(w * r[key] for w, r in zip(weight, layer_set))

    kernels = [
        {
            "name": "flash_fwd", "route": "cuda",
            "source": "containerpilot_tpu_torch/csrc/flash_fwd.cu",
            "replaces": "containerpilot_tpu/ops/flash.py:142",
            "launches": k1_launches,
            "max_abs_err": max(r["max_abs_err"] for r in flash_rows),
            "ms": main_flash["ms"], "plain_ms": main_flash["plain_ms"],
            "bound_ms": main_flash["bound_ms"],
            "bound_by": main_flash["bound_by"],
            "library_ms": main_flash["library_ms"],
            "shape": "b=1 s=1024 h=16 kv=16 hd=128, one prefill layer",
        },
        {
            "name": "int8_matmul", "route": "cuda",
            "source": "containerpilot_tpu_torch/csrc/int8_matmul.cu",
            "replaces": "containerpilot_tpu/ops/quant.py:64",
            "launches": k2_launches,
            "max_abs_err": max(r["max_abs_err"] for r in int8_rows),
            "ms": per_layer("ms"), "plain_ms": per_layer("plain_ms"),
            "bound_ms": per_layer("bound_ms"), "bound_by": "bytes",
            "library_ms": per_layer("library_ms"),
            "shape": "m=1, one decode layer's 7 projections "
                     "(4x 2048x2048, 2x 2048x8192, 1x 8192x2048)",
        },
    ]
    emit({"kernels": kernels})
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
