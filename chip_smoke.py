"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a card and the CUDA
toolkit. Phases, each printing one JSON line (the serving phases, then
the training phases):

1. device: the card's name, and its name and power limit as nvidia-smi
   reports them;
2. build: compiles every kernel under containerpilot_tpu_torch/csrc/
   (one nvcc per source, all at once) and prints the seconds;
3. kernels: each hand-written kernel against its plain torch version on
   the card, in bf16, at the shapes the serving and training paths give
   it, with its time, the plain version's, one PyTorch call computing
   the same function (the yardstick; never used by the port) and the
   least time the card could take (bytes at 3.35 TB/s or operations at
   989 TFLOP/s, whichever is larger). K3 (flash dq) and K4 (flash dk/dv)
   share one yardstick: SDPA forward+backward minus SDPA forward;
4. serve_bf16: the 1.2B flagship config (vocab 32768, d_model 2048, 16
   heads, 16 layers, d_ff 8192, max_len 2048), seeded random weights,
   served by the port's InferenceServer over HTTP on 127.0.0.1:0: health,
   greedy 1024-token prompts (the flash kernel's path), a repeat, a
   4-row batch, a seeded sampled request, /v1/model; the flash kernel's
   launch count is zeroed just before and read just after; the logits
   through the kernel are held against the plain attention path;
5. serve_int8: the same model after quantize_model_params, the int8
   kernel's count zeroed before and read after; its decode logits are
   held against the same model decoded on the CPU (the plain versions);
6. train: the repo's training configuration (bench.py:121-133: vocab
   32768, d_model 1024, 8 heads, 8 layers, d_ff 4096, seq 2048, batch 8,
   flash crossover AUTO, remat "full"), seeded random masters, through
   make_train_step: 2 warm steps, then 5 timed steps on one seeded batch
   (step ms, tokens/s, MFU against 989 TFLOP/s); the K1/K3/K4 launch
   counts are zeroed just before and read just after, and the loss must
   fall; one loss_fn value+grad through the kernels is held against
   plain attention (flash_min_seq=0) at batch 2, and against itself
   under remat "dots" and with the chunked loss; _dot_f32's gradient
   against the float32 product's;
7. train_cli: ``python -m containerpilot_tpu_torch.workload.train
   --device cuda`` at d_model 1024, 2 layers, seq 1024, SIGTERM after
   step 3 (exit 0, "checkpoint saved at step N"), then a restart that
   resumes at step N and finishes; and token-shard batches staged on
   the card by the data prefetcher equal the dataset's.

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
import re
import signal
import subprocess
import sys
import tempfile
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
# K3/K4 vs their plain version, abs err / max|ref|: both accumulate in
# float32 and round once to bf16, so at most a rounding step (2^-8
# relative) at the largest gradient
FLASH_BWD_REL_TOL = 1e-2
# training through the kernels vs plain attention (the bounds of
# test_training_through_auto_flash_matches_causal)
TRAIN_LOSS_REL_TOL = 1e-2
TRAIN_GRAD_REL_TOL = 5e-2
DOT_GRAD_REL_TOL = 1e-2  # _dot_f32's bf16 backward vs the float32 product
# remat "dots" vs "full", loss and worst grad leaf: the same arithmetic,
# only the saved tensors differ
REMAT_REL_TOL = 1e-3
# the chunked loss vs the whole-logits loss: the bf16 unembed's gradient
# is summed over the chunks in bf16 (as the reference's scan sums it), a
# rounding step (2^-8) per chunk, where the whole loss has one GEMM
CHUNKED_REL_TOL = 2e-2

TRAIN_CFG = dict(vocab_size=32_768, d_model=1024, n_heads=8, n_layers=8,
                 d_ff=4096, max_seq_len=2048, flash_min_seq=-1, remat="full")
TRAIN_BATCH, TRAIN_SEQ = 8, 2048


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


def kept_pairs(s: int, window: int) -> int:
    """(q, k) pairs the causal (and window) mask keeps, per head."""
    pos = torch.arange(s)
    seen = torch.clamp(pos + 1, max=window) if window > 0 else pos + 1
    return int(seen.sum())


def check_flash_bwd(gen, b, s, h, hd, window):
    """K3 and K4 against flash_attention_backward_reference (split into
    the plain versions of each kernel) on K1's residuals, bf16."""
    from containerpilot_tpu_torch.ops import flash

    def make():
        q, k, v, do = (
            torch.randn((b, s, h, hd), generator=gen, device="cuda")
            .to(torch.bfloat16) for _ in range(4)
        )
        with torch.no_grad():
            out, lse = flash.flash_attention_forward_with_lse(
                q, k, v, window=window)
        return q, k, v, do, lse, flash.attention_delta(out, do), out

    q, k, v, do, lse, delta, out = make()
    with torch.no_grad():
        dq = flash.flash_backward_dq(q, k, v, do, lse, delta, window)
        dk, dv = flash.flash_backward_dkdv(q, k, v, do, lse, delta, window)
        torch.cuda.synchronize()
        ref = flash.flash_attention_backward_reference(
            q, k, v, out, lse, do, window)
    errs = {}
    for name, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv), ref):
        err = (got.float() - want.float()).abs().max().item()
        scale = want.float().abs().max().item()
        if not (torch.isfinite(got).all() and scale > 0
                and err <= FLASH_BWD_REL_TOL * scale):
            raise AssertionError(
                f"flash backward {name} disagrees at {(b, s, h, hd, window)}:"
                f" {err} (tol {FLASH_BWD_REL_TOL} x {scale})"
            )
        errs[name] = err
    sets = [(q, k, v, do, lse, delta)] + [
        make()[:6] for _ in range(copies_for(q.nbytes * 6) - 1)
    ]
    with torch.no_grad():
        dq_ms = cuda_ms(lambda *a: flash.flash_backward_dq(*a, window), sets)
        dkdv_ms = cuda_ms(
            lambda *a: flash.flash_backward_dkdv(*a, window), sets)
        dq_plain = cuda_ms(lambda *a: flash.flash_backward_dq_reference(
            *a, window), sets[:1], iters=3)
        dkdv_plain = cuda_ms(lambda *a: flash.flash_backward_dkdv_reference(
            *a, window), sets[:1], iters=3)

    # yardstick for K3+K4 together: SDPA forward+backward minus forward
    mask = None
    if window > 0:
        idx = torch.arange(s, device="cuda")
        mask = (idx[:, None] >= idx[None, :]) & (
            idx[:, None] - idx[None, :] < window)
    sdpa_sets = [
        tuple(t.transpose(1, 2).detach().requires_grad_(True)
              for t in st[:3]) + (st[3].transpose(1, 2),)
        for st in sets
    ]

    def sdpa(a, c, d):
        return torch.nn.functional.scaled_dot_product_attention(
            a, c, d, attn_mask=mask, is_causal=mask is None)

    def sdpa_fwd_bwd(a, c, d, g):
        torch.autograd.grad(sdpa(a, c, d), (a, c, d), g)

    with torch.no_grad():
        sdpa_fwd = cuda_ms(lambda a, c, d, g: sdpa(a, c, d), sdpa_sets)
    library_ms = cuda_ms(sdpa_fwd_bwd, sdpa_sets) - sdpa_fwd

    pairs = kept_pairs(s, window) * b * h
    n = q.numel()
    rows_bytes = 2 * lse.numel() * 4
    dq_bound, dq_by = bound(5 * n * 2 + rows_bytes, 6.0 * hd * pairs)
    dkdv_bound, dkdv_by = bound(6 * n * 2 + rows_bytes, 8.0 * hd * pairs)
    return {
        "shape": {"b": b, "s": s, "h": h, "hd": hd, "window": window},
        "max_abs_err": errs, "tol": f"{FLASH_BWD_REL_TOL} x max|ref|",
        "dq": {"ms": dq_ms, "plain_ms": dq_plain, "bound_ms": dq_bound,
               "bound_by": dq_by},
        "dkdv": {"ms": dkdv_ms, "plain_ms": dkdv_plain,
                 "bound_ms": dkdv_bound, "bound_by": dkdv_by},
        "library_ms_k3_plus_k4": library_ms, "sdpa_fwd_ms": sdpa_fwd,
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


# ---------------------------------------------------------------------------
# phases 6-7: training
# ---------------------------------------------------------------------------

def rel_norm_err(a, b) -> float:
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def drive_training(gen):
    """The training path at full width: make_train_step on the repo's
    training configuration, the kernels' launch counts around the timed
    run, and the kernel path held against plain attention."""
    from containerpilot_tpu_torch.models import transformer as tf
    from containerpilot_tpu_torch.ops import flash
    from containerpilot_tpu_torch.parallel import train as tr
    from containerpilot_tpu_torch.workload.flops import (
        count_params,
        train_flops_per_token,
    )

    cfg = tf.TransformerConfig(**TRAIN_CFG)
    state = tr.init_train_state(0, cfg, "cuda")
    step = tr.make_train_step(cfg)
    tokens = torch.randint(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ + 1),
                           generator=gen, device="cuda")
    n_params = count_params(state.params)
    torch.cuda.reset_peak_memory_stats()
    flash.LAUNCHES = flash.DQ_LAUNCHES = flash.DKDV_LAUNCHES = 0
    losses = []
    for _ in range(2):
        state, loss = step(state, tokens)
        losses.append(loss)
    torch.cuda.synchronize()
    n_timed = 5
    t0 = time.perf_counter()
    for _ in range(n_timed):
        state, loss = step(state, tokens)
        losses.append(loss)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / n_timed
    launches = {"k1_launches": flash.LAUNCHES,
                "dq_launches": flash.DQ_LAUNCHES,
                "dkdv_launches": flash.DKDV_LAUNCHES}
    n_steps = len(losses)
    for key in ("dq_launches", "dkdv_launches"):
        if launches[key] < cfg.n_layers * n_steps:
            raise AssertionError(
                f"{key} = {launches[key]} over {n_steps} training steps "
                f"of {cfg.n_layers} layers"
            )
    losses = [float(x) for x in losses]
    if not (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]):
        raise AssertionError(f"training loss did not fall: {losses}")
    tokens_s = TRAIN_BATCH * TRAIN_SEQ / step_s
    flops_per_token = train_flops_per_token(cfg, n_params, TRAIN_SEQ)
    out = {
        "phase": "train", "config": TRAIN_CFG, "batch": TRAIN_BATCH,
        "seq": TRAIN_SEQ, "params": n_params, "steps": n_steps,
        "step_ms": step_s * 1e3, "tokens_per_s": tokens_s,
        "mfu": tokens_s * flops_per_token / BF16_FLOP_PER_S,
        "flops_per_token": flops_per_token, "losses": losses,
        "peak_memory_bytes": torch.cuda.max_memory_allocated(),
        **launches,
    }

    # one value+grad through the kernels vs plain attention, batch 2;
    # then the kernels under remat "dots" (projections saved) and with
    # the chunked loss, each vs the main path's
    params = state.params
    leaves = tr.tree_leaves(params)
    results = []
    for over in ({}, {"flash_min_seq": 0}, {"remat": "dots"},
                 {"loss_chunk": 512}):
        c = tf.TransformerConfig(**{**TRAIN_CFG, **over})
        loss = tf.loss_fn(params, tokens[:2], c)
        results.append(
            (float(loss.detach()), torch.autograd.grad(loss, leaves)))

    def rel(i, j):
        (l_a, g_a), (l_b, g_b) = results[i], results[j]
        return (abs(l_a - l_b) / abs(l_b),
                max(rel_norm_err(a, b) for a, b in zip(g_a, g_b)))

    loss_rel, grad_rel = rel(0, 1)
    dots, chunked = rel(2, 0), rel(3, 0)
    if not (loss_rel <= TRAIN_LOSS_REL_TOL and grad_rel <= TRAIN_GRAD_REL_TOL
            and max(dots) <= REMAT_REL_TOL
            and max(chunked) <= CHUNKED_REL_TOL):
        raise AssertionError(
            f"kernel path vs plain attention: loss rel {loss_rel}, worst "
            f"grad leaf rel {grad_rel}; vs the main path: remat dots "
            f"{dots}, loss_chunk 512 {chunked}"
        )
    del results, state, params, leaves

    # _dot_f32 (bf16 GEMM, float32 out, its own backward) vs float32
    a = torch.randn((TRAIN_SEQ, 1024), generator=gen, device="cuda").to(
        torch.bfloat16).requires_grad_(True)
    w = (torch.randn((1024, 4096), generator=gen, device="cuda") / 32).to(
        torch.bfloat16).requires_grad_(True)
    cot = torch.randn((TRAIN_SEQ, 4096), generator=gen, device="cuda")
    got = torch.autograd.grad((tf._dot_f32(a, w) * cot).sum(), (a, w))
    af, wf = (t.detach().float().requires_grad_(True) for t in (a, w))
    want = torch.autograd.grad(((af @ wf) * cot).sum(), (af, wf))
    dot_rel = max(rel_norm_err(x, y) for x, y in zip(got, want))
    if dot_rel > DOT_GRAD_REL_TOL:
        raise AssertionError(f"_dot_f32 gradient off float32: {dot_rel}")
    out.update({
        "kernel_vs_plain_loss_rel": loss_rel,
        "kernel_vs_plain_worst_grad_rel": grad_rel,
        "remat_dots_vs_full_loss_and_grad_rel": dots,
        "loss_chunk_512_vs_whole_loss_and_grad_rel": chunked,
        "dot_f32_grad_rel_vs_f32": dot_rel,
    })
    torch.cuda.empty_cache()
    return out


def _run_train_cli(args, stop_after=None, timeout=600):
    """Run the train CLI; with ``stop_after``, SIGTERM it once its
    progress file reports that step. Returns (exit code, stdout)."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "PYTHONPATH": root}
    proc = subprocess.Popen(
        [sys.executable, "-m", "containerpilot_tpu_torch.workload.train",
         *args], cwd=root, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True,
    )
    try:
        if stop_after is not None:
            progress = args[args.index("--progress-file") + 1]
            deadline = time.monotonic() + timeout
            while time.monotonic() < deadline and proc.poll() is None:
                try:
                    with open(progress) as fh:
                        if json.load(fh)["step"] >= stop_after:
                            proc.send_signal(signal.SIGTERM)
                            break
                except (OSError, ValueError, KeyError):
                    pass
                time.sleep(0.05)
        out, _ = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return proc.returncode, out


def check_prefetcher(tmp):
    """Token-shard batches staged on the card (pinned memory, side
    stream) equal the dataset's own."""
    import numpy as np

    from containerpilot_tpu_torch.workload.data import (
        DevicePrefetcher,
        TokenShardDataset,
        write_token_shards,
    )

    shards = os.path.join(tmp, "shards")
    write_token_shards(np.random.default_rng(0).integers(0, 1024, 200_000),
                       shards, shard_size=50_000)
    dataset = TokenShardDataset(shards, 1024, 4, vocab_size=1024)
    prefetcher = DevicePrefetcher(dataset, start_step=7, device="cuda")
    try:
        for step in range(7, 12):
            got_step, batch = prefetcher.next()
            want = torch.from_numpy(dataset.batch_at(step)).long()
            if got_step != step or not batch.is_cuda or not torch.equal(
                    batch.cpu(), want):
                raise AssertionError(f"prefetched batch {got_step} differs")
    finally:
        prefetcher.stop()


def drive_train_cli():
    """The trainer CLI on the card: SIGTERM mid-run saves and exits 0; a
    restart resumes at exactly that step and finishes. Also the data
    prefetcher's staging onto the card."""
    with tempfile.TemporaryDirectory() as tmp:
        check_prefetcher(tmp)
        base = ["--device", "cuda", "--d-model", "1024", "--n-layers", "2",
                "--n-heads", "8", "--seq-len", "1024", "--batch", "4",
                "--checkpoint-dir", os.path.join(tmp, "ckpt"),
                "--checkpoint-every", "1000",
                "--progress-file", os.path.join(tmp, "progress.json")]
        t0 = time.perf_counter()
        rc, out = _run_train_cli(base + ["--steps", "1000"], stop_after=3)
        saved = re.search(r"checkpoint saved at step (\d+)", out)
        if rc != 0 or saved is None:
            raise AssertionError(f"preempted trainer: exit {rc}\n{out[-2000:]}")
        at = int(saved.group(1))
        rc, out2 = _run_train_cli(base + ["--steps", str(at + 2)])
        if rc != 0 or f"resumed from checkpoint at step {at}" not in out2:
            raise AssertionError(f"resumed trainer: exit {rc}\n{out2[-2000:]}")
        with open(os.path.join(tmp, "progress.json")) as fh:
            final = json.load(fh)
        if final["step"] != at + 2 or not math.isfinite(final["loss"]):
            raise AssertionError(f"resumed trainer ended at {final}")
    return {"phase": "train_cli", "prefetched_batches_equal": True,
            "preempted_at_step": at,
            "resumed_to_step": final["step"], "final_loss": final["loss"],
            "seconds": time.perf_counter() - t0}


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
        (8, 2048, 8, 8, 128, 0),      # the training path (bench.py:121-133)
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
    bwd_cases = [
        (8, 2048, 8, 128, 0),     # the training path (bench.py:121-133)
        (1, 1024, 16, 128, 0),    # the flagship's shape
        (1, 1024, 16, 128, 256),  # sliding window
        (1, 1024, 16, 128, 64),   # rows fully masked in a visited tile
    ]
    bwd_rows = [check_flash_bwd(gen, *c) for c in bwd_cases]
    emit({"phase": "kernels", "kernel": "flash_bwd_dq+flash_bwd_dkdv",
          "results": bwd_rows, **card})

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

    del qparams, cpu_params
    torch.cuda.empty_cache()

    # ---- train ----------------------------------------------------------
    train = drive_training(gen)
    train.update(card)
    emit(train)

    # ---- train CLI: preempt and resume ----------------------------------
    emit({**drive_train_cli(), **card})

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
        *(
            {
                "name": name, "route": "cuda",
                "source": f"containerpilot_tpu_torch/csrc/{name}.cu",
                "replaces": replaces,
                "launches": train[f"{key}_launches"],
                "max_abs_err": max(r["max_abs_err"][g] for r in bwd_rows
                                   for g in grads),
                "ms": bwd_rows[0][key]["ms"],
                "plain_ms": bwd_rows[0][key]["plain_ms"],
                "bound_ms": bwd_rows[0][key]["bound_ms"],
                "bound_by": bwd_rows[0][key]["bound_by"],
                "library_ms": bwd_rows[0]["library_ms_k3_plus_k4"],
                "library_covers": "K3+K4: SDPA fwd+bwd minus SDPA fwd",
                "shape": "b=8 s=2048 h=8 hd=128, one training layer",
            }
            for name, key, replaces, grads in (
                ("flash_bwd_dq", "dq",
                 "containerpilot_tpu/ops/flash.py:257", ("dq",)),
                ("flash_bwd_dkdv", "dkdv",
                 "containerpilot_tpu/ops/flash.py:293", ("dk", "dv")),
            )
        ),
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
