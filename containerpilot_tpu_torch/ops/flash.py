"""Flash attention forward: the hand-written CUDA kernel (K1) and its
plain torch version.

Counterpart of the forward half of ``containerpilot_tpu/ops/flash.py``
(``_fwd_kernel`` / ``_fwd_rows`` / ``flash_attention_forward``). The
kernel lives in ``csrc/flash_fwd.cu``; this module validates shapes the
way the reference does, then

- for CUDA tensors launches the kernel (bf16 only; anything else
  raises — there is no fallback to the plain version),
- for CPU tensors runs ``flash_attention_forward_reference``, the plain
  torch version the tests hold against the JAX Pallas kernel.

Layout is the reference's public one, [batch, seq, heads, head_dim];
k/v may carry fewer (GQA) heads than q. ``lse`` comes back in the
reference's rows layout, [batch*heads, seq, 1] float32.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from .attention import NEG_INF

# kernel launches on the main path; chip_smoke.py zeroes and reads it
LAUNCHES = 0

KERNEL_TILE = 64     # the CUDA kernel's q and kv tile (csrc/flash_fwd.cu)
KERNEL_HEAD_DIMS = (64, 128)


def _check_shapes(q, k, v, block_q: int, block_k: int) -> None:
    """The reference's checks (``_check_shapes`` plus
    ``flash_attention_forward``'s kv checks), same messages."""
    b, s, h, hd = q.shape
    if s % block_q or s % block_k:
        raise ValueError(
            f"seq len {s} not a multiple of blocks ({block_q}, {block_k})"
        )
    if k.shape != v.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} must agree")
    kb, ks, kvh, khd = k.shape
    if kb != b or ks != s or khd != hd or kvh < 1 or h % kvh:
        raise ValueError(
            f"kv shape {tuple(k.shape)} incompatible with q {tuple(q.shape)}: "
            "need (batch, seq, kv_heads, head_dim) with kv_heads >= 1 "
            "dividing the query heads"
        )


def flash_attention_forward_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    block_q: int = 128, block_k: int = 128, window: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of K1 -> (out, lse). Same function as the
    online-softmax kernel, taken over the whole row at once: scores in
    float32 from ``q * hd**-0.5``, the causal (and window) mask of
    ``_causal_mask`` with NEG_INF, row max m, p = exp(s - m),
    l = max(sum p, 1e-30), out = (p @ v) / l cast to q's dtype,
    lse = m + log(l)."""
    _check_shapes(q, k, v, block_q, block_k)
    b, s, h, hd = q.shape
    group = h // k.shape[2]
    # q head j reads kv head j // group (the kernel's r // group)
    kf = k.float().repeat_interleave(group, dim=2)
    vf = v.float().repeat_interleave(group, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float() * hd ** -0.5, kf)
    idx = torch.arange(s, device=q.device)
    mask = idx[:, None] >= idx[None, :]
    if window > 0:
        mask &= idx[:, None] - idx[None, :] < window
    scores = torch.where(mask, scores, NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    l = torch.clamp_min(p.sum(dim=-1, keepdim=True), 1e-30)
    out = torch.einsum("bhqk,bkhd->bqhd", p, vf) / l.permute(0, 2, 1, 3)
    lse = (m + torch.log(l)).reshape(b * h, s, 1)
    return out.to(q.dtype), lse


def _launch(q, k, v, window: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K1 on CUDA tensors; validates what the kernel takes."""
    global LAUNCHES
    from . import _build

    b, s, h, hd = q.shape
    kvh = k.shape[2]
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(
                f"the flash kernel takes bfloat16; {name} is {t.dtype}"
            )
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if hd not in KERNEL_HEAD_DIMS:
        raise ValueError(
            f"the flash kernel takes head_dim in {KERNEL_HEAD_DIMS}, "
            f"got {hd}"
        )
    if s % KERNEL_TILE:
        raise ValueError(
            f"the flash kernel needs seq % {KERNEL_TILE} == 0, got {s}"
        )
    out = torch.empty_like(q)
    lse = torch.empty((b * h, s, 1), dtype=torch.float32, device=q.device)
    lib = _build.load("flash_fwd")
    fn = lib.flash_fwd_bf16
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), b, s, h, kvh, hd, max(window, 0),
            hd ** -0.5, stream,
        )
    _build.check(lib, "flash_fwd", err)
    LAUNCHES += 1
    return out, lse


def flash_attention_forward_with_lse(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    block_q: int = 128, block_k: int = 128, window: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, lse): K1 for CUDA tensors, the plain version for CPU
    tensors. ``block_q``/``block_k`` keep the reference's contract (seq
    must divide by both); the kernel tiles by its own 64 internally,
    which changes no result: kv tiles a row cannot see are masked or
    skipped either way."""
    _check_shapes(q, k, v, block_q, block_k)
    if q.is_cuda:
        return _launch(q, k, v, window)
    return flash_attention_forward_reference(
        q, k, v, block_q, block_k, window
    )


def flash_attention_forward(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    block_q: int = 128, block_k: int = 128, window: int = 0,
) -> torch.Tensor:
    """Forward-only causal flash attention (inference/prefill), GQA
    native, optional sliding ``window``; returns out only, as the
    reference's ``flash_attention_forward`` does."""
    return flash_attention_forward_with_lse(
        q, k, v, block_q, block_k, window
    )[0]
