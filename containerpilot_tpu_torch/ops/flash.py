"""Flash attention: the hand-written CUDA kernels (K1 forward, K3 dq, K4
dk/dv), their plain torch versions, and the differentiable
``flash_attention``.

Counterpart of ``containerpilot_tpu/ops/flash.py``. The kernels live in
``csrc/flash_fwd.cu``, ``csrc/flash_bwd_dq.cu`` and
``csrc/flash_bwd_dkdv.cu``; this module validates shapes the way the
reference does, then

- for CUDA tensors launches the kernels (bf16 only; anything else
  raises — there is no fallback to the plain version),
- for CPU tensors runs the plain torch versions the tests hold against
  the JAX Pallas kernels.

Layout is the reference's public one, [batch, seq, heads, head_dim].
``flash_attention_forward`` takes GQA k/v (fewer heads than q) and is
forward only: on a CUDA tensor it refuses inputs that require grad while
autograd records, since a kernel's output carries no gradient.
``flash_attention`` is the training path: a ``torch.autograd.Function``
whose forward is K1 and whose backward is K3 + K4 (the reference's
``custom_vjp``), with full-head k/v as the reference requires. ``lse``
and ``D = rowsum(dO * O)`` travel in the reference's rows layout,
[batch*heads, seq, 1] float32.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from .attention import NEG_INF

# kernel launches on the main path; chip_smoke.py zeroes and reads them
LAUNCHES = 0        # K1, flash forward
DQ_LAUNCHES = 0     # K3, backward dq
DKDV_LAUNCHES = 0   # K4, backward dk/dv

KERNEL_TILE = 64     # the CUDA kernels' q and kv tile (csrc/flash_*.cu)
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


def _mask(s: int, window: int, device) -> torch.Tensor:
    """[s, s] bool, True where query i may attend key j: the reference's
    ``_causal_mask`` over the whole row."""
    idx = torch.arange(s, device=device)
    mask = idx[:, None] >= idx[None, :]
    if window > 0:
        mask &= idx[:, None] - idx[None, :] < window
    return mask


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
    scores = torch.where(_mask(s, window, q.device), scores, NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    l = torch.clamp_min(p.sum(dim=-1, keepdim=True), 1e-30)
    out = torch.einsum("bhqk,bkhd->bqhd", p, vf) / l.permute(0, 2, 1, 3)
    lse = (m + torch.log(l)).reshape(b * h, s, 1)
    return out.to(q.dtype), lse


def _check_kernel_inputs(tensors, hd: int, s: int, what: str) -> None:
    """What the CUDA kernels take: bf16, contiguous, 16-byte aligned, one
    device; lse/D-style float32 tensors are checked by the caller."""
    dev = tensors[0][1].device
    for name, t in tensors:
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, not {dev}")
        if t.dtype != torch.bfloat16:
            raise TypeError(
                f"the {what} kernel takes bfloat16; {name} is {t.dtype}"
            )
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if hd not in KERNEL_HEAD_DIMS:
        raise ValueError(
            f"the {what} kernel takes head_dim in {KERNEL_HEAD_DIMS}, got {hd}"
        )
    if s % KERNEL_TILE:
        raise ValueError(
            f"the {what} kernel needs seq % {KERNEL_TILE} == 0, got {s}"
        )


def _check_rows(name: str, t: torch.Tensor, rows: int, s: int, dev) -> None:
    if (t.device != dev or t.dtype != torch.float32 or not t.is_contiguous()
            or t.numel() != rows * s):
        raise ValueError(
            f"{name} must be a contiguous float32 [{rows}, {s}, 1] tensor "
            f"on {dev}, got {t.dtype} {tuple(t.shape)} on {t.device}"
        )


def _launch(q, k, v, window: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K1 on CUDA tensors; validates what the kernel takes."""
    global LAUNCHES
    from . import _build

    b, s, h, hd = q.shape
    kvh = k.shape[2]
    _check_kernel_inputs((("q", q), ("k", k), ("v", v)), hd, s, "flash")
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


def _refuse_untracked_grad(q, k, v) -> None:
    """A kernel writes its output through ctypes, outside autograd: on the
    card, a forward-only call whose inputs require grad would hand back a
    result that silently drops the attention gradient. Refuse it."""
    if q.is_cuda and torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v)
    ):
        raise RuntimeError(
            "flash_attention_forward is forward only and its CUDA kernel "
            "output carries no gradient, but an input requires grad while "
            "autograd records: call flash_attention (the differentiable "
            "path) or run under torch.no_grad()/torch.inference_mode()"
        )


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
    _refuse_untracked_grad(q, k, v)
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


# ---------------------------------------------------------------------------
# backward: K3 (dq) and K4 (dk, dv)
# ---------------------------------------------------------------------------


def attention_delta(out: torch.Tensor, d_out: torch.Tensor) -> torch.Tensor:
    """D = rowsum(dO * O) in float32, [batch*heads, seq, 1] — the small
    reduction the reference leaves to XLA outside its kernels."""
    b, s, h, _hd = out.shape
    d = (d_out.float() * out.float()).sum(dim=-1)  # [b, s, h]
    return d.permute(0, 2, 1).reshape(b * h, s, 1).contiguous()


def _bwd_terms(q, k, v, d_out, lse, delta, window):
    """The shared recomputation of both backward kernels, over whole
    rows: (q * scale, k, dO, p, ds) in float32, p and ds as
    [b, h, q, k]. p is exactly 0 where the mask drops a pair (the
    reference's ``where``), never exp(NEG_INF - lse)."""
    b, s, h, hd = q.shape
    qs = q.float() * hd ** -0.5
    kf, vf, dof = k.float(), v.float(), d_out.float()
    scores = torch.einsum("bqhd,bkhd->bhqk", qs, kf)
    lse_b = lse.reshape(b, h, s, 1)
    p = torch.where(
        _mask(s, window, q.device), torch.exp(scores - lse_b),
        torch.zeros((), device=q.device),
    )
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = p * (dp - delta.reshape(b, h, s, 1))
    return qs, kf, dof, p, ds


def flash_backward_dq_reference(q, k, v, d_out, lse, delta, window=0):
    """Plain torch version of K3: dq = scale * sum_k ds . k, q's dtype."""
    qs, kf, _dof, _p, ds = _bwd_terms(q, k, v, d_out, lse, delta, window)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * q.shape[-1] ** -0.5
    return dq.to(q.dtype)


def flash_backward_dkdv_reference(q, k, v, d_out, lse, delta, window=0):
    """Plain torch version of K4: dv = sum_q p^T dO, dk = sum_q ds^T
    (q * scale), in k's and v's dtypes."""
    qs, _kf, dof, p, ds = _bwd_terms(q, k, v, d_out, lse, delta, window)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qs)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_backward_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
    lse: torch.Tensor, d_out: torch.Tensor, window: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain torch version of K3 and K4 together: (dq, dk, dv) of the
    flash forward whose residuals are (q, k, v, out, lse), for the
    output cotangent ``d_out``; full-head k/v."""
    delta = attention_delta(out, d_out)
    dq = flash_backward_dq_reference(q, k, v, d_out, lse, delta, window)
    dk, dv = flash_backward_dkdv_reference(q, k, v, d_out, lse, delta, window)
    return dq, dk, dv


def _bwd_args(q, k, v, d_out, lse, delta, what: str):
    b, s, h, hd = q.shape
    _check_kernel_inputs(
        (("q", q), ("k", k), ("v", v), ("d_out", d_out)), hd, s, what
    )
    if k.shape != q.shape or v.shape != q.shape or d_out.shape != q.shape:
        raise ValueError(f"the {what} kernel takes full-head k/v/d_out like q")
    _check_rows("lse", lse, b * h, s, q.device)
    _check_rows("delta", delta, b * h, s, q.device)
    return b, s, h, hd


def _launch_bwd(name: str, inputs, outputs, dims, window: int, hd: int, dev):
    from . import _build

    lib = _build.load(name)
    fn = getattr(lib, f"{name}_bf16")
    n_ptr = len(inputs) + len(outputs)
    fn.argtypes = (
        [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * (len(dims) + 1)
        + [ctypes.c_float, ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            *(t.data_ptr() for t in (*inputs, *outputs)), *dims, window,
            hd ** -0.5, stream,
        )
    _build.check(lib, name, err)


def flash_backward_dq(q, k, v, d_out, lse, delta, window: int = 0):
    """dq: K3 for CUDA tensors, its plain version for CPU tensors.
    q/k/v/d_out [b, s, h, hd] full heads; lse and delta [b*h, s, 1]
    float32."""
    global DQ_LAUNCHES
    if not q.is_cuda:
        return flash_backward_dq_reference(q, k, v, d_out, lse, delta, window)
    b, s, h, hd = _bwd_args(q, k, v, d_out, lse, delta, "flash dq")
    dq = torch.empty_like(q)
    _launch_bwd("flash_bwd_dq", (q, k, v, d_out, lse, delta), (dq,),
                (b, s, h, hd), max(window, 0), hd, q.device)
    DQ_LAUNCHES += 1
    return dq


def flash_backward_dkdv(q, k, v, d_out, lse, delta, window: int = 0):
    """(dk, dv): K4 for CUDA tensors, its plain version for CPU tensors.
    Same arguments as ``flash_backward_dq``."""
    global DKDV_LAUNCHES
    if not q.is_cuda:
        return flash_backward_dkdv_reference(q, k, v, d_out, lse, delta, window)
    b, s, h, hd = _bwd_args(q, k, v, d_out, lse, delta, "flash dk/dv")
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    _launch_bwd("flash_bwd_dkdv", (q, k, v, d_out, lse, delta), (dk, dv),
                (b, s, h, hd), max(window, 0), hd, q.device)
    DKDV_LAUNCHES += 1
    return dk, dv


class _FlashAttention(torch.autograd.Function):
    """The reference's ``custom_vjp``: forward K1 saving (q, k, v, out,
    lse); backward D in plain torch, then K3 and K4 (their plain versions
    for CPU tensors). Autograd never differentiates the forward: the
    forward runs with grad recording off and the backward is this
    class's own."""

    @staticmethod
    def forward(ctx, q, k, v, block_q, block_k, window):
        if q.is_cuda:
            out, lse = _launch(q, k, v, window)
        else:
            out, lse = flash_attention_forward_reference(
                q, k, v, block_q, block_k, window
            )
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.window = window
        return out

    @staticmethod
    def backward(ctx, d_out):
        q, k, v, out, lse = ctx.saved_tensors
        d_out = d_out.to(out.dtype).contiguous()
        delta = attention_delta(out, d_out)
        dq = flash_backward_dq(q, k, v, d_out, lse, delta, ctx.window)
        dk, dv = flash_backward_dkdv(q, k, v, d_out, lse, delta, ctx.window)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
                None, None, None)


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    block_q: int = 128, block_k: int = 128, window: int = 0,
) -> torch.Tensor:
    """Causal flash attention, differentiable: forward K1, backward K3 +
    K4 on the card (the plain versions on the CPU). Same contract as the
    reference's ``flash_attention``: seq must divide by both blocks, and
    k/v must carry full heads (repeat GQA kv upstream, or use
    ``flash_attention_forward`` for GQA-native inference). ``window > 0``
    is sliding-window attention; the kernels skip kv tiles entirely
    older than the window, in the forward and both backward kernels."""
    _check_shapes(q, k, v, block_q, block_k)
    if k.shape != q.shape or v.shape != q.shape:
        # the backward kernels index k/v by q-row; grouped (GQA) kv
        # would produce wrong-shaped, wrong-valued dk/dv here
        raise ValueError(
            f"flash_attention requires full-head k/v matching q "
            f"{tuple(q.shape)}, got k {tuple(k.shape)} — repeat GQA kv "
            "upstream, or use flash_attention_forward for GQA-native "
            "inference"
        )
    return _FlashAttention.apply(q, k, v, block_q, block_k, window)
