"""Weight-only int8 quantization and the dequant-GEMM kernel (K2).

Counterpart of ``containerpilot_tpu/ops/quant.py``. ``int8_matmul`` is
the reference's XLA path (dequantize, then multiply). The Pallas
``_int8_matmul_kernel`` becomes ``csrc/int8_matmul.cu``, launched by
``int8_matmul_padded`` on CUDA tensors; on CPU tensors that wrapper runs
``int8_matmul_kernel_reference``, the plain version with the kernel's
order of operations (float32 product of x and the int8 values, column
scales applied at the end). The CUDA kernel takes any row count from 1
to 256 as it is: nothing is padded to a 128-row tile.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

# kernel launches on the main path; chip_smoke.py zeroes and reads it
LAUNCHES = 0

KERNEL_COLS = 16      # output columns per CUDA block (16 int8 = 16 bytes)
KERNEL_MAX_ROWS = 256


def quantize_int8_axes(
    w: torch.Tensor, axes: Tuple[int, ...]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 over the given (input) axes; scales keepdims-shaped.
    torch.round rounds half to even, as jnp.round does, on the same
    float32 quotient, so values and scales equal the reference's."""
    wf = w.float()
    absmax = wf.abs().amax(dim=axes, keepdim=True)
    scales = torch.clamp_min(absmax, 1e-8) / 127.0
    w_q = torch.clamp(torch.round(wf / scales), -127, 127).to(torch.int8)
    return w_q, scales


def quantize_int8(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel: w [in, out] -> (int8 [in, out], scales [out])."""
    w_q, scales = quantize_int8_axes(w, (0,))
    return w_q, scales[0, :]


def int8_matmul(
    x: torch.Tensor, w_q: torch.Tensor, scales: torch.Tensor
) -> torch.Tensor:
    """The reference's XLA path: x [m, k] @ (w_q [k, n] * scales [n])."""
    wf = w_q.float() * scales[None, :]
    return (x.float() @ wf).to(x.dtype)


def int8_matmul_kernel_reference(
    x: torch.Tensor, w_q: torch.Tensor, scales: torch.Tensor
) -> torch.Tensor:
    """Plain version of K2 (and of the Pallas kernel): float32
    accumulation of x times the int8 values over all of k, the column
    scales multiplied at the end, cast to x's dtype."""
    acc = x.float() @ w_q.float()
    return (acc * scales.float()[None, :]).to(x.dtype)


def _check(x, w_q, scales) -> None:
    m, k = x.shape
    k2, n = w_q.shape
    if k != k2:
        raise ValueError(f"inner dims disagree: {k} vs {k2}")
    if scales.shape != (n,):
        raise ValueError(f"scales {tuple(scales.shape)} must be ({n},)")


def _launch(x, w_q, scales) -> torch.Tensor:
    global LAUNCHES
    from . import _build

    m, k = x.shape
    n = w_q.shape[1]
    if x.dtype != torch.bfloat16:
        raise TypeError(f"the int8 kernel takes bfloat16 x, got {x.dtype}")
    if w_q.dtype != torch.int8 or scales.dtype != torch.float32:
        raise TypeError(
            f"the int8 kernel takes int8 weights and float32 scales, got "
            f"{w_q.dtype} and {scales.dtype}"
        )
    for name, t in (("w_q", w_q), ("scales", scales)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    for name, t in (("x", x), ("w_q", w_q), ("scales", scales)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if not 1 <= m <= KERNEL_MAX_ROWS:
        raise ValueError(
            f"the int8 kernel takes 1..{KERNEL_MAX_ROWS} rows, got {m}"
        )
    if n % KERNEL_COLS:
        raise ValueError(
            f"the int8 kernel needs n % {KERNEL_COLS} == 0, got {n}"
        )
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    lib = _build.load("int8_matmul")
    fn = lib.int8_matmul_bf16
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(
            x.data_ptr(), w_q.data_ptr(), scales.data_ptr(),
            out.data_ptr(), m, k, n, stream,
        )
    _build.check(lib, "int8_matmul", err)
    LAUNCHES += 1
    return out


def int8_matmul_padded(
    x: torch.Tensor, w_q: torch.Tensor, scales: torch.Tensor
) -> torch.Tensor:
    """Fused dequant GEMM for any row count: x [m, k] @ dequant(w_q
    [k, n]) -> [m, n] in x's dtype. K2 for CUDA tensors, the plain
    version for CPU tensors. (The name is the reference's; the CUDA
    kernel pads nothing.)"""
    _check(x, w_q, scales)
    if x.is_cuda:
        return _launch(x, w_q, scales)
    return int8_matmul_kernel_reference(x, w_q, scales)
