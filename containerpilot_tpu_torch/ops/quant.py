"""Weight-only int8 quantization and the dequant-GEMM kernel (K2).

Counterpart of ``containerpilot_tpu/ops/quant.py``. ``int8_matmul`` is
the reference's XLA path (dequantize, then multiply). The Pallas
``_int8_matmul_kernel`` becomes ``csrc/int8_matmul.cu``, launched by
``int8_matmul_padded`` on CUDA tensors; on CPU tensors that wrapper runs
``int8_matmul_kernel_reference``, the plain version with the kernel's
order of operations (float32 product of x and the int8 values, column
scales applied at the end). The CUDA kernel takes any row count from 1
to 256 as it is: x rows past m read as zeros (TMA's out-of-bounds fill),
nothing is padded or copied. ``_plan`` picks the launch (rows per block,
k splits, grid) in Python, where the CPU tests reach it.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple, Tuple

import torch

# kernel launches on the main path; chip_smoke.py zeroes and reads it
LAUNCHES = 0

KERNEL_TILE_N = 128   # output columns per CUDA block (two m64 products)
KERNEL_TILE_K = 64    # k rows per stage of the block's ring
KERNEL_ROWS = (8, 16, 32, 64)  # the wgmma's N: x rows per block
KERNEL_MAX_ROWS = 256
# split k until the grid fills the resident blocks (two an SM on the
# H100's 132 SMs), keeping at least MIN_K_TILES_PER_SPLIT ring stages of
# k per block, and rows / 4 of them: the float32 partials of a split
# (128 x rows) must stay small against its weights
SM_COUNT = 132
BLOCKS_PER_SM = 2
MIN_K_TILES_PER_SPLIT = 4


def _min_k_tiles(rows: int) -> int:
    return max(MIN_K_TILES_PER_SPLIT, rows // 4)


class Plan(NamedTuple):
    """One launch of K2: ``rows`` x rows per block (the wgmma's N),
    ``row_tiles`` blocks down m, ``splits`` shares of k, and the grid
    (row_tiles, splits, n / 128)."""

    rows: int
    row_tiles: int
    splits: int
    grid: Tuple[int, int, int]


@functools.lru_cache(maxsize=None)
def _plan(m: int, k: int, n: int) -> Plan:
    """The launch plan of K2 for x [m, k] @ w_q [k, n]; raises
    ValueError for a shape the kernel does not take."""
    if not 1 <= m <= KERNEL_MAX_ROWS:
        raise ValueError(
            f"the int8 kernel takes 1..{KERNEL_MAX_ROWS} rows, got {m}"
        )
    if n < KERNEL_TILE_N or n % KERNEL_TILE_N:
        raise ValueError(
            f"the int8 kernel needs n % {KERNEL_TILE_N} == 0, got {n}"
        )
    if k < KERNEL_TILE_K or k % KERNEL_TILE_K:
        raise ValueError(
            f"the int8 kernel needs k % {KERNEL_TILE_K} == 0, got {k}"
        )
    rows = next(r for r in KERNEL_ROWS if r >= min(m, KERNEL_ROWS[-1]))
    row_tiles = -(-m // rows)
    tiles = row_tiles * (n // KERNEL_TILE_N)
    k_tiles = k // KERNEL_TILE_K
    need = _min_k_tiles(rows)
    resident = SM_COUNT * BLOCKS_PER_SM
    splits = 1
    while (k_tiles % (2 * splits) == 0 and k_tiles // (2 * splits) >= need
           and tiles * 2 * splits <= resident):
        splits *= 2
    return Plan(rows, row_tiles, splits, (row_tiles, splits, n // KERNEL_TILE_N))


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


def _kernel_plan(x, w_q, scales) -> Plan:
    """What K2 takes: bf16 x, int8 weights and float32 scales on one
    device, contiguous and 16-byte aligned, shapes within ``_plan``'s.
    Raises TypeError or ValueError for anything else; nothing falls
    back. (Every call of the decode path comes through here, so the
    checks stay cheap: dtype identity, device indices.)"""
    if x.dtype is not torch.bfloat16:
        raise TypeError(f"the int8 kernel takes bfloat16 x, got {x.dtype}")
    if w_q.dtype is not torch.int8 or scales.dtype is not torch.float32:
        raise TypeError(
            f"the int8 kernel takes int8 weights and float32 scales, got "
            f"{w_q.dtype} and {scales.dtype}"
        )
    dev = x.get_device()
    for name, t in (("w_q", w_q), ("scales", scales)):
        if t.get_device() != dev:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    for name, t in (("x", x), ("w_q", w_q), ("scales", scales)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    m, k = x.shape
    return _plan(m, k, w_q.shape[1])


# the split-k reduction's float32 partials and int32 counters (one for
# each thread slot of each tile), per (device, floats, tiles); every
# launch leaves the counters at zero, and launches that share them run
# in one stream
_workspaces: Dict[Tuple[torch.device, int, int],
                  Tuple[torch.Tensor, torch.Tensor]] = {}


def _workspace(device, plan: Plan):
    tiles = plan.row_tiles * plan.grid[2]
    floats = tiles * plan.splits * KERNEL_TILE_N * plan.rows
    key = (device, floats, tiles)
    found = _workspaces.get(key)
    if found is None:
        found = (torch.empty(floats, dtype=torch.float32, device=device),
                 torch.zeros(tiles * 128, dtype=torch.int32, device=device))
        _workspaces[key] = found
    return found


def _entry(lib):
    fn = lib.int8_matmul_bf16
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return fn


def _launch(x, w_q, scales) -> torch.Tensor:
    global LAUNCHES
    from . import _build

    plan = _kernel_plan(x, w_q, scales)
    m, k = x.shape
    n = w_q.shape[1]
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    ws_ptr = counters_ptr = None
    if plan.splits > 1:
        ws, counters = _workspace(x.device, plan)
        ws_ptr, counters_ptr = ws.data_ptr(), counters.data_ptr()
    lib = _build.load("int8_matmul")
    dev = x.get_device()
    args = (
        x.data_ptr(), w_q.data_ptr(), scales.data_ptr(), out.data_ptr(),
        ws_ptr, counters_ptr, m, k, n, plan.rows, plan.row_tiles,
        plan.splits, torch._C._cuda_getCurrentRawStream(dev),
    )
    if torch.cuda.current_device() == dev:
        err = _entry(lib)(*args)
    else:  # the launch goes to the current device's context
        with torch.cuda.device(dev):
            err = _entry(lib)(*args)
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
