"""The port's sampling draw, in Triton: one kernel that turns filtered
logits and per-row threefry keys into sampled token ids.

The draw replaces no Pallas kernel: the reference draws with
``jax.random.categorical`` inside its jitted sampler, where XLA fuses the
threefry hash, the Gumbel noise and the argmax into its own loops
(``containerpilot_tpu/models/decode.py`` ``sample_logits``). Done as
plain torch (``ops/prng.py``) the same draw is about 150 elementwise
launches over [rows, vocab] int64 words a step; this kernel is one
launch, one program a row:

1. ``fold_in(row_key, step)``: the row's key for this step (threefry of
   the counts (0, step));
2. for each block of the vocab, the partitionable threefry bits of the
   counts (0, j), JAX's uniform on [tiny, 1) from their top 23 bits, the
   Gumbel noise ``-log(-log(u))`` (libdevice's ``logf``, torch's on the
   card), plus the filtered logits;
3. a running argmax over the blocks, ties to the lowest index (as
   ``jnp.argmax``).

Triton, not CUDA C++: the work is an integer hash (adds, rotates and
xors, no products) fused with one row reduction; shared memory and the
tensor cores would give it nothing. What bounds it is the hash's
operations (about 80 a vocab entry), not the logits' bytes.
With one program a row, a pool of 8 rows keeps 8 of the card's 132 SMs
busy: simple first, split rows across programs later.

``gumbel_argmax`` launches the kernel for CUDA tensors (no fallback: it
raises if Triton is missing or the kernel does not build) and runs the
plain version, ``gumbel_argmax_plain``, only on the CPU. Triton is
imported, and the kernel built, on the first CUDA call, never at import.
"""
from __future__ import annotations

import functools
import os

import torch

from . import _build, prng

# kernel launches on the main path; chip_smoke.py zeroes and reads it
LAUNCHES = 0

BLOCK = 1024    # vocab entries a program hashes per loop iteration
NUM_WARPS = 4

# The bound counts 32-bit operations as the card issues them, one a lane
# each, at its issue limit: one warp instruction a clock on each of an
# SM's 4 partitions, 128 lanes an SM, 132 SMs at 1.98 GHz (the 67
# TFLOP/s float32 figure counts an FMA as two). No integer or float
# pipe retires more.
LANE_OPS_PER_S = 128 * 132 * 1.98e9
# the hash: 20 rounds of an add, a rotate (one funnel shift) and a xor;
# 5 key injections of one add to x0 and one to x1 (key and round count
# at once); the 2 first adds
HASH_OPS = 20 * 3 + 5 * 2 + 2
# a vocab entry of the draw: the hash, the words' xor, the mantissa's
# shift and or; the uniform's subtract, add and max, two logs, the
# logits' add and the argmax's compare
DRAW_OPS = HASH_OPS + 3 + 7


def gumbel_argmax_plain(x: torch.Tensor, row_keys: torch.Tensor,
                        step) -> torch.Tensor:
    """The kernel's function in plain torch (``ops/prng.py``): row r's
    token is ``categorical(fold_in(row_keys[r], step[r]), x[r])``."""
    keys = prng.fold_in(row_keys, _steps(step, x.shape[0], x.device))
    return prng.categorical(keys, x)


def draw_bits_plain(row_keys: torch.Tensor, step,
                    vocab: int) -> torch.Tensor:
    """The 32-bit words the draw hashes for each row: ``random_bits``
    of the row's folded key over [vocab]."""
    keys = prng.fold_in(row_keys, _steps(step, row_keys.shape[0],
                                         row_keys.device))
    return prng.random_bits(keys, (vocab,))


def _steps(step, rows: int, device) -> torch.Tensor:
    """``step`` as [rows] int64 on ``device``: a tensor is broadcast, an
    int filled on the device (no host-to-device copy)."""
    if isinstance(step, torch.Tensor):
        return step.to(device=device, dtype=torch.int64).expand(rows)
    return torch.full((rows,), int(step), dtype=torch.int64, device=device)


def gumbel_argmax(x: torch.Tensor, row_keys: torch.Tensor, step,
                  bits_out: torch.Tensor = None) -> torch.Tensor:
    """Sampled token ids [rows] (int64) from filtered float32 logits
    ``x`` [rows, vocab], ``row_keys`` [rows, 2] (int64 words) and
    ``step`` (an int or [rows] int64): ``categorical(fold_in(key,
    step), logits)`` for every row. On the card one launch of the draw
    kernel; with ``bits_out`` ([rows, vocab] int32) it also writes the
    hashed words (a check's view of the bits). On the CPU the plain
    version."""
    global LAUNCHES
    if x.device.type == "cpu":
        if bits_out is not None:
            bits_out.copy_(draw_bits_plain(row_keys, step, x.shape[1])
                           .to(torch.int32))
        return gumbel_argmax_plain(x, row_keys, step)
    if x.device.type != "cuda":
        raise ValueError(f"the draw kernel runs on CUDA, not {x.device}")
    rows, vocab = x.shape
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("the draw kernel takes contiguous float32 logits")
    if (row_keys.shape != (rows, 2) or row_keys.dtype != torch.int64
            or row_keys.device != x.device):
        raise ValueError(
            f"row keys must be int64 [{rows}, 2] on {x.device}, got "
            f"{row_keys.dtype} {tuple(row_keys.shape)} on {row_keys.device}")
    steps = _steps(step, rows, x.device).contiguous()
    keys = row_keys.contiguous()
    if bits_out is not None and (
            bits_out.shape != (rows, vocab) or bits_out.dtype != torch.int32
            or not bits_out.is_contiguous() or bits_out.device != x.device):
        raise ValueError("bits_out must be contiguous int32 [rows, vocab]")
    out = torch.empty((rows,), dtype=torch.int64, device=x.device)
    _kernel()[(rows,)](
        x, keys, steps, out, bits_out if bits_out is not None else out,
        vocab, x.stride(0), BLOCK=BLOCK, WRITE_BITS=bits_out is not None,
        num_warps=NUM_WARPS,
    )
    LAUNCHES += 1
    return out


# --------------------------------------------------------------------------
# The kernel's source. ``tl``, ``libdevice``, ``threefry`` and ``mix`` are
# names of this module that ``_kernel`` binds on the first CUDA call (the
# CPU has no Triton); the functions below are compiled only then.


def _mix_src(x0, x1, r: tl.constexpr):
    x0 = x0 + x1
    x1 = (x1 << r) | (x1 >> (32 - r))
    return x0, x1 ^ x0


def _threefry_src(k0, k1, x0, x1):
    """Threefry-2x32, 20 rounds, on uint32 values (as prng._hash)."""
    k2 = k0 ^ k1 ^ 0x1BD11BDA
    x0 = x0 + k0
    x1 = x1 + k1
    x0, x1 = mix(x0, x1, 13)
    x0, x1 = mix(x0, x1, 15)
    x0, x1 = mix(x0, x1, 26)
    x0, x1 = mix(x0, x1, 6)
    x0 = x0 + k1
    x1 = x1 + k2 + 1
    x0, x1 = mix(x0, x1, 17)
    x0, x1 = mix(x0, x1, 29)
    x0, x1 = mix(x0, x1, 16)
    x0, x1 = mix(x0, x1, 24)
    x0 = x0 + k2
    x1 = x1 + k0 + 2
    x0, x1 = mix(x0, x1, 13)
    x0, x1 = mix(x0, x1, 15)
    x0, x1 = mix(x0, x1, 26)
    x0, x1 = mix(x0, x1, 6)
    x0 = x0 + k0
    x1 = x1 + k1 + 3
    x0, x1 = mix(x0, x1, 17)
    x0, x1 = mix(x0, x1, 29)
    x0, x1 = mix(x0, x1, 16)
    x0, x1 = mix(x0, x1, 24)
    x0 = x0 + k1
    x1 = x1 + k2 + 4
    x0, x1 = mix(x0, x1, 13)
    x0, x1 = mix(x0, x1, 15)
    x0, x1 = mix(x0, x1, 26)
    x0, x1 = mix(x0, x1, 6)
    x0 = x0 + k2
    x1 = x1 + k0 + 5
    return x0, x1


def _draw_src(x_ptr, key_ptr, step_ptr, out_ptr, bits_ptr, vocab, stride,
              BLOCK: tl.constexpr, WRITE_BITS: tl.constexpr):
    row = tl.program_id(0)
    k0 = tl.load(key_ptr + 2 * row).to(tl.uint32)
    k1 = tl.load(key_ptr + 2 * row + 1).to(tl.uint32)
    step = tl.load(step_ptr + row).to(tl.uint32)
    # fold_in(key, step): the hash of the counts (0, step)
    f0, f1 = threefry(k0, k1, step ^ step, step)
    lanes = tl.arange(0, BLOCK)
    zeros = tl.zeros((BLOCK,), dtype=tl.uint32)
    # each lane's best score so far and its index: a later block takes a
    # lane only when strictly higher, so a lane keeps its lowest index
    best = tl.full((BLOCK,), float("-inf"), tl.float32)
    best_at = tl.zeros((BLOCK,), dtype=tl.int32)
    for start in range(0, vocab, BLOCK):
        j = start + lanes
        inside = j < vocab
        b0, b1 = threefry(f0, f1, zeros, j.to(tl.uint32))
        bits = b0 ^ b1
        if WRITE_BITS:
            tl.store(bits_ptr + row * vocab + j,
                     bits.to(tl.int32, bitcast=True), mask=inside)
        u = ((bits >> 9) | 0x3F800000).to(tl.float32, bitcast=True) - 1.0
        # uniform on [tiny, 1): u * (1 - tiny) + tiny, and 1 - tiny is 1
        u = tl.maximum(u + 1.1754943508222875e-38, 1.1754943508222875e-38)
        noise = -libdevice.log(-libdevice.log(u))
        x = tl.load(x_ptr + row * stride + j, mask=inside, other=0.0)
        score = tl.where(inside, noise + x, float("-inf"))
        take = score > best
        best_at = tl.where(take, j, best_at)
        best = tl.where(take, score, best)
    top = tl.max(best, axis=0)
    at = tl.min(tl.where(best == top, best_at, vocab), axis=0)
    tl.store(out_ptr + row, at.to(tl.int64))


@functools.lru_cache(maxsize=None)
def _kernel():
    """Import Triton and compile the draw's functions (once). Triton
    caches what it compiles under the kernels' build directory
    (``_build.build_dir()/triton``, unless ``TRITON_CACHE_DIR`` names
    another), beside the nvcc libraries, so a process that finds them
    there loads them instead of compiling."""
    os.environ.setdefault("TRITON_CACHE_DIR",
                          os.path.join(_build.build_dir(), "triton"))
    import triton
    import triton.language as language

    try:
        from triton.language.extra import libdevice as device_lib
    except ImportError:  # older Triton keeps it under the CUDA backend
        from triton.language.extra.cuda import libdevice as device_lib
    names = globals()
    names["tl"] = language
    names["libdevice"] = device_lib
    names["mix"] = triton.jit(_mix_src)
    names["threefry"] = triton.jit(_threefry_src)
    return triton.jit(_draw_src)


def bound_ms(rows: int, vocab: int) -> dict:
    """The least time the card could take for one draw over [rows,
    vocab]: its operations at LANE_OPS_PER_S against the bytes (logits
    read, keys and steps read, tokens written) at 3.35 TB/s."""
    ops = rows * vocab * DRAW_OPS
    nbytes = rows * vocab * 4 + rows * (16 + 8 + 8)
    ops_s, bytes_s = ops / LANE_OPS_PER_S, nbytes / 3.35e12
    return {"bound_ms": max(ops_s, bytes_s) * 1e3,
            "bound_by": "operations" if ops_s >= bytes_s else "bytes",
            "ops": ops, "bytes": nbytes}
