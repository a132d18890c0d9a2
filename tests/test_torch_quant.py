"""The port's int8 quantization and dequant GEMM against the JAX
reference. Quantization must match exactly (both round half to even on
the same float32 quotient); the GEMM (plain torch path on CPU vs the
Pallas kernel in interpret mode) within 2e-3, float32 accumulation in a
different order. The CUDA kernel K2 runs only on a card; its launch
plan and its refusals are pure Python and are held here."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from containerpilot_tpu.ops import quant as jax_quant
from containerpilot_tpu_torch.ops import quant


@pytest.mark.parametrize("shape,axes", [
    ((64, 48), (0,)),
    ((2, 32, 4, 16), (1,)),
    ((2, 4, 16, 32), (1, 2)),
])
def test_quantize_int8_axes_matches_jax_exactly(shape, axes):
    rng = np.random.default_rng(0)
    w = rng.standard_normal(shape, dtype=np.float32)
    w[0] = 0.0  # an all-zero slice exercises the 1e-8 floor
    jq, js = jax_quant.quantize_int8_axes(jnp.asarray(w), axes)
    tq, ts = quant.quantize_int8_axes(torch.from_numpy(w), axes)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("m", [1, 5, 8, 9, 16, 130, 255, 256])
def test_int8_matmul_padded_matches_pallas(m):
    rng = np.random.default_rng(m)
    k, n = 256, 384
    x = rng.standard_normal((m, k), dtype=np.float32)
    w = rng.standard_normal((k, n), dtype=np.float32)
    jq, js = jax_quant.quantize_int8(jnp.asarray(w))
    ref = np.asarray(jax_quant.int8_matmul_padded(jnp.asarray(x), jq, js))
    out = quant.int8_matmul_padded(
        torch.from_numpy(x), torch.from_numpy(np.array(jq)),
        torch.from_numpy(np.array(js)),
    )
    assert out.shape == (m, n) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=2e-3, atol=2e-3)
    # the XLA-path counterpart agrees too
    xla = quant.int8_matmul(
        torch.from_numpy(x), torch.from_numpy(np.array(jq)),
        torch.from_numpy(np.array(js)),
    )
    np.testing.assert_allclose(xla.numpy(), ref, rtol=2e-3, atol=2e-3)


def test_int8_matmul_padded_rejects_bad_shapes():
    x = torch.zeros((2, 64))
    w = torch.zeros((32, 16), dtype=torch.int8)
    with pytest.raises(ValueError, match="inner dims"):
        quant.int8_matmul_padded(x, w, torch.ones(16))
    with pytest.raises(ValueError, match="scales"):
        quant.int8_matmul_padded(x, torch.zeros((64, 16), dtype=torch.int8),
                                 torch.ones(8))


# Every (m, k, n) the main path sends K2 (can_fuse_int8): the flagship's
# projections (bench.py:380-383: d_model 2048, 16 heads of 128, d_ff
# 8192) at the decode row counts chip_smoke.py reads, and the fused
# config of tests/test_torch_model.py (d_model 128, one head, d_ff 128).
FLAGSHIP_PROJ = [(2048, 2048), (2048, 8192), (8192, 2048)]
PLAN_CASES = (
    [(m, k, n, True) for m in (1, 8, 16, 256) for (k, n) in FLAGSHIP_PROJ]
    + [(m, 128, 128, False) for m in (1, 2, 8)]
)


@pytest.mark.parametrize("m,k,n,flagship", PLAN_CASES)
def test_plan_fits_the_kernel(m, k, n, flagship):
    """The plan takes what csrc/int8_matmul.cu checks: rows one of the
    wgmma's N, row tiles covering exactly m, k split evenly into whole
    64-deep stages, the grid (row tiles, splits, n / 128). Splitting stops
    where a split would fall under its least k (4 stages, and rows / 4 so
    the float32 partials stay small against the weights) or the grid would
    pass the blocks resident at two an SM; so at the flagship's shapes the
    grid holds more than half the blocks the 132 SMs keep resident, unless
    k ran out first."""
    plan = quant._plan(m, k, n)
    assert plan.rows in quant.KERNEL_ROWS
    assert plan.rows >= min(m, quant.KERNEL_ROWS[-1])
    assert (plan.row_tiles - 1) * plan.rows < m <= plan.row_tiles * plan.rows
    k_tiles = k // quant.KERNEL_TILE_K
    assert k % quant.KERNEL_TILE_K == 0 and k_tiles % plan.splits == 0
    assert plan.splits & (plan.splits - 1) == 0
    assert plan.grid == (plan.row_tiles, plan.splits, n // quant.KERNEL_TILE_N)
    blocks = plan.grid[0] * plan.grid[1] * plan.grid[2]
    resident = quant.SM_COUNT * quant.BLOCKS_PER_SM
    need = quant._min_k_tiles(plan.rows)
    assert blocks <= resident or plan.splits == 1
    per_split = k_tiles // plan.splits
    assert per_split >= min(need, k_tiles)
    can_split_more = (per_split % 2 == 0 and per_split // 2 >= need
                      and 2 * blocks <= resident)
    assert not can_split_more
    if flagship:  # more than half the resident blocks, or k ran out
        assert 2 * blocks > resident or per_split < 2 * need


def _tensors(m=4, k=128, n=128, x_dtype=torch.bfloat16,
             w_dtype=torch.int8, s_dtype=torch.float32):
    return (torch.zeros((m, k), dtype=x_dtype),
            torch.zeros((k, n), dtype=w_dtype),
            torch.ones(n, dtype=s_dtype))


@pytest.mark.parametrize("case,error,match", [
    ("m=0", ValueError, "1..256 rows"),
    ("m=257", ValueError, "1..256 rows"),
    ("n=200", ValueError, "n % 128"),
    ("n=64", ValueError, "n % 128"),
    ("k=100", ValueError, "k % 64"),
    ("x float32", TypeError, "bfloat16 x"),
    ("w_q bfloat16", TypeError, "int8 weights"),
    ("scales float16", TypeError, "float32 scales"),
    ("x strided", ValueError, "contiguous"),
])
def test_kernel_refuses_what_it_does_not_take(case, error, match):
    """What K2 does not take raises (ValueError for shapes and layout,
    TypeError for dtypes); the wrapper never falls back to the plain
    version for a CUDA tensor. Checked on the wrapper's own checks, which
    need no card."""
    args = {
        "m=0": _tensors(m=0), "m=257": _tensors(m=257),
        "n=200": _tensors(n=200), "n=64": _tensors(n=64),
        "k=100": _tensors(k=100),
        "x float32": _tensors(x_dtype=torch.float32),
        "w_q bfloat16": _tensors(w_dtype=torch.bfloat16),
        "scales float16": _tensors(s_dtype=torch.float16),
    }.get(case)
    if case == "x strided":
        x, w_q, scales = _tensors(k=256)
        args = (x[:, ::2], w_q[::2], scales)
    with pytest.raises(error, match=match):
        quant._kernel_plan(*args)
