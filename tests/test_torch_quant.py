"""The port's int8 quantization and dequant GEMM against the JAX
reference. Quantization must match exactly (both round half to even on
the same float32 quotient); the GEMM (plain torch path on CPU vs the
Pallas kernel in interpret mode) within 2e-3, float32 accumulation in a
different order."""
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


@pytest.mark.parametrize("m", [1, 5, 130])
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
