"""The port's flash attention forward (plain torch path, CPU) against the
JAX Pallas kernel in interpret mode, on the same numpy inputs.

Tolerance 2e-3 (rtol and atol): the bound the reference's own
flash-vs-einsum test uses; both sides compute in float32 and differ
only in summation order."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from containerpilot_tpu.ops.flash import (
    _fwd_rows,
    _to_rows,
    flash_attention_forward as jax_flash,
)
from containerpilot_tpu_torch.ops.flash import (
    flash_attention_forward,
    flash_attention_forward_reference,
    flash_attention_forward_with_lse,
)

TOL = 2e-3


def _inputs(seed, b, s, h, hd, kv=None):
    rng = np.random.default_rng(seed)
    kv = kv or h
    q = rng.standard_normal((b, s, h, hd), dtype=np.float32)
    k = rng.standard_normal((b, s, kv, hd), dtype=np.float32)
    v = rng.standard_normal((b, s, kv, hd), dtype=np.float32)
    return q, k, v


def _both(q, k, v, block_q=128, block_k=128, window=0):
    ref = np.asarray(jax_flash(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        block_q=block_q, block_k=block_k, window=window,
    ))
    port = flash_attention_forward(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        block_q=block_q, block_k=block_k, window=window,
    ).numpy()
    return ref, port


@pytest.mark.parametrize(
    "b,s,h,kv,hd,block_q,block_k,window",
    [
        (2, 256, 2, 2, 64, 128, 128, 0),     # the reference test's shape
        (1, 256, 4, 2, 64, 128, 128, 0),     # GQA, group 2
        (1, 512, 2, 2, 64, 128, 128, 128),   # sliding window
        (1, 512, 4, 2, 64, 128, 256, 128),   # window, uneven blocks, GQA
    ],
)
def test_flash_forward_matches_jax(b, s, h, kv, hd, block_q, block_k, window):
    q, k, v = _inputs(0, b, s, h, hd, kv)
    ref, port = _both(q, k, v, block_q, block_k, window)
    np.testing.assert_allclose(port, ref, rtol=TOL, atol=TOL)


def test_flash_lse_matches_logsumexp_and_jax_rows():
    """lse = logsumexp of the masked, scaled scores, per (b*h, pos), in
    the reference's rows layout; and equal to the Pallas kernel's."""
    b, s, h, kv, hd = 1, 256, 4, 2, 64
    q, k, v = _inputs(1, b, s, h, hd, kv)
    out, lse = flash_attention_forward_with_lse(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v)
    )
    assert lse.shape == (b * h, s, 1) and lse.dtype == torch.float32
    kf = np.repeat(k, h // kv, axis=2)
    scores = np.einsum("bqhd,bkhd->bhqk", q * hd ** -0.5, kf)
    scores = np.where(np.tril(np.ones((s, s), bool)), scores, -np.inf)
    top = scores.max(-1, keepdims=True)
    expected = (top + np.log(np.exp(scores - top).sum(-1, keepdims=True)))
    np.testing.assert_allclose(
        lse.numpy(), expected.reshape(b * h, s, 1), rtol=TOL, atol=TOL
    )
    _out_rows, jax_lse = _fwd_rows(
        _to_rows(jnp.asarray(q)), _to_rows(jnp.asarray(k)),
        _to_rows(jnp.asarray(v)), 128, 128, True,
    )
    np.testing.assert_allclose(
        lse.numpy(), np.asarray(jax_lse), rtol=TOL, atol=TOL
    )


def test_flash_reference_is_the_cpu_path():
    """On CPU tensors the wrapper IS the plain version (no kernel)."""
    from containerpilot_tpu_torch.ops import flash as flash_mod

    q, k, v = (torch.from_numpy(a) for a in _inputs(2, 1, 128, 2, 64))
    before = flash_mod.LAUNCHES
    out, lse = flash_attention_forward_with_lse(q, k, v)
    ref_out, ref_lse = flash_attention_forward_reference(q, k, v)
    assert torch.equal(out, ref_out) and torch.equal(lse, ref_lse)
    assert flash_mod.LAUNCHES == before


def test_flash_rejects_ragged_seq_and_bad_kv():
    q = torch.zeros((1, 100, 2, 64))
    with pytest.raises(ValueError, match="not a multiple"):
        flash_attention_forward(q, q, q)
    q = torch.zeros((1, 128, 3, 64))
    kv = torch.zeros((1, 128, 2, 64))
    with pytest.raises(ValueError, match="incompatible"):
        flash_attention_forward(q, kv, kv)
