"""The port's differentiable flash attention (``flash_attention``: K1
forward, K3 + K4 backward; their plain versions on the CPU) against the
JAX Pallas kernels in interpret mode, on the same numpy inputs, and the
guard that keeps the forward-only kernel out of autograd.

Tolerances are the reference tests': 2e-3 at the shapes of
test_flash_attention_grad_parity and
test_flash_attention_mismatched_block_sizes (float32, summation order
and the online softmax), 2e-4 at the shape of
test_windowed_flash_matches_xla_fwd_and_grads."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from containerpilot_tpu.ops.flash import flash_attention as jax_flash
from containerpilot_tpu_torch.ops import flash


def _inputs(seed, shape):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape, dtype=np.float32) for _ in range(4)]


def _jax_grads(q, k, v, cot, block_q, block_k, window):
    with jax.default_matmul_precision("float32"):
        return jax.grad(
            lambda q, k, v: jnp.sum(
                jax_flash(q, k, v, block_q, block_k, window=window) * cot
            ),
            argnums=(0, 1, 2),
        )(*(jnp.asarray(a) for a in (q, k, v)))


def _port_grads(q, k, v, cot, block_q, block_k, window):
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = flash.flash_attention(tq, tk, tv, block_q, block_k, window=window)
    (out * torch.from_numpy(cot)).sum().backward()
    return out, (tq.grad, tk.grad, tv.grad)


@pytest.mark.parametrize("shape,block_q,block_k,window,tol", [
    ((2, 256, 2, 64), 64, 64, 0, 2e-3),     # test_flash_attention_grad_parity
    ((1, 256, 2, 64), 128, 64, 0, 2e-3),    # ..._mismatched_block_sizes
    ((1, 256, 2, 64), 64, 128, 0, 2e-3),
    ((2, 512, 4, 64), 128, 64, 128, 2e-4),  # test_windowed_flash_matches_xla
])
def test_flash_grads_match_jax_pallas(shape, block_q, block_k, window, tol):
    q, k, v, cot = _inputs(3, shape)
    ref = _jax_grads(q, k, v, cot, block_q, block_k, window)
    _out, got = _port_grads(q, k, v, cot, block_q, block_k, window)
    for name, r, g in zip("qkv", ref, got):
        np.testing.assert_allclose(
            g.numpy(), np.asarray(r), rtol=tol, atol=tol, err_msg=f"d{name}"
        )


def test_backward_is_the_functions_own(monkeypatch):
    """The backward runs the plain versions of K3 and K4 (the kernels'
    stand-ins on the CPU) once each, and autograd never differentiates
    through the forward reference: the output's only graph node is the
    Function's."""
    calls = []
    for name in ("flash_backward_dq_reference", "flash_backward_dkdv_reference"):
        real = getattr(flash, name)
        monkeypatch.setattr(
            flash, name,
            lambda *a, _real=real, _n=name, **kw: calls.append(_n) or _real(*a, **kw),
        )
    q, k, v, cot = _inputs(5, (1, 128, 2, 64))
    out, grads = _port_grads(q, k, v, cot, 128, 128, 0)
    assert type(out.grad_fn).__name__ == "_FlashAttentionBackward"
    assert [type(f).__name__ for f, _ in out.grad_fn.next_functions] == [
        "AccumulateGrad"] * 3
    assert calls == ["flash_backward_dq_reference", "flash_backward_dkdv_reference"]
    assert all(g is not None and torch.isfinite(g).all() for g in grads)


def test_backward_reference_equals_the_two_kernel_halves_and_jax_delta():
    """flash_attention_backward_reference = K3's plain version + K4's, and
    D = rowsum(dO * O) comes out in the reference's rows layout."""
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(6, (2, 128, 2, 64)))
    out, lse = flash.flash_attention_forward_with_lse(q, k, v, window=64)
    delta = flash.attention_delta(out, do)
    assert delta.shape == (4, 128, 1)
    ref_delta = (do * out).sum(-1).permute(0, 2, 1).reshape(4, 128, 1)
    torch.testing.assert_close(delta, ref_delta)
    dq, dk, dv = flash.flash_attention_backward_reference(q, k, v, out, lse, do, 64)
    assert torch.equal(dq, flash.flash_backward_dq(q, k, v, do, lse, delta, 64))
    dk2, dv2 = flash.flash_backward_dkdv(q, k, v, do, lse, delta, 64)
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2)


def test_flash_attention_refuses_gqa_kv_and_ragged_seq():
    q = torch.zeros((1, 128, 4, 64))
    kv = torch.zeros((1, 128, 2, 64))
    with pytest.raises(ValueError, match="full-head k/v"):
        flash.flash_attention(q, kv, kv)
    with pytest.raises(ValueError, match="not a multiple"):
        flash.flash_attention(q[:, :100], q[:, :100], q[:, :100])


class _OnCard(torch.Tensor):
    """A CPU tensor that reports ``is_cuda``: reaches the CUDA branch of
    the wrappers without a card."""

    @property
    def is_cuda(self):
        return True


def test_forward_only_kernel_refuses_inputs_that_require_grad(monkeypatch):
    """On the card, flash_attention_forward writes its output through
    ctypes: under recording autograd, with an input that requires grad,
    it must raise (the result would silently drop the attention
    gradient). Without grad it goes on to the kernel launch."""
    launched = []
    monkeypatch.setattr(
        flash, "_launch",
        lambda q, k, v, window: launched.append(window) or (q, None),
    )
    q, k, v = (
        torch.zeros((1, 128, 2, 64), dtype=torch.bfloat16).as_subclass(_OnCard)
        for _ in range(3)
    )
    assert q.is_cuda
    q.requires_grad_(True)
    for fn in (flash.flash_attention_forward, flash.flash_attention_forward_with_lse):
        with pytest.raises(RuntimeError, match="call flash_attention"):
            fn(q, k, v)
    assert launched == []
    with torch.no_grad():
        flash.flash_attention_forward(q, k, v)
    with torch.inference_mode():
        flash.flash_attention_forward(q.detach(), k, v)
    flash.flash_attention_forward(q.detach(), k, v)  # nothing requires grad
    assert launched == [0, 0, 0]
