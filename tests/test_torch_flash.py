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
        (1, 256, 2, 2, 128, 128, 128, 0),    # head_dim 128, the kernel's main one
        (1, 256, 4, 1, 128, 64, 64, 0),      # head_dim 128, GQA group 4
        # window 64 with 64-blocks: the last row of each q block sees
        # none of its first visited kv block (fully masked there)
        (2, 256, 2, 2, 64, 64, 64, 64),
        (1, 256, 2, 1, 128, 64, 64, 64),     # the same at head_dim 128, GQA
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


@pytest.mark.parametrize("window", [0, 64])
def test_flash_lse_matches_jax_at_head_dim_128_and_masked_first_tile(window):
    """lse (which K3 and K4 consume) equals the Pallas kernel's at
    head_dim 128, GQA, and with window 64 on 64-blocks, where a row's
    first visited kv block is fully masked."""
    b, s, h, kv, hd = 1, 256, 4, 2, 128
    q, k, v = _inputs(4, b, s, h, hd, kv)
    _out, lse = flash_attention_forward_with_lse(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        block_q=64, block_k=64, window=window,
    )
    _out_rows, jax_lse = _fwd_rows(
        _to_rows(jnp.asarray(q)), _to_rows(jnp.asarray(k)),
        _to_rows(jnp.asarray(v)), 64, 64, True, window=window,
    )
    assert np.isfinite(lse.numpy()).all()
    np.testing.assert_allclose(
        lse.numpy(), np.asarray(jax_lse), rtol=TOL, atol=TOL
    )


# ---------------------------------------------------------------------------
# the CUDA branch of the wrapper, reached without a card
# ---------------------------------------------------------------------------


class _OnCard(torch.Tensor):
    """A CPU tensor that reports ``is_cuda``: reaches the CUDA branch of
    the wrapper without a card."""

    @property
    def is_cuda(self):
        return True


class _FakeEntry:
    """Stands in for the library's C entry: records its argtypes and call."""

    def __init__(self, err=0):
        self.args = None
        self.err = err

    def __call__(self, *args):
        self.args = args
        return self.err


def _on_card(shape, dtype=torch.bfloat16, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=gen).to(dtype).as_subclass(_OnCard)


def _card_inputs(shape=(2, 128, 4, 64), kv_heads=2, dtype=torch.bfloat16):
    b, s, _h, hd = shape
    return (_on_card(shape, dtype, 1), _on_card((b, s, kv_heads, hd), dtype, 2),
            _on_card((b, s, kv_heads, hd), dtype, 3))


def _fake_library(monkeypatch, entry):
    import contextlib

    from containerpilot_tpu_torch.ops import _build
    from containerpilot_tpu_torch.ops import flash as flash_mod

    lib = type("Lib", (), {"flash_fwd_bf16": entry})()
    checked = []
    monkeypatch.setattr(_build, "load", lambda n: lib if n == "flash_fwd" else None)
    monkeypatch.setattr(_build, "check", lambda l, n, err: checked.append((n, err)))
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(
        torch.cuda, "current_stream",
        lambda dev=None: type("S", (), {"cuda_stream": 4242})())
    return flash_mod, checked


@pytest.mark.parametrize("window,passed", [(0, 0), (64, 64), (-3, 0)])
@pytest.mark.parametrize("shape,kv_heads", [
    ((2, 128, 4, 64), 2),    # GQA, head_dim 64
    ((1, 64, 2, 128), 2),    # full heads, head_dim 128
])
def test_launch_calls_the_entry_in_its_c_order(monkeypatch, window, passed,
                                               shape, kv_heads):
    """On a card tensor, flash_attention_forward_with_lse reaches _launch,
    which hands flash_fwd_bf16 the pointers (q, k, v, out, lse), then
    (B, S, H, KVH, HD, window) as ints (a negative window means none),
    scale = hd^-0.5 as a float and the current stream, with ctypes types
    that match the C signature; it checks the returned error and adds one
    to LAUNCHES. out is a fresh tensor like q, lse float32 [B*H, S, 1]."""
    import ctypes

    entry = _FakeEntry()
    flash_mod, checked = _fake_library(monkeypatch, entry)
    q, k, v = _card_inputs(shape, kv_heads)
    before = flash_mod.LAUNCHES
    with torch.no_grad():
        out, lse = flash_attention_forward_with_lse(
            q, k, v, block_q=64, block_k=64, window=window)
    assert flash_mod.LAUNCHES == before + 1
    assert entry.argtypes == ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                              + [ctypes.c_float, ctypes.c_void_p])
    assert entry.restype is ctypes.c_int
    b, s, h, hd = shape
    assert list(entry.args[:5]) == [
        t.data_ptr() for t in (q, k, v, out, lse)]
    assert entry.args[5:11] == (b, s, h, kv_heads, hd, passed)
    assert entry.args[11] == pytest.approx(hd ** -0.5)
    assert entry.args[12] == 4242
    assert checked == [("flash_fwd", 0)]
    assert out.shape == q.shape and out.dtype == torch.bfloat16
    assert out.is_contiguous() and out.data_ptr() != q.data_ptr()
    assert lse.shape == (b * h, s, 1) and lse.dtype == torch.float32


def test_launch_raises_on_the_entrys_error_before_counting(monkeypatch):
    """A nonzero cudaError_t from the entry goes to _build.check, which
    raises; the launch is not counted and nothing falls back."""
    from containerpilot_tpu_torch.ops import _build

    flash_mod, _checked = _fake_library(monkeypatch, _FakeEntry(err=1))

    def check(lib, name, err):
        if err:
            raise RuntimeError(f"{name} launch failed: CUDA error {err}")

    monkeypatch.setattr(_build, "check", check)
    before = flash_mod.LAUNCHES
    with pytest.raises(RuntimeError, match="flash_fwd launch failed"):
        flash_attention_forward(*_card_inputs())
    assert flash_mod.LAUNCHES == before


def _misaligned(shape):
    """A contiguous bf16 view that starts one value (2 bytes) into its
    storage, so its data pointer is not 16-byte aligned."""
    n = int(np.prod(shape))
    return torch.zeros(n + 1, dtype=torch.bfloat16)[1:].reshape(shape).as_subclass(
        _OnCard)


@pytest.mark.parametrize("make,error,match", [
    # seq 96 divides the blocks (32) but not the kernel's 64-tile
    (lambda: _card_inputs((1, 96, 2, 64)), ValueError, "seq % 64"),
    (lambda: _card_inputs((1, 128, 2, 32)), ValueError, "head_dim in"),
    (lambda: _card_inputs((1, 128, 2, 96)), ValueError, "head_dim in"),
    (lambda: _card_inputs(dtype=torch.float32), TypeError, "takes bfloat16"),
    (lambda: _card_inputs(dtype=torch.float16), TypeError, "takes bfloat16"),
    (lambda: (_misaligned((1, 128, 2, 64)), *_card_inputs((1, 128, 2, 64))[1:]),
     ValueError, "16-byte aligned"),
    (lambda: (_card_inputs((1, 128, 2, 64))[0], _misaligned((1, 128, 2, 64)),
              _card_inputs((1, 128, 2, 64))[2]), ValueError, "16-byte aligned"),
    (lambda: (*_card_inputs((1, 128, 2, 64))[:2],
              _card_inputs((1, 128, 2, 64))[2].transpose(1, 2).contiguous()
              .transpose(1, 2)), ValueError, "contiguous"),
])
def test_forward_refuses_what_the_kernel_does_not_take(monkeypatch, make, error,
                                                       match):
    """On a card tensor, a seq that is not a multiple of 64, head_dim
    outside {64, 128}, non-bf16 inputs and misaligned or non-contiguous
    inputs raise before any launch: nothing reaches the C entry and no
    plain version runs in the kernel's place."""
    entry = _FakeEntry()
    flash_mod, _checked = _fake_library(monkeypatch, entry)
    monkeypatch.setattr(
        flash_mod, "flash_attention_forward_reference",
        lambda *a, **kw: pytest.fail("the plain version ran on a card tensor"))
    before = flash_mod.LAUNCHES
    with pytest.raises(error, match=match):
        flash_attention_forward(*make(), block_q=32, block_k=32)
    assert entry.args is None and flash_mod.LAUNCHES == before
