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


def _on_card(shape, dtype=torch.bfloat16, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=gen).to(dtype).as_subclass(_OnCard)


def _bwd_inputs(shape=(2, 128, 3, 64), kv_heads=None, dtype=torch.bfloat16):
    b, s, h, hd = shape
    kv_shape = (b, s, kv_heads or h, hd)
    q, do = _on_card(shape, dtype, 1), _on_card(shape, dtype, 2)
    k, v = _on_card(kv_shape, dtype, 3), _on_card(kv_shape, dtype, 4)
    lse = torch.zeros((b * h, s, 1), dtype=torch.float32)
    delta = torch.zeros((b * h, s, 1), dtype=torch.float32)
    return q, k, v, do, lse, delta


@pytest.mark.parametrize("fn,name,n_out", [
    ("flash_backward_dq", "flash_bwd_dq", 1),
    ("flash_backward_dkdv", "flash_bwd_dkdv", 2),
])
@pytest.mark.parametrize("window,passed", [(0, 0), (64, 64), (-3, 0)])
def test_bwd_wrappers_hand_the_c_entry_its_arguments(monkeypatch, fn, name,
                                                     n_out, window, passed):
    """On a card tensor the wrappers validate, allocate the outputs like
    q/k/v and call the C entry through _launch_bwd with the inputs in the
    entry's order, (b, s, h, hd), the window (negative means none) and
    head_dim; each launch adds one to the kernel's count."""
    calls = []
    monkeypatch.setattr(flash, "_launch_bwd", lambda *a: calls.append(a))
    args = _bwd_inputs()
    counter = "DQ_LAUNCHES" if n_out == 1 else "DKDV_LAUNCHES"
    before = getattr(flash, counter)
    out = getattr(flash, fn)(*args, window=window)
    assert getattr(flash, counter) == before + 1
    (got_name, inputs, outputs, dims, got_window, hd, dev), = calls
    assert (got_name, dims, got_window, hd) == (name, (2, 128, 3, 64), passed, 64)
    assert dev == args[0].device
    assert all(a is b for a, b in zip(inputs, args)) and len(inputs) == 6
    outs = (out,) if n_out == 1 else out
    assert len(outputs) == n_out and all(a is b for a, b in zip(outputs, outs))
    for o, like in zip(outs, (args[0],) if n_out == 1 else args[1:3]):
        assert o.shape == like.shape and o.dtype == torch.bfloat16
        assert o.is_contiguous() and o.data_ptr() != like.data_ptr()
    if n_out == 2:
        assert outs[0].data_ptr() != outs[1].data_ptr()


class _FakeEntry:
    """Stands in for a library's C entry: records its argtypes and call."""

    def __init__(self):
        self.args = None

    def __call__(self, *args):
        self.args = args
        return 0


@pytest.mark.parametrize("name,n_out", [("flash_bwd_dq", 1), ("flash_bwd_dkdv", 2)])
def test_launch_bwd_calls_the_entry_in_its_c_order(monkeypatch, name, n_out):
    """_launch_bwd passes pointers (inputs then outputs), the int dims,
    the window, scale = hd^-0.5 as a float and the current stream, with
    ctypes types that match the C signature, then checks the error."""
    import ctypes
    import contextlib
    from containerpilot_tpu_torch.ops import _build

    entry = _FakeEntry()
    lib = type("Lib", (), {f"{name}_bf16": entry})()
    checked = []
    monkeypatch.setattr(_build, "load", lambda n: lib if n == name else None)
    monkeypatch.setattr(_build, "check", lambda l, n, err: checked.append((n, err)))
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(
        torch.cuda, "current_stream",
        lambda dev=None: type("S", (), {"cuda_stream": 4242})())
    q, k, v, do, lse, delta = _bwd_inputs((1, 64, 2, 128))
    outs = tuple(torch.empty_like(q) for _ in range(n_out))
    flash._launch_bwd(name, (q, k, v, do, lse, delta), outs, (1, 64, 2, 128),
                      32, 128, q.device)
    n_ptr = 6 + n_out
    assert entry.argtypes == ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 5
                              + [ctypes.c_float, ctypes.c_void_p])
    assert entry.restype is ctypes.c_int
    ptrs = [t.data_ptr() for t in (q, k, v, do, lse, delta, *outs)]
    assert list(entry.args[:n_ptr]) == ptrs
    assert entry.args[n_ptr:n_ptr + 5] == (1, 64, 2, 128, 32)
    assert entry.args[n_ptr + 5] == pytest.approx(128 ** -0.5)
    assert entry.args[n_ptr + 6] == 4242
    assert checked == [(name, 0)]


@pytest.mark.parametrize("fn", ["flash_backward_dq", "flash_backward_dkdv"])
@pytest.mark.parametrize("make,error,match", [
    (lambda: _bwd_inputs((1, 96, 2, 64)), ValueError, "seq % 64"),
    (lambda: _bwd_inputs((1, 128, 2, 32)), ValueError, "head_dim in"),
    (lambda: _bwd_inputs((1, 128, 2, 96)), ValueError, "head_dim in"),
    (lambda: _bwd_inputs(dtype=torch.float32), TypeError, "takes bfloat16"),
    (lambda: _bwd_inputs(dtype=torch.float16), TypeError, "takes bfloat16"),
    (lambda: _bwd_inputs((1, 128, 4, 64), kv_heads=2), ValueError, "full-head"),
])
def test_bwd_wrappers_refuse_what_the_kernels_do_not_take(monkeypatch, fn, make,
                                                          error, match):
    """Ragged seq, head_dim outside {64, 128}, non-bf16 inputs and grouped
    (GQA) k/v raise before any launch."""
    calls = []
    monkeypatch.setattr(flash, "_launch_bwd", lambda *a: calls.append(a))
    with pytest.raises(error, match=match):
        getattr(flash, fn)(*make())
    assert calls == []


@pytest.mark.parametrize("fn", ["flash_backward_dq", "flash_backward_dkdv"])
@pytest.mark.parametrize("which", [4, 5])
def test_bwd_wrappers_refuse_misaligned_or_wrong_rows(monkeypatch, fn, which):
    """lse and D must be contiguous float32 rows of the right size whose
    start is 16-byte aligned (K4 bulk-copies them): a view one value into
    its storage, a float16 copy and a short tensor all raise."""
    calls = []
    monkeypatch.setattr(flash, "_launch_bwd", lambda *a: calls.append(a))
    args = list(_bwd_inputs())
    good = args[which]
    bad_rows = [
        torch.zeros(good.numel() + 1)[1:].reshape(good.shape),
        good.to(torch.float16),
        good[:, :64],
    ]
    for bad in bad_rows:
        args[which] = bad
        with pytest.raises(ValueError, match="16-byte aligned float32"):
            getattr(flash, fn)(*args)
    assert calls == []
