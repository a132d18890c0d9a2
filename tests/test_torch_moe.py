"""The port's switch-routed mixture of experts against the JAX reference,
on the CPU: ``_route``, ``moe_layer`` and ``moe_layer_capacity`` on the
same numpy inputs (routes and one-hots equal, values within 1e-5 in
float32 and 2e-2 in bf16, gradients against ``jax.grad`` at GRAD_TOL),
and mirrors of the reference MoE tests of ``tests/test_workload.py``
held to their numbers. ``tests/test_torch_moe_model.py`` holds the
whole model and its serving paths."""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from containerpilot_tpu.models import moe as jmoe
from containerpilot_tpu.models import quantized as jquant
from containerpilot_tpu.models import transformer as jtf
from containerpilot_tpu_torch import bridge
from containerpilot_tpu_torch.models import decode as tdecode
from containerpilot_tpu_torch.models import moe as tmoe
from containerpilot_tpu_torch.models import quantized as tquant
from containerpilot_tpu_torch.models import transformer as ttf
from containerpilot_tpu_torch.parallel import train as ttrain

LAYER_TOL = 1e-5      # float32: summation order only
BF16_TOL = 2e-2       # bf16 products rounded in another order
GRAD_TOL = 1e-4       # tests/test_torch_train.py's
LOGIT_TOL = 1e-4      # tests/test_torch_model.py's
DECODE_TOL = 2e-4     # tests/test_workload.py::test_moe_decode_parity's

# tests/test_workload.py's MoE configs
MOE = dict(vocab_size=64, d_model=32, n_heads=2, n_layers=1, d_ff=64,
           max_seq_len=32, moe_experts=2, dtype="float32")
MOE2 = dict(vocab_size=128, d_model=64, n_heads=4, n_layers=2, d_ff=128,
            max_seq_len=64, moe_experts=2, dtype="float32")


def configs(base, **over):
    d = {**base, **over}
    jcfg = jtf.TransformerConfig(**{**d, "dtype": jnp.dtype(d["dtype"])})
    return jcfg, ttf.TransformerConfig(**bridge.config_kwargs(d))


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def bridged(jparams):
    return bridge.params_from_jax(to_np(jparams), "cpu")


def tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def close(got, want, tol, msg=""):
    """Within tol of the reference, relative to its largest entry."""
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{msg}: {err} > {tol} x {scale}"


def layer_inputs(seed, b=2, s=16, d=32, f=64, E=4):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, d)).astype(np.float32),
            rng.standard_normal((d, E)).astype(np.float32),
            (rng.standard_normal((E, d, f)) / math.sqrt(d)).astype(np.float32),
            (rng.standard_normal((E, f, d)) / math.sqrt(f)).astype(np.float32))


def as_dtype(arrays, dtype):
    """(jax arrays, torch tensors): x and the expert weights in dtype,
    the router float32 (the model keeps it so)."""
    jt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    tt = torch.bfloat16 if dtype == "bf16" else torch.float32
    js = [jnp.asarray(a).astype(jt if i != 1 else jnp.float32)
          for i, a in enumerate(arrays)]
    ts = [torch.from_numpy(a).to(tt if i != 1 else torch.float32)
          for i, a in enumerate(arrays)]
    return js, ts


def dropped_rows(out):
    if isinstance(out, torch.Tensor):
        out = out.float().numpy()
    return np.all(np.asarray(out, np.float32) == 0.0, axis=-1)


# -- the layers --------------------------------------------------------------


@pytest.mark.parametrize("E", [2, 4, 8])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_route_matches_reference(seed, E):
    """Routes first (so a failure names a route), then one-hots, probs,
    gate and aux."""
    x, router, _wi, _wo = layer_inputs(seed, E=E)
    jp, jg, jo, ja = jmoe._route(jnp.asarray(x), jnp.asarray(router))
    tp, tg, to, ta = tmoe._route(torch.from_numpy(x), torch.from_numpy(router))
    np.testing.assert_array_equal(torch.argmax(tp, -1).numpy(),
                                  np.asarray(jnp.argmax(jp, -1)))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    for got, want, what in ((tp, jp, "probs"), (tg, jg, "gate"),
                            (ta, ja, "aux")):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=LAYER_TOL, atol=LAYER_TOL,
                                   err_msg=what)


def test_route_ties_take_the_first_expert():
    """Equal router columns: every token goes to expert 0 in both
    packages, with the max prob as its gate."""
    x, router, _wi, _wo = layer_inputs(0, E=4)
    router[:] = router[:, :1]
    _p, jg, jo, _a = jmoe._route(jnp.asarray(x), jnp.asarray(router))
    _p, tg, to, _a = tmoe._route(torch.from_numpy(x), torch.from_numpy(router))
    assert to[..., 0].all() and not to[..., 1:].any()
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=LAYER_TOL)


def _layer_grads(fn_j, fn_t, js, ts, seed):
    """Gradients of sum(out * cot) + 3 aux with respect to x, router,
    w_in and w_out in both packages (float32)."""
    cot = np.random.default_rng(seed + 100).standard_normal(
        js[0].shape).astype(np.float32)

    def jloss(*args):
        out, aux = fn_j(*args)
        return jnp.sum(out * cot) + 3.0 * aux

    with jax.default_matmul_precision("float32"):
        jgrads = jax.grad(jloss, argnums=(0, 1, 2, 3))(*js)
    leaves = [t.clone().requires_grad_(True) for t in ts]
    out, aux = fn_t(*leaves)
    tgrads = torch.autograd.grad(
        (out * torch.from_numpy(cot)).sum() + 3.0 * aux, leaves)
    for got, want, name in zip(tgrads, jgrads,
                               ("x", "router", "w_in", "w_out")):
        close(got, want, GRAD_TOL, f"grad {name}")


@pytest.mark.parametrize("dtype", ["float32", "bf16"])
def test_moe_layer_matches_reference(dtype):
    arrays = layer_inputs(3, E=4)
    js, ts = as_dtype(arrays, dtype)
    with jax.default_matmul_precision("float32"):
        jout, jaux = jmoe.moe_layer(*js)
    tout, taux = tmoe.moe_layer(*ts)
    assert tout.dtype == ts[0].dtype and tout.shape == ts[0].shape
    tol = BF16_TOL if dtype == "bf16" else LAYER_TOL
    close(tout, jout, tol, "out")
    np.testing.assert_allclose(taux.item(), float(jaux), rtol=LAYER_TOL)
    if dtype == "float32":
        _layer_grads(jmoe.moe_layer, tmoe.moe_layer, js, ts, 3)


@pytest.mark.parametrize("dtype", ["float32", "bf16"])
@pytest.mark.parametrize("factor", [0.5, 1.0, 8.0])
def test_moe_layer_capacity_matches_reference(factor, dtype):
    """Output and aux, the keep pattern (a dropped token's output row is
    exactly 0 in both, and those rows are the ones whose queue position
    reaches the capacity), and the gradients in float32."""
    arrays = layer_inputs(4, s=32, E=4)
    js, ts = as_dtype(arrays, dtype)

    def jfn(*a):
        return jmoe.moe_layer_capacity(*a, factor)

    def tfn(*a):
        return tmoe.moe_layer_capacity(*a, factor)

    with jax.default_matmul_precision("float32"):
        jout, jaux = jfn(*js)
    tout, taux = tfn(*ts)
    tol = BF16_TOL if dtype == "bf16" else LAYER_TOL
    close(tout, jout, tol, "out")
    np.testing.assert_allclose(taux.item(), float(jaux), rtol=LAYER_TOL)
    onehot = tmoe._route(ts[0], ts[1])[2].numpy()
    pos = ((np.cumsum(onehot, axis=1) - 1) * onehot).sum(-1)
    capacity = max(1, math.ceil(factor * 32 / 4))
    want_dropped = pos >= capacity
    np.testing.assert_array_equal(dropped_rows(tout), want_dropped)
    np.testing.assert_array_equal(dropped_rows(jout), want_dropped)
    if factor == 0.5:
        assert want_dropped.any()
    if factor == 8.0:
        assert not want_dropped.any()
    if dtype == "float32":
        _layer_grads(jfn, tfn, js, ts, 4)


# -- mirrors of tests/test_workload.py's MoE tests ---------------------------


def test_moe_forward_and_training():
    """tests/test_workload.py:1534 on the port (its expert-sharding
    assertion belongs to the multi-device slice): finite forward, live
    aux loss, loss drops under training."""
    cfg = ttf.TransformerConfig(vocab_size=128, d_model=64, n_heads=4,
                                n_layers=2, d_ff=128, max_seq_len=64,
                                moe_experts=4)
    params = ttf.init_params(0, cfg, device="cpu")
    layers = params["layers"]
    assert "moe_w_in" in layers and "w_gate" not in layers
    assert layers["router"].shape == (2, 64, 4)
    assert layers["moe_w_in"].shape == (2, 4, 64, 128)
    assert layers["moe_w_out"].shape == (2, 4, 128, 64)
    params = tquant.cast_params(params, cfg.dtype)
    assert params["layers"]["router"].dtype == torch.float32
    assert params["layers"]["moe_w_in"].dtype == torch.bfloat16
    toks = torch.from_numpy(tokens(1, (2, 16), 128)).long()
    with torch.no_grad():
        logits, aux = ttf.forward_with_aux(params, toks, cfg)
    assert logits.shape == (2, 16, 128) and torch.isfinite(logits).all()
    assert float(aux) > 0.0

    state = ttrain.init_train_state(0, cfg, device="cpu",
                                    learning_rate=1e-2)
    step = ttrain.make_train_step(cfg, learning_rate=1e-2)
    batch = torch.from_numpy(tokens(2, (4, 33), 128)).long()
    losses = []
    for _ in range(6):
        state, loss = step(state, batch)
        losses.append(float(loss))
    assert losses[-1] < losses[0], losses


@pytest.mark.parametrize("seed", [1, 7, 23])
def test_moe_decode_parity(seed):
    """tests/test_workload.py:1571: incremental decode equals the full
    forward for every prompt (drop-free routing), at 2e-4."""
    jcfg, cfg = configs(MOE)
    params = bridged(jtf.init_params(jax.random.PRNGKey(0), jcfg))
    toks = torch.from_numpy(tokens(seed, (1, 8), 64)).long()
    with torch.no_grad():
        full = ttf.forward(params, toks, cfg)
        logits, cache = tdecode.prefill(params, toks[:, :4], cfg, 16)
        close(logits, full[:, 3], DECODE_TOL, f"seed {seed} prefill")
        for i in range(4, 8):
            logits, cache = tdecode.decode_step(params, cache, toks[:, i],
                                                cfg)
            close(logits, full[:, i], DECODE_TOL, f"seed {seed} pos {i}")


def test_int8_moe_quantization():
    """tests/test_workload.py:2187: the expert weights quantize (leaves
    equal JAX's exactly), and the quantized model stays within 8% of
    the float one; K2 is refused for an MoE tree at every row count, as
    the reference refuses it, so a layer dequantizes in full."""
    jcfg, cfg = configs(MOE)
    jp = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    jq = jquant.quantize_model_params(jp)
    tq = tquant.quantize_model_params(bridged(jp))
    ref = bridged(jq)
    assert "moe_w_in_q" in tq["layers"] and "router" in tq["layers"]
    assert set(tq["layers"]) == set(ref["layers"])
    for key, leaf in ref["layers"].items():
        assert torch.equal(tq["layers"][key], leaf), key
    for key in ("embed_q", "embed_s", "unembed_q", "unembed_s"):
        assert torch.equal(tq[key], ref[key]), key
    toks = torch.from_numpy(tokens(1, (1, 8), 64)).long()
    with torch.no_grad():
        full = ttf.forward(bridged(jp), toks, cfg)
        quant = ttf.forward(tq, toks, cfg)
    rel = float((full - quant).abs().max() / full.abs().max())
    assert rel < 0.08, rel
    for rows in (1, 8, 64, 256, 10_000):
        assert not tquant.can_fuse_int8(tq["layers"], cfg, rows=rows)
        assert not jquant.can_fuse_int8(jq["layers"], jcfg, rows=rows)


def test_moe_capacity_training_mode():
    """tests/test_workload.py:2207: ample capacity equals drop-free
    routing, tight capacity drops tokens, the capacity model trains, and
    prefill refuses it with the reference's message."""
    _jcfg, base = configs(MOE2)
    params = ttf.init_params(0, base, device="cpu")
    toks = torch.from_numpy(tokens(1, (2, 16), 128)).long()
    with torch.no_grad():
        free = ttf.forward(params, toks, base)
        ample = ttf.forward(
            params, toks, dataclasses.replace(base, moe_train_capacity=8.0))
        tight = dataclasses.replace(base, moe_train_capacity=0.5)
        squeezed = ttf.forward(params, toks, tight)
    np.testing.assert_allclose(free.numpy(), ample.numpy(), rtol=1e-4,
                               atol=1e-4)
    assert float((free - squeezed).abs().max()) > 1e-3

    state = ttrain.init_train_state(0, tight, device="cpu",
                                    learning_rate=1e-2)
    step = ttrain.make_train_step(tight, learning_rate=1e-2)
    batch = torch.from_numpy(tokens(2, (4, 33), 128)).long()
    losses = []
    for _ in range(5):
        state, loss = step(state, batch)
        losses.append(float(loss))
    assert losses[-1] < losses[0], losses

    with pytest.raises(ValueError, match="moe_train_capacity"):
        tdecode.prefill(params, toks[:, :8], tight, 32)


def test_moe_capacity_requires_experts():
    """tests/test_workload.py:2252."""
    with pytest.raises(ValueError, match="requires moe_experts"):
        ttf.TransformerConfig(moe_train_capacity=1.0)


def test_moe_sparse_dispatch_flops_scale_with_capacity():
    """tests/test_workload.py:2257 with torch's FlopCounterMode in place
    of XLA's cost analysis: the capacity layer's products scale with the
    capacity bound, not with E x s."""
    b, s, d, f, E = 2, 256, 64, 128, 8
    x, router, w_in, w_out = (torch.from_numpy(a) for a in
                              layer_inputs(0, b=b, s=s, d=d, f=f, E=E))

    def flops(fn):
        with FlopCounterMode(display=False) as counter:
            fn()
        return counter.get_total_flops()

    dense = flops(lambda: tmoe.moe_layer(x, router, w_in, w_out))
    tight = flops(lambda: tmoe.moe_layer_capacity(x, router, w_in, w_out,
                                                  1.0))
    double = flops(lambda: tmoe.moe_layer_capacity(x, router, w_in, w_out,
                                                   2.0))
    assert tight < dense / 3, (tight, dense)
    assert tight < double, (tight, double)


def test_chunked_loss_matches_with_moe_aux():
    """tests/test_workload.py:3496: the chunked loss adds the same aux."""
    jcfg, base = configs(MOE)
    params = bridged(jtf.init_params(jax.random.PRNGKey(0), jcfg))
    toks = torch.from_numpy(tokens(2, (2, 13), 64)).long()
    with torch.no_grad():
        whole = float(ttf.loss_fn(params, toks, base))
        got = float(ttf.loss_fn(params, toks,
                                dataclasses.replace(base, loss_chunk=4)))
    np.testing.assert_allclose(got, whole, rtol=1e-6)
