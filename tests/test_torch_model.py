"""The port's transformer, decode and int8 model against the JAX
reference on bridged params (JAX initializes, ``bridge.params_from_jax``
carries the same weights over). Everything runs in float32 on the CPU;
logits must agree within 1e-4 (summation order only) and greedy tokens
exactly."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from containerpilot_tpu.models import decode as jdecode
from containerpilot_tpu.models import quantized as jquant
from containerpilot_tpu.models import transformer as jtf
from containerpilot_tpu_torch import bridge
from containerpilot_tpu_torch.models import decode as tdecode
from containerpilot_tpu_torch.models import quantized as tquant
from containerpilot_tpu_torch.models import transformer as ttf

LOGIT_TOL = 1e-4

# tests/test_workload.py's CFG, and its int8-fused config
SMALL = dict(vocab_size=128, d_model=64, n_heads=2, n_layers=2, d_ff=128,
             max_seq_len=64, dtype="float32")
FUSED = dict(vocab_size=256, d_model=128, n_heads=1, n_layers=2, d_ff=128,
             max_seq_len=32, dtype="float32")


def configs(base, **over):
    """(jax cfg, port cfg) from one config dict."""
    d = {**base, **over}
    jcfg = jtf.TransformerConfig(**{**d, "dtype": jnp.dtype(d["dtype"])})
    return jcfg, ttf.TransformerConfig(**bridge.config_kwargs(d))


def bridged(jparams):
    return bridge.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), "cpu"
    )


def tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def close(a, b, tol=LOGIT_TOL, msg=""):
    np.testing.assert_allclose(
        np.asarray(a), np.asarray(b), rtol=tol, atol=tol, err_msg=msg
    )


@pytest.mark.parametrize("over,seq", [
    ({}, 16),
    ({"n_heads": 4, "n_kv_heads": 2}, 16),       # GQA
    ({"flash_min_seq": 128, "max_seq_len": 128}, 128),  # flash path
])
def test_forward_logits_match_jax(over, seq):
    jcfg, tcfg = configs(SMALL, **over)
    jp = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    toks = tokens(1, (2, seq), jcfg.vocab_size)
    ref = jtf.forward(jp, jnp.asarray(toks), jcfg)
    out = ttf.forward(bridged(jp), torch.from_numpy(toks).long(), tcfg)
    assert out.shape == (2, seq, jcfg.vocab_size) and out.dtype == torch.float32
    close(out.numpy(), ref)


def test_causality():
    """tests/test_workload.py::test_causality on the port."""
    jcfg, tcfg = configs(SMALL)
    params = bridged(jtf.init_params(jax.random.PRNGKey(0), jcfg))
    t1 = torch.from_numpy(tokens(1, (1, 16), 128)).long()
    t2 = t1.clone()
    t2[0, 10:] = (t1[0, 10:] + 1) % 128
    l1 = ttf.forward(params, t1, tcfg)
    l2 = ttf.forward(params, t2, tcfg)
    np.testing.assert_allclose(
        l1[0, :10].numpy(), l2[0, :10].numpy(), rtol=1e-4, atol=1e-4
    )


@pytest.mark.parametrize("over", [{}, {"n_heads": 4, "n_kv_heads": 2}])
def test_prefill_and_decode_steps_match_jax(over):
    jcfg, tcfg = configs(SMALL, **over)
    jp = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    tp = bridged(jp)
    prompt = tokens(2, (2, 8), jcfg.vocab_size)
    jl, jc = jdecode.prefill(jp, jnp.asarray(prompt), jcfg, max_len=32)
    tl, tc = tdecode.prefill(tp, torch.from_numpy(prompt).long(), tcfg, 32)
    close(tl.numpy(), jl, msg="prefill")
    for step in range(8):
        jtok = jnp.argmax(jl, axis=-1).astype(jnp.int32)
        ttok = torch.argmax(tl, dim=-1)
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
        jl, jc = jdecode.decode_step(jp, jc, jtok, jcfg)
        tl, tc = tdecode.decode_step(tp, tc, ttok, tcfg)
        close(tl.numpy(), jl, msg=f"step {step}")
    assert tc["pos"] == int(jc["pos"]) == 16
    close(tc["k"].numpy(), jc["k"])


def test_decode_matches_full_forward():
    """Incremental logits == the port's own full forward per position."""
    _, tcfg = configs(SMALL)
    jcfg, _ = configs(SMALL)
    tp = bridged(jtf.init_params(jax.random.PRNGKey(0), jcfg))
    toks = torch.from_numpy(tokens(3, (2, 12), 128)).long()
    full = ttf.forward(tp, toks, tcfg)
    logits, cache = tdecode.prefill(tp, toks[:, :4], tcfg, max_len=16)
    close(logits.numpy(), full[:, 3].numpy())
    for i in range(4, 12):
        logits, cache = tdecode.decode_step(tp, cache, toks[:, i], tcfg)
        close(logits.numpy(), full[:, i].numpy(), msg=f"position {i}")


def test_quantize_model_params_leaves_equal_jax_exactly():
    jcfg, _ = configs(FUSED)
    jp = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    jq = jquant.quantize_model_params(jp)
    tq = tquant.quantize_model_params(bridged(jp))
    assert tquant.is_quantized(tq) and not tquant.is_quantized(bridged(jp))
    ref = bridged(jq)
    assert set(tq) == set(ref) and set(tq["layers"]) == set(ref["layers"])
    for key in ref:
        if key != "layers":
            assert torch.equal(tq[key], ref[key]), key
    for key in ref["layers"]:
        assert torch.equal(tq["layers"][key], ref["layers"][key]), key
    assert tquant.param_bytes(tq) == jquant.param_bytes(jq)


def test_int8_fused_decode_matches_jax_fused_decode():
    """The fused int8 decode path (the plain version of the int8 kernel
    on CPU) against JAX's fused decode (the Pallas kernel, interpret)."""
    jcfg, tcfg = configs(FUSED)
    jq = jquant.quantize_model_params(
        jtf.init_params(jax.random.PRNGKey(0), jcfg)
    )
    tq = bridged(jq)
    assert tquant.can_fuse_int8(tq["layers"], tcfg, rows=2)
    assert not tquant.can_fuse_int8(tq["layers"], tcfg, rows=10_000)
    toks = tokens(1, (2, 8), jcfg.vocab_size)
    jl, jc = jdecode.prefill(jq, jnp.asarray(toks[:, :4]), jcfg, max_len=16)
    tl, tc = tdecode.prefill(tq, torch.from_numpy(toks[:, :4]).long(), tcfg, 16)
    close(tl.numpy(), jl, msg="prefill")
    for i in range(4, 8):
        jl, jc = jdecode.decode_step(jq, jc, jnp.asarray(toks[:, i]), jcfg)
        tl, tc = tdecode.decode_step(
            tq, tc, torch.from_numpy(toks[:, i]).long(), tcfg
        )
        close(tl.numpy(), jl, msg=f"position {i}")


def test_cast_params_keeps_scales_and_int8():
    jcfg, tcfg = configs(FUSED)
    tq = tquant.quantize_model_params(
        bridged(jtf.init_params(jax.random.PRNGKey(0), jcfg))
    )
    cast = tquant.cast_params(tq, torch.bfloat16)
    assert cast["layers"]["wq_q"].dtype == torch.int8
    assert cast["layers"]["wq_s"].dtype == torch.float32
    assert cast["layers"]["norm_attn"].dtype == torch.bfloat16
    assert cast["unembed_s"].dtype == torch.float32
