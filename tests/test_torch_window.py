"""The port's sliding-window ring cache and int8 KV cache
(models/decode.py) against the JAX reference on bridged params, in
float32 on the CPU: prefill, decode_chunk and decode_step logits within
the reference tests' 2e-3 (tests/test_window.py:127-153), across ring
wraps, dense and GQA, and the kv_int8 matrix of
tests/test_workload.py:2825 (dense, GQA, windowed); greedy tokens
exactly; the cache layouts; the overflow rules of a truncated and a full
ring (tests/test_window.py:266, 290); chunked prefill against prefill
with pieces capped at the ring."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from containerpilot_tpu.models import decode as jdecode
from containerpilot_tpu.models import transformer as jtf
from containerpilot_tpu_torch import bridge
from containerpilot_tpu_torch.models import decode as tdecode
from containerpilot_tpu_torch.models import transformer as ttf

TOL = 2e-3  # tests/test_window.py's decode-vs-forward tolerance

# tests/test_window.py's _cfg at n_layers 2
BASE = dict(vocab_size=128, d_model=64, n_heads=4, n_layers=2, d_ff=128,
            max_seq_len=256, dtype="float32", flash_min_seq=0)

CASES = {
    "window": {"window": 8},
    "window_gqa": {"window": 8, "n_kv_heads": 2},
    "int8": {"kv_int8": True},
    "int8_gqa": {"kv_int8": True, "n_kv_heads": 2},
    "int8_window": {"kv_int8": True, "window": 8},
}


def configs(**over):
    d = {**BASE, **over}
    jcfg = jtf.TransformerConfig(**{**d, "dtype": jnp.float32})
    return jcfg, ttf.TransformerConfig(**bridge.config_kwargs(d))


def model(**over):
    jcfg, tcfg = configs(**over)
    jp = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    tp = bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                "cpu")
    return jcfg, tcfg, jp, tp


def tokens(seed, shape):
    return np.random.default_rng(seed).integers(
        0, BASE["vocab_size"], shape).astype(np.int32)


def close(port, ref, msg=""):
    np.testing.assert_allclose(
        port.detach().numpy(), np.asarray(ref), rtol=TOL, atol=TOL,
        err_msg=msg,
    )


def assert_same_cache(tcache, jcache):
    """Same leaves, shapes and dtypes; float leaves within TOL, int8
    values within one step (a float32 quotient can round either way)."""
    assert set(tcache) == set(jcache)
    assert int(tcache["pos"]) == int(jcache["pos"])
    for name in tcache:
        if name == "pos":
            continue
        got, want = tcache[name].numpy(), np.asarray(jcache[name])
        assert got.shape == want.shape and got.dtype == want.dtype, name
        if got.dtype == np.int8:
            diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
            assert diff.max() <= 1 and (diff > 0).mean() < 0.01, name
        else:
            np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL,
                                       err_msg=name)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("prompt_len", [4, 13])
def test_decode_logits_match_jax_across_ring_wraps(case, prompt_len):
    """prefill, one 5-token decode_chunk, then decode_step to position
    40: with window 8 the ring wraps four times, and the 13-token
    prompt is longer than the ring (its last 8 positions are kept)."""
    jcfg, tcfg, jp, tp = model(**CASES[case])
    total, max_len = 40, 48
    toks = tokens(3, (2, total))
    jl, jc = jdecode.prefill(jp, jnp.asarray(toks[:, :prompt_len]), jcfg,
                             max_len)
    tl, tc = tdecode.prefill(tp, torch.from_numpy(toks[:, :prompt_len]).long(),
                             tcfg, max_len)
    close(tl, jl, "prefill")
    assert_same_cache(tc, jc)
    chunk = toks[:, prompt_len:prompt_len + 5]
    jl, jc = jdecode.decode_chunk(jp, jc, jnp.asarray(chunk), jcfg)
    tl, tc = tdecode.decode_chunk(tp, tc, torch.from_numpy(chunk).long(),
                                  tcfg)
    close(tl, jl, "decode_chunk")
    jstep = jax.jit(jdecode.decode_step, static_argnums=3)
    for i in range(prompt_len + 5, total):
        jl, jc = jstep(jp, jc, jnp.asarray(toks[:, i]), jcfg)
        tl, tc = tdecode.decode_step(tp, tc, torch.from_numpy(toks[:, i]).long(),
                                     tcfg)
        close(tl, jl, f"position {i}")
    assert_same_cache(tc, jc)


@pytest.mark.parametrize("case", sorted(CASES))
def test_greedy_tokens_match_jax(case):
    jcfg, tcfg, jp, tp = model(**CASES[case])
    prompt = tokens(5, (2, 12))
    ref = np.asarray(jdecode.generate(jp, jnp.asarray(prompt), jcfg,
                                      max_new_tokens=20, max_len=48))
    out = tdecode.generate(tp, torch.from_numpy(prompt).long(), tcfg,
                           max_new_tokens=20, max_len=48).numpy()
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("over,shape,dtype", [
    ({"window": 8}, (2, 3, 8, 4, 16), torch.float32),
    ({"window": 8, "n_kv_heads": 2}, (2, 3, 8, 2, 16), torch.float32),
    ({"window": 64}, (2, 3, 32, 4, 16), torch.float32),  # truncated ring
    ({"kv_int8": True}, (2, 3, 32, 4, 16), torch.int8),
    ({"kv_int8": True, "window": 8}, (2, 3, 8, 4, 16), torch.int8),
])
def test_cache_layout_matches_jax(over, shape, dtype):
    jcfg, tcfg = configs(**over)
    jc = jdecode.init_cache(jcfg, 3, 32)
    tc = tdecode.init_cache(tcfg, 3, 32, device="cpu")
    assert set(tc) == set(jc)
    assert tc["k"].shape == tc["v"].shape == shape == jc["k"].shape
    assert tc["k"].dtype == dtype
    if tcfg.kv_int8:
        assert tc["k_scale"].shape == shape[:-1] == jc["k_scale"].shape
        assert tc["v_scale"].dtype == torch.float32
        # int8 values + float32 scales: about half the float32 k/v's
        # bytes at head_dim 16 (tests/test_workload.py:2847's check)
        q_bytes = sum(tc[n].nbytes for n in ("k", "v", "k_scale", "v_scale"))
        assert q_bytes < 2 * tc["k"].numel() * 4 / 2 + 1


def test_truncated_ring_refuses_overflow():
    """window > max_len truncates the ring to max_len slots; wrapping it
    would overwrite keys still inside the window, so decoding past its
    length is refused (tests/test_window.py:266)."""
    _jcfg, tcfg, _jp, tp = model(window=128)
    logits, cache = tdecode.prefill(tp, torch.ones((1, 8), dtype=torch.long),
                                    tcfg, 16)
    assert cache["k"].shape[2] == 16
    with pytest.raises(ValueError, match="exceeds cache length"):
        tdecode.generate_from_cache(tp, cache, logits, tcfg, max_new_tokens=12)
    out = tdecode.generate_from_cache(tp, cache, logits, tcfg,
                                      max_new_tokens=4)
    assert out.shape == (1, 4)


def test_full_ring_decodes_past_its_length():
    """A full ring (length == window) wraps legally; the tokens equal
    JAX's (tests/test_window.py:290)."""
    jcfg, tcfg, jp, tp = model(window=8)
    prompt = tokens(6, (1, 4))
    jl, jc = jdecode.prefill(jp, jnp.asarray(prompt), jcfg, 32)
    ref = np.asarray(jdecode.generate_from_cache(
        jp, jc, jl, jcfg, max_new_tokens=16, pos=4))
    logits, cache = tdecode.prefill(tp, torch.from_numpy(prompt).long(),
                                    tcfg, 32)
    assert cache["k"].shape[2] == 8
    out = tdecode.generate_from_cache(tp, cache, logits, tcfg,
                                      max_new_tokens=16)
    assert out.shape == (1, 16) and cache["pos"] == 4 + 15
    np.testing.assert_array_equal(out.numpy(), ref)


def test_chunk_longer_than_ring_raises():
    _jcfg, tcfg, _jp, tp = model(window=8)
    _, cache = tdecode.prefill(tp, torch.ones((1, 4), dtype=torch.long),
                               tcfg, 32)
    with pytest.raises(ValueError, match="window ring"):
        tdecode.decode_chunk(tp, cache, torch.ones((1, 9), dtype=torch.long),
                             tcfg)


@pytest.mark.parametrize("case", ["window", "int8", "int8_window"])
def test_chunked_prefill_matches_prefill_with_pieces_capped(case,
                                                            monkeypatch):
    """chunked_prefill gives prefill's logits and cache (ragged 23 =
    pieces of 7 and the remainder), with a window's pieces capped at the
    ring (chunk_len 12 > ring 8), and JAX's chunked_prefill logits."""
    jcfg, tcfg, jp, tp = model(**CASES[case])
    toks = tokens(1, (2, 23))
    chunk = 12 if tcfg.window else 7
    pieces = []
    extend = tdecode.extend

    def spy(params, cache, piece, cfg, mesh=None):
        pieces.append(piece.shape[1])
        return extend(params, cache, piece, cfg, mesh)

    monkeypatch.setattr(tdecode, "extend", spy)
    tl, tc = tdecode.chunked_prefill(tp, torch.from_numpy(toks).long(), tcfg,
                                     48, chunk_len=chunk)
    rl, rc = tdecode.prefill(tp, torch.from_numpy(toks).long(), tcfg, 48)
    jl, _ = jdecode.chunked_prefill(jp, jnp.asarray(toks), jcfg, 48,
                                    chunk_len=chunk)
    assert sum(pieces) == 23
    assert max(pieces) <= (8 if tcfg.window else chunk)
    close(tl, jl, "vs JAX chunked_prefill")
    close(tl, rl.numpy(), "vs prefill")
    assert tc["pos"] == rc["pos"] == 23
    for name in ("k", "v"):
        got, want = tc[name].float(), rc[name].float()
        assert (got - want).abs().max() <= (1.0 if tcfg.kv_int8 else TOL)
    nxt = torch.from_numpy(toks[:, 0]).long()
    la, _ = tdecode.decode_step(tp, tc, nxt, tcfg)
    lb, _ = tdecode.decode_step(tp, rc, nxt, tcfg)
    close(la, lb.numpy(), "decode after chunked prefill")


@pytest.mark.parametrize("over,seq", [
    ({"window": 8}, 32),                                          # plain
    ({"window": 128, "flash_min_seq": 128, "max_seq_len": 256}, 256),  # flash
])
def test_windowed_forward_matches_jax(over, seq):
    jcfg, tcfg, jp, tp = model(**over)
    toks = tokens(2, (2, seq))
    ref = jtf.forward(jp, jnp.asarray(toks), jcfg)
    with torch.no_grad():
        got = ttf.forward(tp, torch.from_numpy(toks).long(), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)
