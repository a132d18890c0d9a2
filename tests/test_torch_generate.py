"""The port's ``generate`` against JAX ``generate`` on bridged params:
greedy tokens must be EXACTLY equal, with eos/min_new/penalties/
logit_bias, per-row settings and a padded batch; so must sampled tokens
(the port draws JAX's threefry bits), with temperature, top-k, top-p
and the penalties set, from a seed, one key or stacked row keys; and
the port's ``init_params(0)`` is the reference's ``init_params(
PRNGKey(0))`` within rel 2e-6. The sampled path also keeps its
properties: deterministic per seed, top_k=1 is greedy, every sample
inside its row's top-k set."""
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
from containerpilot_tpu_torch.ops import prng

from torch_draws import assert_same_tokens, teacher_forced_gap

BASE = dict(vocab_size=128, d_model=64, n_heads=4, n_kv_heads=2,
            n_layers=2, d_ff=128, max_seq_len=64, dtype="float32")


@pytest.fixture(scope="module")
def model():
    jcfg = jtf.TransformerConfig(**{**BASE, "dtype": jnp.float32})
    tcfg = ttf.TransformerConfig(**bridge.config_kwargs(BASE))
    jp = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    tp = bridge.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jp), "cpu"
    )
    return jcfg, tcfg, jp, tp


def prompt(seed, b, s):
    return np.random.default_rng(seed).integers(0, 128, (b, s)).astype(np.int32)


def both(model, toks, max_new, **kw):
    jcfg, tcfg, jp, tp = model
    ref = np.asarray(jdecode.generate(
        jp, jnp.asarray(toks), jcfg, max_new_tokens=max_new, max_len=48, **kw
    ))
    out = tdecode.generate(
        tp, torch.from_numpy(toks).long(), tcfg, max_new_tokens=max_new,
        max_len=48, **kw,
    ).numpy()
    return ref, out


def test_greedy_plain(model):
    ref, out = both(model, prompt(0, 2, 6), 12)
    assert out.shape == (2, 12)
    np.testing.assert_array_equal(out, ref)


def test_greedy_eos_min_new_and_pad(model):
    toks = prompt(1, 2, 5)
    plain, _ = both(model, toks, 10)
    eos = int(plain[0, 2])  # row 0 would stop at step 2
    ref, out = both(model, toks, 10, eos_id=eos, pad_id=7)
    np.testing.assert_array_equal(out, ref)
    assert out[0, 2] == eos and (out[0, 3:] == 7).all()
    ref, out = both(model, toks, 10, eos_id=eos, pad_id=7, min_new_tokens=4)
    np.testing.assert_array_equal(out, ref)
    assert eos not in out[:, :4]


def test_greedy_penalties_and_logit_bias(model):
    toks = prompt(2, 2, 6)
    ref, out = both(model, toks, 10, presence_penalty=0.7,
                    frequency_penalty=0.4)
    np.testing.assert_array_equal(out, ref)
    ref, out = both(model, toks, 10, logit_bias={3: 100.0, 5: -100.0})
    np.testing.assert_array_equal(out, ref)
    assert (out == 3).all()
    # per-row settings, including a row without bias
    ref, out = both(
        model, toks, 10, eos_id=[int(ref[0, 0]), -1],
        presence_penalty=[0.0, 1.5], min_new_tokens=[0, 3],
        logit_bias=[{9: 4.0}, None],
    )
    np.testing.assert_array_equal(out, ref)


def test_greedy_padded_batch_rows_are_independent(model):
    """A batch padded to a power of two with zero rows (the batcher's
    shape) gives each real row the tokens it gets alone."""
    toks = prompt(3, 3, 6)
    padded = np.concatenate([toks, np.zeros((1, 6), np.int32)])
    ref, out = both(model, padded, 8, eos_id=[-1, -1, -1, -1])
    np.testing.assert_array_equal(out, ref)
    for r in range(3):
        _, alone = both(model, toks[r:r + 1], 8)
        np.testing.assert_array_equal(out[r:r + 1], alone)


def test_generate_rejects_what_the_reference_rejects(model):
    _, tcfg, _, tp = model
    toks = torch.zeros((1, 40), dtype=torch.long)
    with pytest.raises(ValueError, match="exceeds max_len"):
        tdecode.generate(tp, toks, tcfg, max_new_tokens=10, max_len=48)
    with pytest.raises(ValueError, match="top_k"):
        tdecode.generate(tp, toks[:, :4], tcfg, 4, 48, top_k=999)
    with pytest.raises(ValueError, match="logit_bias"):
        tdecode.generate(tp, toks[:, :4], tcfg, 4, 48,
                         logit_bias={500: 1.0})


def _sample(model, seed, **kw):
    _, tcfg, _, tp = model
    toks = torch.from_numpy(prompt(4, 2, 6)).long()
    return tdecode.generate(
        tp, toks, tcfg, max_new_tokens=10, max_len=48, temperature=1.0,
        rng=seed, **kw,
    )


def test_sampling_is_deterministic_per_seed(model):
    a = _sample(model, 11)
    b = _sample(model, 11)
    c = _sample(model, 12)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)


def test_sampling_top_k_1_is_greedy(model):
    _, tcfg, _, tp = model
    toks = torch.from_numpy(prompt(4, 2, 6)).long()
    greedy = tdecode.generate(tp, toks, tcfg, 10, 48)
    assert torch.equal(_sample(model, 5, top_k=1), greedy)


def test_samples_stay_inside_top_k():
    keys = prng.split(prng.prng_key(3), 4)
    logits = torch.from_numpy(
        np.random.default_rng(0).standard_normal((4, 64)).astype(np.float32)
    )
    top = torch.topk(logits, 5, dim=-1).indices
    for step in range(50):
        draw = tdecode.sample_logits(
            logits, keys, step, torch.ones(4), top_k=torch.full((4,), 5)
        )
        assert all(int(draw[r]) in top[r].tolist() for r in range(4))
    # top_p keeps the top token at least; temperature 0 is argmax
    draw = tdecode.sample_logits(
        logits, keys, 0, torch.zeros(4), top_p=torch.full((4,), 0.5)
    )
    assert torch.equal(draw, torch.argmax(logits, dim=-1))


SAMPLED_CASES = {
    "temperature": dict(temperature=1.0),
    "top_k": dict(temperature=0.8, top_k=12),
    "top_p": dict(temperature=0.9, top_p=0.8),
    "filters_and_penalties": dict(temperature=0.7, top_k=20, top_p=0.9,
                                  presence_penalty=0.6,
                                  frequency_penalty=0.3, min_new_tokens=3),
    "per_row": dict(temperature=[0.8, 0.0, 1.2], top_k=[0, 5, 9],
                    top_p=[0.95, 0.0, 0.0], logit_bias=[None, {4: 2.0},
                                                        {7: -3.0}]),
}


def _rng_forms(form, seed, b):
    """The same draws asked for three ways: (reference rng, port rng)."""
    if form == "seed":
        return jax.random.PRNGKey(seed), seed
    if form == "key":
        key = jax.random.PRNGKey(seed)
        return key, torch.from_numpy(np.asarray(key).astype(np.int64))
    keys = jnp.stack([jax.random.fold_in(jax.random.PRNGKey(seed), r)
                      for r in range(b)])
    return keys, torch.from_numpy(np.asarray(keys).astype(np.int64))


@pytest.mark.parametrize("form", ["seed", "key", "rows"])
@pytest.mark.parametrize("case", sorted(SAMPLED_CASES))
def test_sampled_tokens_equal_reference(model, case, form):
    """Seeded sampled generate draws the reference's tokens: the same
    keys, the same filters, the same Gumbel-max draw."""
    jcfg, tcfg, jp, tp = model
    kw = SAMPLED_CASES[case]
    toks = prompt(5, 3, 6)
    seed = 17
    jrng, trng = _rng_forms(form, seed, 3)
    ref = np.asarray(jdecode.generate(
        jp, jnp.asarray(toks), jcfg, max_new_tokens=14, max_len=48,
        rng=jrng, **kw))
    out = tdecode.generate(
        tp, torch.from_numpy(toks).long(), tcfg, max_new_tokens=14,
        max_len=48, rng=trng, **kw).numpy()
    row_keys = tdecode._row_keys(trng, 3, "cpu")

    def gap(r, i):
        knobs = {k: (v[r] if isinstance(v, list) else v) for k, v in
                 kw.items() if k in ("temperature", "top_k", "top_p")}
        return teacher_forced_gap(tp, tcfg, toks[r], ref[r], i, row_keys[r],
                                  **knobs)

    assert_same_tokens(ref, out, gap)


def test_sample_logits_equal_reference_sample_logits():
    """One draw of ``sample_logits`` on random logits: the reference's
    ``sample_logits`` on the folded row keys."""
    rng = np.random.default_rng(6)
    logits = rng.standard_normal((4, 96)).astype(np.float32) * 3
    keys = rng.integers(0, 2**32, (4, 2), dtype=np.uint64).astype(np.uint32)
    temp = np.float32([0.7, 1.0, 0.0, 1.3])
    top_k = np.int32([0, 7, 3, 40])
    top_p = np.float32([0.9, 0.0, 0.5, 0.6])
    for step in (0, 9):
        folded = jax.vmap(lambda k: jax.random.fold_in(k, step))(
            jnp.asarray(keys))
        ref = jdecode.sample_logits(jnp.asarray(logits), folded,
                                    jnp.asarray(temp), jnp.asarray(top_k),
                                    jnp.asarray(top_p))
        got = tdecode.sample_logits(
            torch.from_numpy(logits),
            torch.from_numpy(keys.astype(np.int64)), step,
            torch.from_numpy(temp), torch.from_numpy(top_k).long(),
            torch.from_numpy(top_p))
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_init_params_equal_reference_init():
    """``init_params(0)`` is ``init_params(PRNGKey(0))``: the same key
    tree and the same normal draws, within rel 2e-6 (erfinv's log1p
    rounds an ulp apart); the norms are ones in both."""
    for over in ({}, {"moe_experts": 4}):
        base = {**BASE, **over}
        jcfg = jtf.TransformerConfig(**{**base, "dtype": jnp.float32})
        tcfg = ttf.TransformerConfig(**bridge.config_kwargs(base))
        ref = bridge.params_from_jax(jax.tree_util.tree_map(
            np.asarray, jtf.init_params(jax.random.PRNGKey(0), jcfg)), "cpu")
        got = ttf.init_params(0, tcfg, device="cpu")
        flat_ref = dict(jax.tree_util.tree_flatten_with_path(ref)[0])
        flat_got = dict(jax.tree_util.tree_flatten_with_path(got)[0])
        assert flat_got.keys() == flat_ref.keys()
        for path, want in flat_ref.items():
            have = flat_got[path]
            assert have.shape == want.shape, path
            err = ((have - want).abs() / want.abs().clamp_min(1e-30)).max()
            assert float(err) <= 2e-6, (path, float(err))
