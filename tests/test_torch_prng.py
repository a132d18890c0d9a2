"""The port's threefry PRNG (ops/prng.py), the plain version of the
draw (ops/draw.py) and the trainer's synthetic stream against
``jax.random`` on the CPU, on the same seeds and on keys made with
numpy.

Tolerances: the key functions (``threefry2x32``, ``PRNGKey``,
``fold_in``, ``split``), ``random_bits``, ``randint`` and
``categorical`` equal JAX's bit for bit. ``uniform`` is equal too: its
affine step cannot differ by an FMA, because JAX's product there is
exact for the ranges the port uses (a factor of 1 or 2) and the general
range below also measured equal. ``gumbel`` and ``normal`` go through
``log``/``log1p``, which torch and XLA's CPU backend round differently
by an ulp: within rel 2e-6 (against max(|ref|, 1), since Gumbel noise
crosses zero). The frozen answers in ``prng.KNOWN_ANSWERS``,
``prng.KNOWN_DRAWS`` and ``prng.KNOWN_NORMALS`` (what chip_smoke.py
checks on the card, which has no JAX) are held against JAX here."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.extend.random import threefry_2x32

from containerpilot_tpu_torch.ops import draw, prng

NOISE_REL = 2e-6


def words(rng, *shape):
    return rng.integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32)


def as_torch(arr) -> torch.Tensor:
    return torch.from_numpy(np.asarray(arr).astype(np.int64))


def jkey(key_words) -> jax.Array:
    return jnp.asarray(np.asarray(key_words, np.uint32))


def assert_noise_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    err = np.abs(got - want) / np.maximum(np.abs(want), 1.0)
    assert err.max() <= NOISE_REL, err.max()


@pytest.mark.parametrize("case", prng.KNOWN_ANSWERS)
def test_threefry_known_answers(case):
    key, count, want = case
    ref = np.asarray(threefry_2x32(jkey(key), jkey(count)))
    assert tuple(int(v) for v in ref) == want
    y0, y1 = prng.threefry2x32(torch.tensor(key), torch.tensor([count[0]]),
                               torch.tensor([count[1]]))
    assert (int(y0[0]), int(y1[0])) == want


def test_known_answers_helper():
    assert prng.known_answers("cpu")


@pytest.mark.parametrize("case", prng.KNOWN_DRAWS)
def test_known_draws(case):
    seed, row, step, want = case
    key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(seed),
                                                row), step)
    ref = np.asarray(jax.random.bits(key, (32768,)))
    rkey = prng.fold_in(prng.prng_key(seed), row)
    bits = draw.draw_bits_plain(rkey[None], step, 32768)[0]
    for at, value in want.items():
        assert int(ref[at]) == value
        assert int(bits[at]) == value


def test_known_normals():
    seed, shape, want = prng.KNOWN_NORMALS
    ref = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape))
    got = prng.normal(prng.prng_key(seed), shape).reshape(-1)
    for at, value in want.items():
        assert float(ref.reshape(-1)[at]) == value
        assert abs(float(got[at]) - value) <= NOISE_REL * max(abs(value), 1)


def test_threefry_matches_jax_on_batched_keys():
    rng = np.random.default_rng(0)
    keys, x0, x1 = words(rng, 3, 2), words(rng, 3, 5), words(rng, 3, 5)
    ref = jax.vmap(lambda k, a, b: jnp.stack(
        jax.extend.random.threefry2x32_p.bind(k[0], k[1], a, b))
    )(jkey(keys), jkey(x0), jkey(x1))
    y0, y1 = prng.threefry2x32(as_torch(keys), as_torch(x0), as_torch(x1))
    np.testing.assert_array_equal(np.stack([y0, y1], 1), np.asarray(ref))


@pytest.mark.parametrize("seed", [0, 1, 7, 2**31 - 1, 2**31 + 5, 2**32 + 7,
                                  2**40 + 3, -1, -3])
def test_prng_key_matches(seed):
    ref = np.asarray(jax.random.PRNGKey(seed))
    np.testing.assert_array_equal(prng.prng_key(seed).numpy(), ref)


def test_fold_in_matches_one_key_and_rows():
    rng = np.random.default_rng(1)
    keys = words(rng, 4, 2)
    data = rng.integers(0, 2**31, 4)
    ref = jax.vmap(jax.random.fold_in)(jkey(keys), jnp.asarray(data,
                                                              jnp.uint32))
    got = prng.fold_in(as_torch(keys), torch.from_numpy(data))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    one = jax.random.fold_in(jax.random.PRNGKey(3), 2**31 + 9)
    np.testing.assert_array_equal(
        prng.fold_in(prng.prng_key(3), 2**31 + 9).numpy(), np.asarray(one))


@pytest.mark.parametrize("num", [2, 5, (2, 3)])
def test_split_matches(num):
    key = jax.random.PRNGKey(11)
    np.testing.assert_array_equal(
        prng.split(prng.prng_key(11), num).numpy(),
        np.asarray(jax.random.split(key, num)))
    # split(key, n)[i] is fold_in(key, i): the server's row keys
    np.testing.assert_array_equal(
        prng.split(prng.prng_key(11), 4)[2].numpy(),
        prng.fold_in(prng.prng_key(11), 2).numpy())


@pytest.mark.parametrize("shape", [(1,), (7,), (3, 5), (2, 3, 4)])
def test_random_bits_match(shape):
    key = jax.random.PRNGKey(5)
    ref = np.asarray(jax.random.bits(key, shape))
    np.testing.assert_array_equal(
        prng.random_bits(prng.prng_key(5), shape).numpy(), ref)
    # flat chunks of one key are slices of the whole
    whole = prng.random_bits(prng.prng_key(5), shape).reshape(-1)
    n = whole.numel()
    np.testing.assert_array_equal(
        prng.random_bits(prng.prng_key(5), shape, n // 2, n).numpy(),
        whole[n // 2:].numpy())


def test_random_bits_match_per_row_keys():
    rng = np.random.default_rng(2)
    keys = words(rng, 3, 2)
    ref = jax.vmap(lambda k: jax.random.bits(k, (9,)))(jkey(keys))
    np.testing.assert_array_equal(
        prng.random_bits(as_torch(keys), (9,)).numpy(), np.asarray(ref))


@pytest.mark.parametrize("bounds", [
    (0.0, 1.0), (prng.TINY, 1.0), (prng._NORMAL_LO, 1.0), (-0.3, 1.7),
])
def test_uniform_matches(bounds):
    key = jax.random.PRNGKey(42)
    ref = np.asarray(jax.random.uniform(key, (4096,), jnp.float32, *bounds))
    got = prng.uniform(prng.prng_key(42), (4096,), *bounds).numpy()
    np.testing.assert_array_equal(got, ref)


def test_gumbel_matches():
    for seed in (0, 42):
        ref = np.asarray(jax.random.gumbel(jax.random.PRNGKey(seed),
                                           (50000,)))
        assert_noise_close(prng.gumbel(prng.prng_key(seed), (50000,)), ref)


def test_normal_matches_whole_and_in_chunks():
    key = jax.random.PRNGKey(42)
    ref = np.asarray(jax.random.normal(key, (300, 200)))
    got = prng.normal(prng.prng_key(42), (300, 200))
    assert_noise_close(got, ref)
    chunked = prng.normal(prng.prng_key(42), (300, 200), chunk=7777)
    assert torch.equal(chunked, got)


def test_erfinv_matches_xla():
    x = np.concatenate([
        np.linspace(-1, 1, 20001, dtype=np.float32),
        np.float32([prng._NORMAL_LO, -prng._NORMAL_LO, 0.999999, -0.5e-7]),
    ])
    ref = np.asarray(jax.lax.erf_inv(jnp.asarray(x)))
    got = prng.erfinv(torch.from_numpy(x)).numpy()
    finite = np.isfinite(ref)
    np.testing.assert_array_equal(got[~finite], ref[~finite])
    assert_noise_close(got[finite], ref[finite])


@pytest.mark.parametrize("bounds", [(0, 128), (0, 50000), (-7, 100000),
                                    (5, 5), (3, 2**31 - 1)])
def test_randint_matches(bounds):
    key = jax.random.fold_in(jax.random.PRNGKey(1), 6)
    ref = np.asarray(jax.random.randint(key, (4, 33), *bounds, jnp.int32))
    got = prng.randint(prng.fold_in(prng.prng_key(1), 6), (4, 33), *bounds)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("step", [0, 7, 2**31 + 3])
def test_synthetic_tokens_equal_the_reference_stream(step):
    """The trainer's synthetic batch of ``step`` is the JAX trainer's:
    ``randint(fold_in(PRNGKey(1), step), (batch, seq_len + 1), 0,
    vocab)``."""
    from containerpilot_tpu_torch.workload.train import synthetic_tokens

    key = jax.random.fold_in(jax.random.PRNGKey(1), step)
    ref = np.asarray(jax.random.randint(key, (4, 33), 0, 32768, jnp.int32))
    got = synthetic_tokens(step, 4, 32, 32768, "cpu")
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("form", ["shared", "per_row"])
def test_categorical_matches(form):
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((6, 300)).astype(np.float32) * 3
    if form == "shared":
        key = jax.random.PRNGKey(9)
        ref = jax.random.categorical(key, jnp.asarray(logits), axis=-1)
        got = prng.categorical(prng.prng_key(9), torch.from_numpy(logits))
    else:
        keys = words(rng, 6, 2)
        ref = jax.vmap(lambda k, r: jax.random.categorical(k, r))(
            jkey(keys), jnp.asarray(logits))
        got = prng.categorical(as_torch(keys), torch.from_numpy(logits))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("step", [0, 5, "rows"])
def test_draw_plain_is_the_references_step_draw(step):
    """The draw (``gumbel_argmax``, here its plain version) is the
    reference sampler's: categorical(fold_in(row_key, step), logits),
    one step for every row or one a row, and its bits are the ones the
    kernel would write."""
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((5, 500)).astype(np.float32) * 2
    keys = words(rng, 5, 2)
    steps = (np.arange(5) * 3 + 1 if step == "rows"
             else np.full(5, step))
    folded = jax.vmap(jax.random.fold_in)(jkey(keys),
                                          jnp.asarray(steps, jnp.uint32))
    ref = jax.vmap(lambda k, r: jax.random.categorical(k, r))(
        folded, jnp.asarray(logits))
    arg = torch.from_numpy(steps) if step == "rows" else step
    bits = torch.empty((5, 500), dtype=torch.int32)
    got = draw.gumbel_argmax(torch.from_numpy(logits), as_torch(keys), arg,
                             bits_out=bits)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    ref_bits = jax.vmap(lambda k: jax.random.bits(k, (500,)))(folded)
    np.testing.assert_array_equal(
        bits.numpy().view(np.uint32), np.asarray(ref_bits))


def test_draw_refuses_what_the_kernel_does_not_take():
    x = torch.zeros((2, 8), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        draw.gumbel_argmax(x, torch.zeros((2, 2), dtype=torch.int64), 0)
    bound = draw.bound_ms(8, 32768)
    assert bound["bound_by"] == "operations" and bound["bound_ms"] > 0
