"""JAX's default PRNG in plain torch: ``threefry2x32`` with
``jax_threefry_partitionable`` on, and the samplers the port draws from
it (counterpart of ``jax._src.prng`` and ``jax._src.random``, which the
JAX package uses through ``jax.random``).

The same key gives the same bits as ``jax.random``, so a request seed
names the same stream in both packages: a sampled answer, a random-weight
init and the trainer's synthetic data agree with the reference's.

A key is a ``[..., 2]`` int64 tensor of two 32-bit words (JAX's raw
``uint32[2]`` key data). Every function takes leading key dimensions as
a batch: ``fold_in(keys [b, 2], steps [b])`` folds each row's step into
its own key, ``random_bits(keys [b, 2], (vocab,))`` draws each row's
[vocab] block from its own key (the ``vmap`` form). Words are held in
int64 and masked to 32 bits after every add and shift; torch has no
uint32 add on the CPU.

Floats follow ``jax.random`` in float32: ``uniform`` sets the 23
mantissa bits of a float in [1, 2) and subtracts 1, ``gumbel`` is
``-log(-log(uniform(tiny, 1)))`` (JAX's "low" mode), ``normal`` is
``sqrt(2) * erfinv(uniform(nextafter(-1, 0), 1))`` with XLA's float32
erfinv (Giles' polynomial, as StableHLO's ``chlo.erf_inv`` expands it;
torch's own ``erfinv`` is off by up to 6e-6 in the tails), ``randint``
is JAX's two-draw modulus. The bits, ``uniform``, ``randint`` and the
keys are JAX's exactly; ``log`` and ``log1p`` are torch's, which can
differ from XLA's by an ulp, so ``gumbel`` and ``normal`` agree to a
few ulps.

Everything here runs on any device as plain torch: it is the plain
version of the draw kernel (``ops/draw.py``), the CPU path of every
seeded stream, and the card's path for init (``normal`` in chunks of
flat counters, so a large leaf never holds more than a chunk of int64
words).
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import numpy as np
import torch

MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
# flat counters a chunk of ``normal``/``uniform``/``random_bits`` over
# one key (int64 words: 128 MiB a buffer)
CHUNK = 1 << 24

# Known answers of threefry2x32 (key words, count words -> output words),
# computed by jax.random's threefry on the CPU (tests/test_torch_prng.py
# holds them against it). The first is Random123's published test
# vector for threefry2x32 with 20 rounds.
KNOWN_ANSWERS = (
    ((0x00000000, 0x00000000), (0x00000000, 0x00000000),
     (0x6B200159, 0x99BA4EFE)),
    ((0xFFFFFFFF, 0xFFFFFFFF), (0xFFFFFFFF, 0xFFFFFFFF),
     (0x1CB996FC, 0xBB002BE7)),
    ((0x13198A2E, 0x03707344), (0x243F6A88, 0x85A308D3),
     (0xC4923A9C, 0x483DF7A0)),
)
# Known answers of the sampling draw: random_bits(fold_in(fold_in(
# prng_key(seed), row), step), (32768,)) at a few counters, computed by
# jax.random (seed, row, step, {counter: bits}).
KNOWN_DRAWS = (
    (0, 0, 0, {0: 0x486056AF, 1: 0xC9C0BF0F, 12345: 0x6D0CABBC,
               32767: 0x2D719DDA}),
    (7, 3, 11, {0: 0x443F6606, 1: 0x71AFF277, 12345: 0x7B60EABF,
                32767: 0xB01980F6}),
    (2**31 + 5, 1, 63, {0: 0x8D77446B, 1: 0x9FEBA8B4, 12345: 0x7A023E9C,
                        32767: 0xE07E041D}),
)

# Known answers of normal: jax.random.normal(PRNGKey(5), (3, 1000)) at a
# few flat indices, computed by jax.random (float32 values).
KNOWN_NORMALS = (5, (3, 1000), {0: -0.08437306433916092,
                                1: 1.4110229015350342,
                                1234: -1.518144130706787,
                                2999: -0.04109892621636391})

Key = torch.Tensor


def _words(n) -> torch.Tensor:
    return torch.as_tensor(n).to(torch.int64) & MASK


def _hash(k0, k1, x0, x1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32, 20 rounds, on broadcastable int64 tensors of
    32-bit words -> (y0, y1). Works in place on two fresh buffers."""
    # numpy's: torch.broadcast_shapes imports sympy (~4 s) on first use
    shape = np.broadcast_shapes(k0.shape, k1.shape, x0.shape, x1.shape)
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = ((x0 + k0) & MASK).expand(shape).contiguous()
    x1 = ((x1 + k1) & MASK).expand(shape).contiguous()
    tmp = torch.empty_like(x1)
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0.add_(x1).bitwise_and_(MASK)
            torch.bitwise_right_shift(x1, 32 - r, out=tmp)
            x1.bitwise_left_shift_(r).bitwise_and_(MASK)
            x1.bitwise_or_(tmp).bitwise_xor_(x0)
        x0.add_(ks[(i + 1) % 3]).bitwise_and_(MASK)
        x1.add_(ks[(i + 2) % 3]).add_(i + 1).bitwise_and_(MASK)
    return x0, x1


def _key_words(key: Key, trailing: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The key's two words shaped to broadcast against counters with
    ``trailing`` dimensions after the key's batch dimensions."""
    if key.shape[-1:] != (2,):
        raise ValueError(f"a key is [..., 2] words, got {tuple(key.shape)}")
    pad = (1,) * trailing
    key = key.to(torch.int64)
    return (key[..., 0].reshape(*key.shape[:-1], *pad),
            key[..., 1].reshape(*key.shape[:-1], *pad))


def threefry2x32(key: Key, x0, x1) -> Tuple[torch.Tensor, torch.Tensor]:
    """JAX's ``threefry2x32_p``: hash the count words (x0, x1) under
    ``key`` ([..., 2]; its batch dimensions lead the counts') -> (y0,
    y1), int64 tensors of 32-bit words."""
    x0, x1 = _words(x0).to(key.device), _words(x1).to(key.device)
    k0, k1 = _key_words(key, max(x0.dim(), x1.dim()) - (key.dim() - 1))
    return _hash(k0, k1, x0, x1)


def prng_key(seed: int, device="cpu") -> Key:
    """``jax.random.PRNGKey(seed)`` as JAX builds it by default (64-bit
    types off): the words (0, seed mod 2**32)."""
    return torch.tensor([0, int(seed) & MASK], dtype=torch.int64,
                        device=device)


def fold_in(key: Key, data) -> Key:
    """``jax.random.fold_in``: the key hashed with counts (0, data), data
    taken mod 2**32. ``data`` broadcasts against the key's batch
    dimensions ([b, 2] keys with [b] data fold one step a row)."""
    k0, k1 = key.to(torch.int64).unbind(-1)
    data = _words(data).to(k0.device)
    y0, y1 = _hash(k0, k1, torch.zeros_like(data), data)
    return torch.stack([y0, y1], dim=-1)


def _shape(num) -> Tuple[int, ...]:
    return tuple(num) if isinstance(num, Sequence) else (int(num),)


def _counters(start: int, stop: int, device) -> Tuple[torch.Tensor,
                                                       torch.Tensor]:
    """The flat counters [start, stop) as (high, low) 32-bit words, as
    ``iota_2x32_shape`` numbers a shape's elements."""
    n = torch.arange(start, stop, dtype=torch.int64, device=device)
    return n >> 32, n & MASK


def split(key: Key, num: Union[int, Sequence[int]] = 2) -> Key:
    """``jax.random.split`` (the fold-like partitionable form): key i is
    the hash of counts (0, i), so ``split(key, n)[i] == fold_in(key,
    i)``. A [..., 2] key gives [..., *num, 2]."""
    shape = _shape(num)
    k0, k1 = _key_words(key, 1)
    hi, lo = _counters(0, math.prod(shape), key.device)
    y0, y1 = _hash(k0, k1, hi, lo)
    return torch.stack([y0, y1], dim=-1).reshape(
        *key.shape[:-1], *shape, 2)


def random_bits(key: Key, shape: Sequence[int], start: int = 0,
                stop: int = None) -> torch.Tensor:
    """``jax.random.bits`` at 32 bits: element n of ``shape`` (row-major)
    is ``y0 ^ y1`` of the hash of counts (n >> 32, n mod 2**32). Leading
    key dimensions are a batch: [..., 2] keys give [..., *shape]. With
    ``start``/``stop`` only the flat elements [start, stop) of one key
    are made (the chunks of a large leaf), as a flat tensor."""
    shape = _shape(shape)
    flat = stop is not None
    stop = math.prod(shape) if stop is None else stop
    k0, k1 = _key_words(key, 1)
    hi, lo = _counters(start, stop, key.device)
    y0, y1 = _hash(k0, k1, hi, lo)
    bits = y0.bitwise_xor_(y1)
    if flat:
        return bits.reshape(*key.shape[:-1], stop - start)
    return bits.reshape(*key.shape[:-1], *shape)


def _unit(bits: torch.Tensor) -> torch.Tensor:
    """32 random bits -> float32 in [0, 1): the top 23 bits as the
    mantissa of a float in [1, 2), minus 1."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0


def _affine(floats: torch.Tensor, minval, maxval) -> torch.Tensor:
    """JAX's ``max(minval, floats * (maxval - minval) + minval)`` in
    float32 (the bounds filled on the device: no host copy)."""
    mn = torch.full((), minval, dtype=torch.float32, device=floats.device)
    mx = torch.full((), maxval, dtype=torch.float32, device=floats.device)
    return torch.maximum(mn, floats * (mx - mn) + mn)


def uniform(key: Key, shape: Sequence[int], minval=0.0,
            maxval=1.0) -> torch.Tensor:
    """``jax.random.uniform`` in float32 on [minval, maxval)."""
    return _affine(_unit(random_bits(key, shape)), minval, maxval)


TINY = float(np.finfo(np.float32).tiny)


def gumbel(key: Key, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.gumbel`` in float32, mode "low": -log(-log(u)) with
    u uniform on [tiny, 1)."""
    u = uniform(key, shape, TINY, 1.0)
    return -torch.log(-torch.log(u))


def categorical(key: Key, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical`` over the last axis: the argmax of
    gumbel noise plus logits (ties to the lowest index, as
    ``jnp.argmax``). One key [2] draws noise over the whole logits
    shape (the shared-key form); keys [b, 2] for logits [b, vocab] draw
    each row's [vocab] noise from its own key (the vmapped form)."""
    if key.dim() == 1:
        noise = gumbel(key, tuple(logits.shape))
    else:
        noise = gumbel(key, tuple(logits.shape[key.dim() - 1:]))
    return torch.argmax(noise + logits.float(), dim=-1)


_SQRT2 = float(np.float32(np.sqrt(2.0)))
_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
# erfinv's polynomial in w = -log1p(-x * x), below and above w = 5
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def erfinv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 inverse error function: Giles' single-precision
    polynomial, +-inf at +-1."""
    w = -torch.log1p(x * -x)
    low = w < 5.0
    w = torch.where(low, w - 2.5, torch.sqrt(w) - 3.0)
    coef = [torch.where(low, float(np.float32(lt)), float(np.float32(ge)))
            for lt, ge in zip(_ERFINV_LT5, _ERFINV_GE5)]
    p = coef[0]
    for c in coef[1:]:
        p = c + p * w
    return torch.where(x.abs() == 1.0, x * torch.inf, p * x)


def _normal_of(bits: torch.Tensor) -> torch.Tensor:
    return erfinv(_affine(_unit(bits), _NORMAL_LO, 1.0)).mul_(_SQRT2)


def normal(key: Key, shape: Sequence[int], out: torch.Tensor = None,
           chunk: int = CHUNK) -> torch.Tensor:
    """``jax.random.normal`` in float32: sqrt(2) * erfinv(u) with u
    uniform on (-1, 1). One key ([2]) is made in chunks of ``chunk``
    flat counters into ``out`` (or a new tensor), so a large leaf never
    holds more than a chunk of int64 words; batched keys draw whole."""
    shape = _shape(shape)
    if key.dim() > 1:
        return _normal_of(random_bits(key, shape))
    total = math.prod(shape)
    if out is None:
        out = torch.empty(shape, dtype=torch.float32, device=key.device)
    flat = out.view(-1)
    for start in range(0, total, chunk):
        stop = min(total, start + chunk)
        flat[start:stop] = _normal_of(random_bits(key, shape, start, stop))
    return out


def randint(key: Key, shape: Sequence[int], minval: int,
            maxval: int) -> torch.Tensor:
    """``jax.random.randint`` into int32 values, returned as int64: two
    32-bit draws (from ``split(key)``) combined modulo the span, with
    JAX's uint32 wrap-around. ``minval``/``maxval`` are ints inside
    int32."""
    shape = _shape(shape)
    k1, k2 = split(key, 2).unbind(-2)
    higher, lower = random_bits(k1, shape), random_bits(k2, shape)
    span = (maxval - minval) & MASK if maxval > minval else 1
    mult = (((1 << 16) % span) ** 2 & MASK) % span
    offset = (((higher % span) * mult) & MASK) + (lower % span)
    offset = (offset & MASK) % span
    return minval + offset


def known_answers(device="cpu") -> bool:
    """Whether this device's ``threefry2x32`` gives ``KNOWN_ANSWERS``."""
    for key, count, want in KNOWN_ANSWERS:
        y0, y1 = threefry2x32(torch.tensor(key, device=device),
                              torch.tensor([count[0]], device=device),
                              torch.tensor([count[1]], device=device))
        if (int(y0[0]), int(y1[0])) != want:
            return False
    return True
