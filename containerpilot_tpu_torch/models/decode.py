"""Incremental decoding: prefill + token steps over a KV cache, and the
sampler (counterpart of ``containerpilot_tpu/models/decode.py``).

Intended differences from the reference:

- The cache is updated IN PLACE. JAX's ``dynamic_update_slice`` returns
  a new array each step; here prefill and every decode step write their
  k/v into the preallocated [L, B, length, kv_heads, hd] tensors (a
  linear cache of ``max_len``, or a sliding window's ring), and
  ``cache["pos"]`` is a Python int. Callers that need the old cache must
  copy it first.
- A linear cache's attention reads only the positions written so far
  (``:pos + m``): the rest are masked and contribute exactly zero, so
  under ``kv_int8`` only those are dequantized.
- Eager torch runs no fixed-length scan: ``generate`` stops once every
  row has emitted eos (rows already done would only emit pad) and fills
  the rest with pad, which returns the same tokens.
- Sampling draws come from per-row ``torch.Generator``s, not
  ``jax.random`` threefry: sampled tokens differ from the reference for
  the same seed (greedy tokens are identical). A row's draws depend only
  on (seed, row, step): each step takes one [vocab] uniform block from
  the row's generator.

Serving on a mesh (``mesh=``, parallel/mesh.py: one process a rank,
every rank calling the same function on its blocks of the params): the
KV cache holds the rank's kv heads (``cache_kv_heads``: kv_heads/tp when
tp divides them, else the kv of the rank's query heads, whose weights
are replicated), attention and the flash kernel run on the rank's
heads, and the vocab-parallel logits are gathered whole before
sampling, so every rank samples the same token from the same bits with
identically seeded generators. A mesh without a live ``model`` axis
runs exactly the unsharded path.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import resolve_device
from ..ops import tuning
from ..ops.attention import NEG_INF, causal_attention
from ..ops.flash import flash_attention_forward
from ..ops.quant import quantize_int8_axes
from .quantized import (
    can_fuse_int8,
    fused_attn_out,
    fused_mlp,
    fused_qkv,
    maybe_dequant_layer,
    maybe_dequant_top,
)
from .transformer import (
    Params,
    TransformerConfig,
    _attn_out,
    _dot_f32,
    _ffn,
    _qkv,
    _rms_norm,
    _tp,
    embed,
    flash_eligible,
    hooked_attention,
    layer_params,
    repeat_kv,
    seq_offset,
)

Cache = Dict[str, Any]


def cache_kv_heads(cfg: TransformerConfig, mesh=None) -> int:
    """KV heads a rank's cache holds: all of them on one rank; under
    tensor parallelism kv_heads/tp when tp divides them (the weights'
    rule, parallel/sharding.py), else the rank's query heads' kv,
    repeated from the replicated weights (``_qkv``)."""
    tp = mesh.axis_size("model") if mesh is not None else 1
    if tp == 1:
        return cfg.kv_heads
    if cfg.kv_heads % tp == 0:
        return cfg.kv_heads // tp
    return cfg.n_heads // tp


def init_cache(
    cfg: TransformerConfig, batch: int, max_len: int, device="cuda",
    mesh=None,
) -> Cache:
    """Zeroed KV cache: k/v [layers, batch, length, kv_heads, head_dim]
    and ``pos`` (tokens cached) a Python int.

    With a sliding window (cfg.window > 0) the cache is a RING of
    ``min(window, max_len)`` entries: position p lives at slot
    ``p % length``, so decode KV memory is bounded by the window, not
    the generation length. With ``cfg.kv_int8`` k/v are int8 with a
    float32 scale per (token, head) over head_dim (``k_scale`` /
    ``v_scale`` [layers, batch, length, kv_heads]); otherwise they are
    in the compute dtype. On a mesh, kv_heads is ``cache_kv_heads``."""
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, ring_length(cfg, max_len),
             cache_kv_heads(cfg, mesh), cfg.head_dim)
    cache: Cache = {"pos": 0}
    if cfg.kv_int8:
        for name in ("k", "v"):
            cache[name] = torch.zeros(shape, dtype=torch.int8, device=dev)
            cache[f"{name}_scale"] = torch.zeros(
                shape[:-1], dtype=torch.float32, device=dev
            )
    else:
        for name in ("k", "v"):
            cache[name] = torch.zeros(shape, dtype=cfg.dtype, device=dev)
    return cache


def ring_length(cfg: TransformerConfig, max_len: int) -> int:
    """Positions a cache row holds: ``max_len``, or a window's ring of
    ``min(window, max_len)``."""
    return max_len if cfg.window <= 0 else min(cfg.window, max_len)


def kv_quant(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 over head_dim with the package's one quantization
    formula (``ops/quant.py``) -> (int8 like x, float32 scale without
    the trailing axis)."""
    q, scale = quantize_int8_axes(x, (-1,))
    return q, scale[..., 0]


def kv_dequant(q: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    return (q.float() * scale[..., None]).to(dtype)


def kv_leaves(cfg: TransformerConfig, k: torch.Tensor,
              v: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The cache leaves that store k/v [..., kv, hd]: themselves, or
    under ``kv_int8`` the int8 values and their scales."""
    if not cfg.kv_int8:
        return {"k": k, "v": v}
    k_q, k_s = kv_quant(k)
    v_q, v_s = kv_quant(v)
    return {"k": k_q, "v": v_q, "k_scale": k_s, "v_scale": v_s}


def _read_back(cfg: TransformerConfig, leaves: Dict[str, torch.Tensor]):
    """k/v in the compute dtype from cache leaves (``kv_leaves``'
    layout, any slice of positions): under ``kv_int8`` dequantized, the
    quantization roundtrip attention reads."""
    if not cfg.kv_int8:
        return leaves["k"], leaves["v"]
    return (kv_dequant(leaves["k"], leaves["k_scale"], cfg.dtype),
            kv_dequant(leaves["v"], leaves["v_scale"], cfg.dtype))


def _logits(params: Params, x: torch.Tensor, cfg: TransformerConfig,
            mesh=None) -> torch.Tensor:
    """Final hidden -> float32 logits, the vocab shards gathered whole
    under tensor parallelism."""
    x = _rms_norm(x, params["norm_out"])
    logits = _dot_f32(x, maybe_dequant_top(params, "unembed", cfg.dtype))
    if _tp(mesh):
        logits = mesh.all_gather(logits, "model", -1)
    return logits


def prefill(
    params: Params, tokens: torch.Tensor, cfg: TransformerConfig,
    max_len: int, mesh=None,
) -> Tuple[torch.Tensor, Cache]:
    """Process the prompt -> (logits for the last position [b, vocab],
    cache). tokens: [batch, prompt_len] int64 on the params' device.
    Prompts at/above the flash threshold (and 128-aligned) run the flash
    kernel, GQA-native and windowed with ``cfg.window``; shorter ones
    the plain masked softmax. Under ``kv_int8`` attention reads the
    quantization roundtrip of k/v, exactly what later decode steps read
    from the cache. A prompt longer than a window's ring keeps its last
    ``length`` positions, each at slot ``p % length``. An MoE config
    with capacity routing is refused: decoding is drop-free. Under
    ``cfg.attention_fn`` (a context-parallel ring, parallel/context.py)
    the tokens are this rank's sequence shard, RoPE runs at their global
    positions and the hook replaces the auto attention; the cache then
    holds the shard's positions only."""
    if cfg.moe_experts > 0 and cfg.moe_train_capacity > 0:
        raise ValueError(
            "incremental decoding requires a serving config with "
            "moe_train_capacity=0 (capacity routing is sequence-length "
            "dependent and cannot match decode)"
        )
    b, s = tokens.shape
    if s > max_len:
        raise ValueError(f"prompt_len {s} exceeds max_len {max_len}")
    x = embed(params, tokens, cfg, mesh)
    cache = init_cache(cfg, b, max_len, device=x.device, mesh=mesh)
    length = cache["k"].shape[2]
    wraps = s > length
    if wraps:
        slots = torch.arange(s - length, s, device=x.device) % length
    hooked = cfg.attention_fn is not None
    gqa_flash = not hooked and flash_eligible(cfg, s, kind="fwd")
    if gqa_flash:
        fq, fk = tuning.pick_blocks("fwd", s)
    offset = seq_offset(cfg, s)
    for i in range(cfg.n_layers):
        lp = maybe_dequant_layer(layer_params(params, i), cfg.dtype)
        q, k, v = _qkv(x, lp, cfg, offset=offset, mesh=mesh)
        writes = kv_leaves(cfg, k, v)
        k, v = _read_back(cfg, writes)
        if hooked:
            attn = hooked_attention(q, k, v, cfg)
        elif gqa_flash:
            attn = flash_attention_forward(
                q, k, v, block_q=fq, block_k=fk, window=cfg.window
            )
        else:
            heads = q.shape[2]
            attn = causal_attention(
                q, repeat_kv(k, heads), repeat_kv(v, heads),
                window=cfg.window,
            )
        x, _aux = _ffn(_attn_out(x, attn, lp, cfg, mesh), lp, cfg, mesh)
        # in place: the cache stores the unrepeated kv heads
        for name, value in writes.items():
            if wraps:
                cache[name][i].index_copy_(1, slots, value[:, s - length:])
            else:
                cache[name][i, :, :s] = value
    cache["pos"] = s
    return _logits(params, x[:, -1:, :], cfg, mesh)[:, 0, :], cache


def decode_chunk(
    params: Params, cache: Cache, tokens: torch.Tensor,
    cfg: TransformerConfig, mesh=None,
) -> Tuple[torch.Tensor, Cache]:
    """Process m tokens against the cache in one forward (``tokens[:, i]``
    sits at position pos + i) -> (logits [b, m, vocab], cache). Writes
    the chunk's k/v into the cache in place (quantized under
    ``kv_int8``, and read back through the roundtrip) and advances
    ``pos``.

    Attention over the cache is plain torch, as in the reference (not a
    Pallas kernel there): float32 scores from q * hd**-0.5, NEG_INF mask,
    float32 softmax cast to the compute dtype, value product with float32
    accumulation. A linear cache reads only ``:pos + m`` (later keys are
    all masked and contribute exactly zero). A window's ring reads every
    slot, each masked by the newest position it holds
    (``pos - 1 - ((pos - 1 - j) mod length)``, negative = never
    written), with the chunk's own k/v concatenated after it, so no
    query reads a slot the chunk is about to overwrite; a chunk longer
    than the ring is refused."""
    pos = cache["pos"]
    b, m = tokens.shape
    length = cache["k"].shape[2]
    ring = cfg.window > 0
    if ring and m > length:
        raise ValueError(
            f"decode chunk of {m} tokens exceeds the {length}-slot "
            "window ring; chunk at most `window` tokens"
        )
    if not ring and pos + m > length:
        raise ValueError(
            f"cache pos {pos} + {m} tokens exceeds cache length {length}"
        )
    end = pos + m
    dev = tokens.device
    x = embed(params, tokens, cfg, mesh)  # [b, m, d]
    q_idx = torch.arange(m, device=dev)
    q_pos = pos + q_idx
    if ring:
        ring_pos = pos - 1 - torch.remainder(
            pos - 1 - torch.arange(length, device=dev), length
        )
        ring_ok = (ring_pos[None, :] >= 0) & (
            ring_pos[None, :] > q_pos[:, None] - cfg.window
        )
        chunk_ok = (q_idx[None, :] <= q_idx[:, None]) & (
            q_idx[:, None] - q_idx[None, :] < cfg.window
        )
        valid = torch.cat([ring_ok, chunk_ok], dim=1)
        slots = torch.remainder(q_pos, length)
    else:
        valid = torch.arange(end, device=dev)[None, :] <= q_pos[:, None]
    fused = can_fuse_int8(params["layers"], cfg, rows=b * m)
    kvh, hd = cache["k"].shape[3], cfg.head_dim
    for i in range(cfg.n_layers):
        lp = layer_params(params, i)
        if fused:
            q, k, v = fused_qkv(x, lp, cfg, offset=pos, mesh=mesh)
        else:
            lp = maybe_dequant_layer(lp, cfg.dtype)
            q, k, v = _qkv(x, lp, cfg, offset=pos, mesh=mesh)
        heads = q.shape[2]
        group = heads // kvh
        writes = kv_leaves(cfg, k, v)
        if ring:
            k, v = _read_back(cfg, writes)
            cached_k, cached_v = _read_back(
                cfg, {name: cache[name][i] for name in writes})
            keys = torch.cat([cached_k, k], dim=1)    # [b, length + m, kv, hd]
            values = torch.cat([cached_v, v], dim=1)
            for name, value in writes.items():
                cache[name][i].index_copy_(1, slots, value)
        else:
            for name, value in writes.items():
                cache[name][i, :, pos:end] = value
            keys, values = _read_back(  # [b, end, kv, hd]
                cfg, {name: cache[name][i, :, :end] for name in writes})
        # GQA without a repeat_kv copy: query head j = kv * group + g
        # reads kv head j // group, the reference's repeat order
        qg = (q.float() * hd ** -0.5).reshape(b, m, kvh, group, hd)
        scores = torch.einsum("bqcgd,bkcd->bcgqk", qg, keys.float())
        scores = torch.where(valid, scores, NEG_INF)
        weights = torch.softmax(scores, dim=-1).to(cfg.dtype)
        attn = torch.einsum("bcgqk,bkcd->bqcgd", weights, values)
        attn = attn.to(cfg.dtype).reshape(b, m, heads, hd)
        x = layer_out(x, attn, lp, cfg, fused, mesh)
    cache["pos"] = end
    return _logits(params, x, cfg, mesh), cache


def layer_out(
    x: torch.Tensor, attn: torch.Tensor, lp, cfg: TransformerConfig,
    fused: bool, mesh=None,
) -> torch.Tensor:
    """Output projection + residual, then the feed-forward half: int8
    fused (K2 on the card) or dense (``lp`` already dequantized). Shared
    by ``decode_chunk`` and the slot pool's step (``models/slots.py``)."""
    if fused:
        return fused_mlp(fused_attn_out(x, attn, lp, cfg, mesh), lp, cfg,
                         mesh)
    x, _aux = _ffn(_attn_out(x, attn, lp, cfg, mesh), lp, cfg, mesh)
    return x


def decode_step(
    params: Params, cache: Cache, token: torch.Tensor,
    cfg: TransformerConfig, mesh=None,
) -> Tuple[torch.Tensor, Cache]:
    """One step: token [batch] at position cache['pos'] -> (logits
    [batch, vocab], cache); the m=1 case of decode_chunk."""
    logits, cache = decode_chunk(params, cache, token[:, None], cfg, mesh)
    return logits[:, 0, :], cache


def extend(
    params: Params, cache: Cache, tokens: torch.Tensor,
    cfg: TransformerConfig, mesh=None,
) -> Tuple[torch.Tensor, Cache]:
    """Consume a token chunk [b, m] against the cache -> (last logits
    [b, vocab], cache): the counterpart of the reference's
    ``_jitted_extend``. The cache is extended IN PLACE (the reference's
    extend never donates its operand); a caller that must keep the old
    cache (a prefix-cache entry) copies it first."""
    logits, cache = decode_chunk(params, cache, tokens, cfg, mesh)
    return logits[:, -1, :], cache


def piece_plan(s: int, chunk_len: int) -> List[int]:
    """The chunked-prefill piece lengths for s tokens: the ragged
    remainder first, as at most one sub-16 piece plus 16-token pieces,
    then full chunks, so lengths come from {1..15, 16, chunk_len}."""
    bucket = min(16, chunk_len)
    lead = s % chunk_len
    plan = [lead % bucket] if lead % bucket else []
    plan += [bucket] * (lead // bucket)
    return plan + [chunk_len] * (s // chunk_len)


def extend_pieces(
    params: Params, cache: Cache, tokens: torch.Tensor,
    cfg: TransformerConfig, chunk_len: int, mesh=None,
) -> Tuple[torch.Tensor, Cache]:
    """Extend ``tokens`` [b, s] into ``cache`` in bounded pieces
    (``piece_plan``), so peak activation memory is O(chunk_len). Also
    applied by the prefix-hit path to a long cached-hit suffix.
    Returns (last logits, cache)."""
    logits = None
    start = 0
    for piece in piece_plan(tokens.shape[1], chunk_len):
        logits, cache = extend(
            params, cache, tokens[:, start:start + piece], cfg, mesh
        )
        start += piece
    return logits, cache


def chunked_prefill(
    params: Params, tokens: torch.Tensor, cfg: TransformerConfig,
    max_len: int, chunk_len: int = 512, mesh=None,
) -> Tuple[torch.Tensor, Cache]:
    """``prefill`` in fixed-size pieces: the prompt streams through
    ``decode_chunk`` (plain attention, the int8 kernel K2 for quantized
    weights at up to 256 rows a piece) ``piece_plan`` at a time.
    Numerics match ``prefill``'s masked path. With a sliding window,
    pieces are capped at the ring length."""
    if chunk_len < 1:
        raise ValueError("chunk_len must be >= 1")
    if tokens.shape[1] > max_len:
        raise ValueError(
            f"prompt_len {tokens.shape[1]} exceeds max_len {max_len}"
        )
    cache = init_cache(cfg, tokens.shape[0], max_len, device=tokens.device,
                       mesh=mesh)
    if cfg.window > 0:
        chunk_len = min(chunk_len, cache["k"].shape[2])
    return extend_pieces(params, cache, tokens, cfg, chunk_len, mesh)


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------

_MASK64 = (1 << 64) - 1


def _mix64(x: int) -> int:
    """splitmix64 finalizer: spreads (seed, row) into a generator seed."""
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def row_seed(seed: int, row: int) -> int:
    """The generator seed of row ``row`` of a request seeded ``seed``."""
    return _mix64(_mix64(int(seed) & _MASK64) ^ int(row)) >> 1


def row_generator(seed: int, row: int, device) -> torch.Generator:
    """The sampling generator of row ``row`` of a request seeded
    ``seed`` (the counterpart of ``fold_in(PRNGKey(seed), row)``). The
    slot engine re-seeds a slot's own generator with the same
    ``row_seed(seed, 0)`` at admission, so a request draws the same
    stream in a slot as in a solo ``generate``."""
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(row_seed(seed, row))
    return gen


def sample_logits(
    logits: torch.Tensor,
    generators: Sequence[torch.Generator],
    temperature: torch.Tensor,
    top_k: Optional[torch.Tensor] = None,
    top_p: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Sample token ids from [batch, vocab] logits with per-row knobs.

    Same filters as the reference: a row with temperature <= 0 takes the
    argmax; top-k keeps the k highest (k <= 0 keeps all; ties at the
    k-th value survive); nucleus keeps the smallest set reaching mass p
    (p outside (0, 1) keeps all); ``None`` skips a filter. The draw is
    the Gumbel-max form of a categorical draw, like
    ``jax.random.categorical``, with one [vocab] uniform block per row
    from that row's generator."""
    b, vocab = logits.shape
    dev = logits.device
    t = temperature.to(torch.float32).reshape(b, 1)
    raw = logits.float()
    x = raw / torch.clamp_min(t, 1e-6)
    if top_k is not None or top_p is not None:
        sorted_logits = torch.sort(x, dim=-1, descending=True).values
        keep = torch.ones_like(sorted_logits, dtype=torch.bool)
        ranks = torch.arange(vocab, device=dev)[None, :]
        if top_k is not None:
            k = top_k.reshape(b, 1)
            k = torch.where(k > 0, k, vocab)
            keep &= ranks < k
        if top_p is not None:
            p = top_p.to(torch.float32).reshape(b, 1)
            p = torch.where((p > 0.0) & (p < 1.0), p, 1.0)
            probs = torch.softmax(sorted_logits, dim=-1)
            keep &= (torch.cumsum(probs, dim=-1) - probs) < p
        threshold = torch.where(keep, sorted_logits, torch.inf).amin(
            dim=-1, keepdim=True
        )
        x = torch.where(x < threshold, NEG_INF, x)
    tiny = torch.finfo(torch.float32).tiny
    u = torch.stack([
        torch.rand(vocab, generator=g, device=dev) for g in generators
    ]).clamp_min(tiny)
    sampled = torch.argmax(x - torch.log(-torch.log(u)), dim=-1)
    return torch.where(t[:, 0] <= 0.0, torch.argmax(raw, dim=-1), sampled)


def mask_eos_before_min(
    logits: torch.Tensor, step_idx: int, min_new: torch.Tensor,
    eos_id: torch.Tensor,
) -> torch.Tensor:
    """NEG_INF the eos logit of rows still under their min_new floor
    (eos_id < 0 disables)."""
    b, vocab = logits.shape
    suppress = (step_idx < min_new) & (eos_id >= 0)
    eos_onehot = (
        torch.arange(vocab, device=logits.device)[None, :]
        == torch.clamp_min(eos_id, 0)[:, None]
    )
    return torch.where(suppress[:, None] & eos_onehot, NEG_INF, logits)


def apply_token_penalties(
    logits: torch.Tensor, counts: torch.Tensor,
    presence_penalty: torch.Tensor, frequency_penalty: torch.Tensor,
) -> torch.Tensor:
    """logit -= presence * (count > 0) + frequency * count, over the
    tokens GENERATED so far (counts [batch, vocab])."""
    pres = presence_penalty.to(torch.float32)[:, None]
    freq = frequency_penalty.to(torch.float32)[:, None]
    return logits - pres * (counts > 0) - freq * counts


BIAS_SLOTS = 16       # fast-path per-row logit_bias capacity
BIAS_SLOTS_MAX = 300  # OpenAI's documented logit_bias cap


def apply_logit_bias(
    logits: torch.Tensor, bias_idx: torch.Tensor, bias_val: torch.Tensor
) -> torch.Tensor:
    """Add bias_val[b, j] to token bias_idx[b, j]'s logit (-1 marks an
    unused slot)."""
    valid = bias_idx >= 0
    idx = torch.where(valid, bias_idx, 0)
    add = torch.zeros_like(logits).scatter_add_(
        1, idx, torch.where(valid, bias_val, 0.0).to(logits.dtype)
    )
    return logits + add


def count_token(
    counts: torch.Tensor, token: torch.Tensor, alive: torch.Tensor
) -> torch.Tensor:
    """counts[b, token[b]] += 1 for rows still alive."""
    vocab = counts.shape[1]
    onehot = (
        torch.arange(vocab, device=counts.device)[None, :] == token[:, None]
    ).to(counts.dtype)
    return counts + onehot * alive.to(counts.dtype)[:, None]


def seed_counts_row(vocab_size: int, first: torch.Tensor, eos_id) -> torch.Tensor:
    """The generated-token counts row right after sample 0: the drawn
    token (a device scalar) counts once unless it ended the row, as
    ``generate``'s loop counts it. Built on the device, so seeding a
    slot's counts needs no host round trip."""
    row = torch.zeros((vocab_size,), dtype=torch.float32, device=first.device)
    first = first.reshape(1).long()
    return row.scatter_(0, first, (first != eos_id).to(torch.float32))


def normalize_logit_bias(cfg, b: int, logit_bias, slots: int = None):
    """[b, K] (idx, val) numpy arrays from None, one {token: bias} dict
    for every row, or a per-row list of dicts (None entries allowed);
    unused slots carry idx -1. K is BIAS_SLOTS while every row fits it,
    else BIAS_SLOTS_MAX, unless ``slots`` pins it. Same validation and
    messages as the reference."""
    rows = []
    if logit_bias is not None:
        raw_rows = (
            logit_bias if isinstance(logit_bias, (list, tuple))
            else [logit_bias] * b
        )
        if len(raw_rows) != b:
            raise ValueError(f"logit_bias must be one dict or {b} rows")
        for entry in raw_rows:
            if entry is None:
                rows.append([])
                continue
            if not isinstance(entry, dict):
                raise ValueError("logit_bias rows must be dicts or None")
            try:
                items = sorted(
                    {int(t): float(v) for t, v in entry.items()}.items()
                )
            except (TypeError, ValueError):
                raise ValueError(
                    "logit_bias keys must be token ids and values numbers"
                ) from None
            for tok, bias in items:
                if not 0 <= tok < cfg.vocab_size:
                    raise ValueError(
                        f"logit_bias token ids must be in "
                        f"[0, {cfg.vocab_size})"
                    )
                if not abs(bias) <= 100:
                    raise ValueError(
                        "logit_bias values must be in [-100, 100]"
                    )
            rows.append(items)
    need = max((len(r) for r in rows), default=0)
    if slots is None:
        slots = BIAS_SLOTS if need <= BIAS_SLOTS else BIAS_SLOTS_MAX
    if need > slots:
        raise ValueError(f"logit_bias is capped at {slots} tokens per row")
    idx = np.full((b, slots), -1, np.int64)
    val = np.zeros((b, slots), np.float32)
    for r, items in enumerate(rows):
        for j, (tok, bias) in enumerate(items):
            idx[r, j] = tok
            val[r, j] = bias
    return idx, val


Rng = Union[None, int, Sequence[torch.Generator]]


def _normalize_sampling(cfg, b, max_new_tokens, temperature, rng, top_k,
                        top_p, eos_id, pad_id, min_new_tokens=0,
                        presence_penalty=0.0, frequency_penalty=0.0,
                        logit_bias=None, *, device):
    """Validate/broadcast the per-row knobs as ``generate`` documents ->
    (greedy, filtered, penalized, biased, operands dict of per-row
    tensors on ``device`` plus the row generators). Same checks and
    messages as the reference."""
    def row(v, dtype, name):
        arr = np.asarray(v, dtype)
        if arr.ndim == 0:
            arr = np.full((b,), arr)
        if arr.shape != (b,):
            raise ValueError(f"{name} must be a scalar or [batch] array")
        return arr

    t = row(temperature, np.float32, "temperature")
    k_arr = row(top_k, np.int64, "top_k")
    p_arr = row(top_p, np.float64, "top_p")
    eos_arr = row(eos_id, np.int64, "eos_id")
    pad_arr = row(pad_id, np.int64, "pad_id")
    if max_new_tokens < 1:
        raise ValueError("max_new_tokens must be >= 1")
    if (
        (k_arr < 0).any() or (k_arr > cfg.vocab_size).any()
        or (p_arr < 0.0).any() or (p_arr > 1.0).any()
    ):
        raise ValueError(
            f"top_k must be in [0, vocab {cfg.vocab_size}] and "
            "top_p in [0, 1]"
        )
    if (eos_arr >= cfg.vocab_size).any() or (
        (pad_arr < 0) | (pad_arr >= cfg.vocab_size)
    ).any():
        raise ValueError(
            f"eos_id (< 0 disables) and pad_id must be < vocab "
            f"{cfg.vocab_size}, pad_id non-negative"
        )
    if rng is None or isinstance(rng, (int, np.integer)):
        seed = 0 if rng is None else int(rng)
        generators = [row_generator(seed, i, device) for i in range(b)]
    else:
        generators = list(rng)
        if len(generators) != b:
            raise ValueError(f"rng must be one seed or {b} generators")
    min_arr = row(min_new_tokens, np.int64, "min_new_tokens")
    if (min_arr < 0).any() or (min_arr > max_new_tokens).any():
        raise ValueError(
            f"min_new_tokens must be in [0, max_new_tokens "
            f"{max_new_tokens}]"
        )
    pres_arr = row(presence_penalty, np.float32, "presence_penalty")
    freq_arr = row(frequency_penalty, np.float32, "frequency_penalty")
    if (np.abs(pres_arr) > 100).any() or (np.abs(freq_arr) > 100).any():
        raise ValueError("presence/frequency penalties must be in [-100, 100]")
    bias_idx, bias_val = normalize_logit_bias(cfg, b, logit_bias)
    greedy = bool((t <= 0.0).all())
    if greedy:
        k_arr = np.zeros_like(k_arr)
        p_arr = np.zeros_like(p_arr)
    filtered = bool(((k_arr > 0) | ((p_arr > 0.0) & (p_arr < 1.0))).any())
    penalized = bool(pres_arr.any() or freq_arr.any())
    biased = bool((bias_idx >= 0).any())

    def on(arr, dtype):
        return torch.as_tensor(arr).to(device=device, dtype=dtype)

    operands = {
        "generators": generators,
        "temperature": on(t, torch.float32),
        "top_k": on(k_arr, torch.int64),
        "top_p": on(p_arr.astype(np.float32), torch.float32),
        "eos_id": on(np.maximum(eos_arr, -1), torch.int64),
        "pad_id": on(pad_arr, torch.int64),
        "min_new": on(min_arr, torch.int64),
        "presence": on(pres_arr, torch.float32),
        "frequency": on(freq_arr, torch.float32),
        "bias_idx": on(bias_idx, torch.int64),
        "bias_val": on(bias_val, torch.float32),
    }
    return greedy, filtered, penalized, biased, operands


def _sampling_loop(params, cache, logits, cfg, max_new_tokens: int,
                   greedy: bool, filtered: bool, penalized: bool,
                   biased: bool, ops: Dict[str, Any],
                   mesh=None) -> torch.Tensor:
    """The shared decode loop (the reference's ``_sampling_scan``): from
    (cache, next-token logits) sample max_new_tokens with eos/pad
    handling -> [batch, max_new_tokens] int64. The early stop reads only
    the sampled tokens, which every rank of a mesh holds alike, so every
    rank takes it at the same step."""
    def sample(logits, step_idx, counts):
        if penalized:
            logits = apply_token_penalties(
                logits, counts, ops["presence"], ops["frequency"]
            )
        if biased:
            logits = apply_logit_bias(logits, ops["bias_idx"], ops["bias_val"])
        logits = mask_eos_before_min(
            logits, step_idx, ops["min_new"], ops["eos_id"]
        )
        if greedy:
            return torch.argmax(logits, dim=-1)
        return sample_logits(
            logits, ops["generators"], ops["temperature"],
            ops["top_k"] if filtered else None,
            ops["top_p"] if filtered else None,
        )

    eos_id, pad_id = ops["eos_id"], ops["pad_id"]
    counts = torch.zeros_like(logits, dtype=torch.float32) if penalized else None
    token = sample(logits, 0, counts)
    done = token == eos_id
    if penalized:
        counts = count_token(counts, token, ~done)
    out: List[torch.Tensor] = [token]
    can_stop = bool((eos_id >= 0).any())
    for step_idx in range(1, max_new_tokens):
        if can_stop and bool(done.all()):
            # every row emitted eos: the rest is pad, as the scan would say
            out.extend([pad_id] * (max_new_tokens - step_idx))
            break
        logits, cache = decode_step(params, cache, token, cfg, mesh)
        token = sample(logits, step_idx, counts)
        token = torch.where(done, pad_id, token)
        done = done | (token == eos_id)
        if penalized:
            counts = count_token(counts, token, ~done)
        out.append(token)
    return torch.stack(out, dim=1)


@torch.inference_mode()
def generate(
    params: Params,
    prompt: torch.Tensor,
    cfg: TransformerConfig,
    max_new_tokens: int,
    max_len: int,
    temperature=0.0,
    rng: Rng = None,
    top_k=0,
    top_p=0.0,
    eos_id=-1,
    pad_id=0,
    min_new_tokens=0,
    presence_penalty=0.0,
    frequency_penalty=0.0,
    logit_bias=None,
    mesh=None,
) -> torch.Tensor:
    """Autoregressive generation. prompt: [batch, prompt_len] integer
    tensor on the params' device; returns [batch, max_new_tokens] int64.

    The reference's contract: every knob is a scalar or a per-row
    sequence; temperature <= 0 rows decode greedily; top_k/top_p filter;
    eos_id >= 0 stops a row (pad after it); min_new_tokens floors eos;
    presence/frequency penalties count GENERATED tokens; logit_bias is
    one {token: bias} dict or a per-row list. ``rng`` is a seed (rows
    seeded from (seed, row)), per-row torch.Generators, or None (seed
    0). ``mesh``: the params are this rank's blocks (every rank calls
    it with the same arguments)."""
    device = params["norm_out"].device
    ops_tuple = _normalize_sampling(
        cfg, prompt.shape[0], max_new_tokens, temperature, rng, top_k,
        top_p, eos_id, pad_id, min_new_tokens, presence_penalty,
        frequency_penalty, logit_bias, device=device,
    )
    if prompt.shape[1] + max_new_tokens > max_len:
        raise ValueError(
            f"prompt_len {prompt.shape[1]} + max_new_tokens "
            f"{max_new_tokens} exceeds max_len {max_len}"
        )
    greedy, filtered, penalized, biased, ops = ops_tuple
    logits, cache = prefill(params, prompt.to(device), cfg, max_len, mesh)
    return _sampling_loop(
        params, cache, logits, cfg, max_new_tokens, greedy, filtered,
        penalized, biased, ops, mesh,
    )


@torch.inference_mode()
def generate_from_cache(
    params: Params,
    cache: Cache,
    logits: torch.Tensor,
    cfg: TransformerConfig,
    max_new_tokens: int,
    temperature=0.0,
    rng: Rng = None,
    top_k=0,
    top_p=0.0,
    eos_id=-1,
    pad_id=0,
    min_new_tokens=0,
    presence_penalty=0.0,
    frequency_penalty=0.0,
    logit_bias=None,
    mesh=None,
) -> torch.Tensor:
    """``generate`` from an existing (cache, next-token logits [b,
    vocab]) pair: the prefix-cache and chunked-prefill serving paths
    (the caller restored, extended or streamed the prompt's cache). Same
    sampling contract as ``generate``; the cache is decoded into in
    place. Raises when the decode would run past the cache's length: a
    linear cache, or a TRUNCATED ring (``window > max_len`` shrank it to
    ``max_len`` slots, so wrapping would overwrite keys still inside the
    window). A full ring (length == window) decodes past its length:
    every slot it overwrites is already outside the window."""
    length = cache["k"].shape[2]
    if (cfg.window <= 0 or length < cfg.window) and (
            cache["pos"] + max_new_tokens > length):
        raise ValueError(
            f"cache pos {cache['pos']} + max_new_tokens {max_new_tokens} "
            f"exceeds cache length {length}"
        )
    greedy, filtered, penalized, biased, ops = _normalize_sampling(
        cfg, logits.shape[0], max_new_tokens, temperature, rng, top_k,
        top_p, eos_id, pad_id, min_new_tokens, presence_penalty,
        frequency_penalty, logit_bias, device=logits.device,
    )
    return _sampling_loop(
        params, cache, logits, cfg, max_new_tokens, greedy, filtered,
        penalized, biased, ops, mesh,
    )
