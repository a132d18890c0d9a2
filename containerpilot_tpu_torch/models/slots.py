"""Slot-based continuous decode (counterpart of
``containerpilot_tpu/models/slots.py``): a fixed pool of S slots, each
owning one cache row and its own position, advanced together one token
a step, so a request joins a running decode at the next chunk boundary.

Intended differences from the reference:

- Everything is updated IN PLACE: the pool cache (k/v [L, S, kv,
  length, hd], pos [S]) and the per-slot sampling state are static device
  buffers, which is what lets the step program (``stepprog.py``) capture
  the step in a CUDA graph and replay it.
- The S rows are one batch of the decode step (``decode_slots_logits``),
  not a vmap of the single-row step: every projection is one [S, d]
  product (the int8 kernel K2 at m = S), and each row's RoPE, k/v write
  and attention mask use that row's own position. Attention runs over
  the full row length (``max_len``, or a window's ring) masked per row
  (the shape stays static). The pool keeps heads before positions (k/v
  [L, S, kv, length, hd]; under ``kv_int8`` int8 with float32 scales
  [L, S, kv, length]).
- A step writes each row's new k/v first and then reads the row at one
  query, where the reference's ring step concatenates the new k/v after
  the ring. The two agree because the slot overwritten (position
  ``pos - length``) is outside the window of a full ring, and a
  truncated ring (window > max_len) never wraps: the engine refuses a
  request that would decode past its length.
- ``state["keys"]`` holds one ``torch.Generator`` per slot (the
  reference's per-slot PRNG keys). Admission re-seeds the slot's
  generator with ``row_seed(seed, 0)``, the seed a solo ``generate``
  gives row 0, and every step draws one [vocab] block from each slot's
  generator, as ``generate`` does, so a request samples the same stream
  in a slot as alone.
- The window's early exit is a device-side live flag, not a loop exit:
  ``round_step`` gated by ``live`` keeps last/done/pos/step_idx/counts
  and emits pad when no slot is live (``~done & run*chunk < budget``),
  so K gated rounds give the reference's while-loop result with
  ``rounds_run`` counted on the device. Rounds past the exit still
  compute (and draw) but change nothing a live request reads.

On a mesh (``mesh=``, serving over ranks) the pool holds the rank's kv
heads (``decode.cache_kv_heads``), the step runs the rank's blocks of
the params with the tensor-parallel collectives, and the logits are
gathered whole before sampling, so every rank's slots draw the same
tokens.

Dead slots (finished, not yet reused) keep decoding garbage; their k/v
writes clamp to the row's last position (a ring's wrap within the row)
and the row is overwritten wholesale by the next admission
(``insert_row``).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

from .. import resolve_device
from ..ops.attention import NEG_INF
from .decode import (
    BIAS_SLOTS_MAX,
    Cache,
    _logits,
    cache_kv_heads,
    apply_logit_bias,
    apply_token_penalties,
    count_token,
    kv_dequant,
    kv_leaves,
    layer_out,
    mask_eos_before_min,
    ring_length,
    row_seed,
    sample_logits,
    seed_counts_row,
)
from .quantized import (
    can_fuse_int8,
    fused_qkv,
    maybe_dequant_layer,
)
from .transformer import (
    Params,
    TransformerConfig,
    _qkv,
    embed,
    layer_params,
)

# The per-slot sampling state carried between chunk rounds: everything
# the step reads besides params and the pool. It changes only at
# admission (one row) and retirement (one done flag); step_idx, last,
# done and counts advance inside the step.
SLOT_STATE_KEYS = (
    "last", "keys", "step_idx", "temperature", "top_k", "top_p",
    "eos_id", "pad_id", "min_new", "presence", "frequency",
    "bias_idx", "bias_val", "counts", "done",
)


def append_chunk(emitted, toks, max_new: int, eos_id: int) -> bool:
    """The one chunk-append convention of the slot engine: append
    ``toks`` into ``emitted`` capped at ``max_new``, stopping at eos
    inclusive. Returns whether the row ended."""
    for t in toks:
        if len(emitted) >= max_new:
            break
        emitted.append(int(t))
        if int(t) == eos_id:
            break
    return (
        len(emitted) >= max_new
        or (eos_id >= 0 and eos_id in emitted)
    )


@torch.inference_mode()
def init_slot_state(cfg: TransformerConfig, slots: int, device="cuda") -> dict:
    """Fresh per-slot sampling state on ``device`` (all slots empty,
    hence done). See SLOT_STATE_KEYS."""
    dev = resolve_device(device)

    def full(shape, value, dtype):
        return torch.full(shape, value, dtype=dtype, device=dev)

    keys = [torch.Generator(device=dev) for _ in range(slots)]
    for g in keys:
        g.manual_seed(0)
    return {
        "last": full((slots,), 0, torch.int64),
        "keys": keys,
        "step_idx": full((slots,), 0, torch.int64),
        "temperature": full((slots,), 0.0, torch.float32),
        "top_k": full((slots,), 0, torch.int64),
        "top_p": full((slots,), 0.0, torch.float32),
        "eos_id": full((slots,), -1, torch.int64),
        "pad_id": full((slots,), 0, torch.int64),
        "min_new": full((slots,), 0, torch.int64),
        "presence": full((slots,), 0.0, torch.float32),
        "frequency": full((slots,), 0.0, torch.float32),
        "bias_idx": full((slots, BIAS_SLOTS_MAX), -1, torch.int64),
        "bias_val": full((slots, BIAS_SLOTS_MAX), 0.0, torch.float32),
        "counts": full((slots, cfg.vocab_size), 0.0, torch.float32),
        "done": full((slots,), True, torch.bool),
    }


@torch.inference_mode()
def clear_slot_state(state: dict) -> None:
    """Bring a state dict back to ``init_slot_state``'s values in place
    (its buffers keep their addresses, which a captured graph holds)."""
    for name, value in (
        ("last", 0), ("step_idx", 0), ("temperature", 0.0), ("top_k", 0),
        ("top_p", 0.0), ("eos_id", -1), ("pad_id", 0), ("min_new", 0),
        ("presence", 0.0), ("frequency", 0.0), ("bias_idx", -1),
        ("bias_val", 0.0), ("counts", 0.0), ("done", True),
    ):
        state[name].fill_(value)
    for g in state["keys"]:
        g.manual_seed(0)


def seed_slot(state: dict, slot: int, seed: int) -> torch.Generator:
    """Re-seed ``slot``'s generator for a request seeded ``seed`` (the
    stream ``row_generator(seed, 0)`` gives a solo ``generate``) and
    return it; ``first_sample`` draws token 0 from it."""
    gen = state["keys"][slot]
    gen.manual_seed(row_seed(seed, 0))
    return gen


@torch.inference_mode()
def admit_slot_state(
    state: dict, slot: int, cfg: TransformerConfig, *,
    last, temperature, top_k, top_p, eos_id, pad_id, min_new, presence,
    frequency, bias_idx, bias_val, done, step_idx: int = 1,
) -> dict:
    """Write one admitted request's sampling knobs into row ``slot`` of
    every state leaf, in place. ``last`` is the first sampled token (a
    device scalar or an int); the slot's counts row seeds from it on the
    device. The slot's generator was re-seeded by ``seed_slot`` before
    token 0 was drawn."""
    dev = state["last"].device
    last = torch.as_tensor(last, device=dev).reshape(())
    state["last"][slot] = last
    for name, value in (
        ("step_idx", step_idx), ("temperature", temperature),
        ("top_k", top_k), ("top_p", top_p), ("eos_id", eos_id),
        ("pad_id", pad_id), ("min_new", min_new), ("presence", presence),
        ("frequency", frequency), ("done", bool(done)),
    ):
        state[name][slot] = value
    for name, row in (("bias_idx", bias_idx), ("bias_val", bias_val)):
        state[name][slot].copy_(
            torch.as_tensor(row, dtype=state[name].dtype).reshape(-1)
        )
    state["counts"][slot] = seed_counts_row(cfg.vocab_size, last, eos_id)
    return state


@torch.inference_mode()
def retire_slot(state: dict, slot: int) -> dict:
    """Mark ``slot`` done (harvested or cancelled): it emits pad from
    here until re-admission. Only the done leaf is touched."""
    state["done"][slot] = True
    return state


@torch.inference_mode()
def slot_cache(cfg: TransformerConfig, slots: int, max_len: int,
               device="cuda", mesh=None) -> Cache:
    """A pool of ``slots`` cache rows: k/v [layers, S, kv_heads, length,
    head_dim], zeroed, with ``length`` = ``max_len`` or a window's ring
    (``min(window, max_len)``), in the compute dtype or, under
    ``kv_int8``, int8 with float32 ``k_scale``/``v_scale`` [layers, S,
    kv_heads, length]; and ``pos`` [S] int64 on the device (each row's
    tokens cached). Heads come before positions (``prefill``'s row cache
    is [layers, 1, length, kv_heads, head_dim]) so every head's keys are
    one contiguous [length, head_dim] block: the pool attention's
    products read them in place, where a position-major pool would be
    copied to that order every step. On a mesh, kv_heads is
    ``cache_kv_heads``."""
    dev = resolve_device(device)
    shape = (cfg.n_layers, slots, cache_kv_heads(cfg, mesh),
             ring_length(cfg, max_len), cfg.head_dim)
    pool: Cache = {}
    for name in ("k", "v"):
        if cfg.kv_int8:
            pool[name] = torch.zeros(shape, dtype=torch.int8, device=dev)
            pool[f"{name}_scale"] = torch.zeros(
                shape[:-1], dtype=torch.float32, device=dev)
        else:
            pool[name] = torch.zeros(shape, dtype=cfg.dtype, device=dev)
    pool["pos"] = torch.zeros((slots,), dtype=torch.int64, device=dev)
    return pool


@torch.inference_mode()
def insert_row(pool: Cache, row: Cache, slot: int) -> Cache:
    """Copy a freshly prefilled single-row cache (``prefill``'s layout,
    pos a Python int) into ``slot``, WHOLESALE: the full row (ring and
    scales included) and its position, so a reused slot holds nothing
    of its previous occupant, and the pool never aliases the row (a
    prefix-cache entry stays standalone)."""
    if row["k"].shape[2] != pool["k"].shape[3]:
        raise ValueError(
            f"row cache length {row['k'].shape[2]} != pool length "
            f"{pool['k'].shape[3]}"
        )
    for name in pool:
        if name != "pos":
            # [L, 1, length, kv, ...] -> [L, kv, length, ...]
            pool[name][:, slot].copy_(row[name][:, 0].transpose(1, 2))
    pool["pos"][slot] = int(row["pos"])
    return pool


def pool_mask(pos: torch.Tensor, length: int,
              cfg: TransformerConfig) -> torch.Tensor:
    """The keys each row's query at ``pos`` [S] sees, after the step
    wrote its own k/v -> [S, 1, 1, length] bool, from device tensors
    only (a captured graph replays it at every position). Linear: slots
    ``<= pos``. A ring: slot j holds position ``pos - ((pos - j) mod
    length)`` (negative = never written), kept inside the window."""
    key = torch.arange(length, device=pos.device)[None, :]
    if cfg.window <= 0:
        valid = key <= pos[:, None]
    else:
        held = pos[:, None] - torch.remainder(pos[:, None] - key, length)
        valid = (held >= 0) & (held > pos[:, None] - cfg.window)
    return valid[:, None, None, :]


@torch.inference_mode()
def decode_slots_logits(
    params: Params, pool: Cache, tokens: torch.Tensor,
    cfg: TransformerConfig, mesh=None,
) -> torch.Tensor:
    """One decode step of the whole pool: tokens [S] (slot i's token at
    position pool['pos'][i]) -> logits [S, vocab] float32. Writes each
    row's k/v at its own position, in place (quantized under
    ``kv_int8``; a linear row clamps at its last position, which only a
    dead slot reaches; a ring row writes slot ``pos % length``), and
    does NOT advance pos (``round_step`` does). The arithmetic is
    ``decode_chunk``'s at m = 1 per row (``pool_attention``), over the
    full row length masked by ``pool_mask``; on the card the
    projections are one [S, d] product each (K2 at m = S for quantized
    weights)."""
    pos = pool["pos"]
    _layers, slots, kvh, length, hd = pool["k"].shape
    dev = tokens.device
    x = embed(params, tokens[:, None], cfg, mesh)  # [S, 1, d]
    valid = pool_mask(pos, length, cfg)
    at = (torch.remainder(pos, length) if cfg.window > 0
          else torch.clamp(pos, max=length - 1))
    # row (slot, head, position) of the pool's [S * kv * length, ...] view
    rows = (
        (torch.arange(slots, device=dev)[:, None] * kvh
         + torch.arange(kvh, device=dev)[None, :]) * length
        + at[:, None]
    ).reshape(-1)
    fused = can_fuse_int8(params["layers"], cfg, rows=slots)
    for i in range(cfg.n_layers):
        lp = layer_params(params, i)
        if fused:
            q, k, v = fused_qkv(x, lp, cfg, offset=pos, mesh=mesh)
        else:
            lp = maybe_dequant_layer(lp, cfg.dtype)
            q, k, v = _qkv(x, lp, cfg, offset=pos, mesh=mesh)
        for name, value in kv_leaves(cfg, k, v).items():
            flat = pool[name][i].view(-1, *value.shape[3:])
            flat.index_copy_(0, rows, value.reshape(-1, *value.shape[3:]))
        keys, values = pool["k"][i], pool["v"][i]
        if cfg.kv_int8:
            keys = kv_dequant(keys, pool["k_scale"][i], cfg.dtype)
            values = kv_dequant(values, pool["v_scale"][i], cfg.dtype)
        attn = pool_attention(q, keys, values, valid, cfg)
        x = layer_out(x, attn, lp, cfg, fused, mesh)
    return _logits(params, x, cfg, mesh)[:, 0, :]


def pool_attention(
    q: torch.Tensor, keys: torch.Tensor, values: torch.Tensor,
    valid: torch.Tensor, cfg: TransformerConfig,
) -> torch.Tensor:
    """``decode_chunk``'s attention at one query a row, on the pool's
    head-major layout: q [S, 1, h, hd] (the rank's heads on a mesh),
    keys/values [S, kv, length, hd] in the compute dtype, ``valid``
    [S, 1, 1, length]. The same arithmetic: float32 scores from
    q * hd**-0.5 and float32 keys, NEG_INF mask, float32 softmax cast to
    the compute dtype, value product with float32 accumulation; query
    head j = kv * group + g reads kv head j // group."""
    slots, kvh, _length, hd = keys.shape
    qg = (q.float() * hd ** -0.5).reshape(slots, kvh, -1, hd)
    scores = torch.matmul(qg, keys.float().transpose(-1, -2))
    scores = torch.where(valid, scores, NEG_INF)
    weights = torch.softmax(scores, dim=-1).to(cfg.dtype)
    attn = torch.matmul(weights, values)  # [S, kv, group, hd]
    return attn.to(cfg.dtype).reshape(slots, 1, q.shape[2], hd)


@torch.inference_mode()
def round_step(
    params: Params, pool: Cache, state: dict, cfg: TransformerConfig,
    live: torch.Tensor, mesh=None,
) -> torch.Tensor:
    """THE per-token step body (the reference's ``_round_step_body``)
    shared by the chunk and the window programs, so a window is the
    same computation as K chunks by construction. For every slot at
    once: the decode step, then penalties, logit_bias, the min_new eos
    mask, the sample, pad after done, done, counts, and step_idx/pos
    + 1 — all in place. Returns the emitted tokens [S].

    ``live`` (a device bool scalar): when false the step keeps
    last/done/counts/step_idx/pos and emits pad. The k/v write at the
    unchanged position is harmless: the next real step overwrites it
    before anything reads it."""
    logits = decode_slots_logits(params, pool, state["last"], cfg, mesh)
    idx = state["step_idx"]
    masked = apply_token_penalties(
        logits, state["counts"], state["presence"], state["frequency"]
    )
    # always on (one program for every request): unused entries (idx -1)
    # add exactly zero
    masked = apply_logit_bias(masked, state["bias_idx"], state["bias_val"])
    masked = mask_eos_before_min(
        masked, idx, state["min_new"], state["eos_id"]
    )
    nxt = sample_logits(
        masked, state["keys"], state["temperature"], state["top_k"],
        state["top_p"],
    )
    pad, done = state["pad_id"], state["done"]
    nxt = torch.where(done, pad, nxt)
    new_done = done | (nxt == state["eos_id"])
    counts = count_token(state["counts"], nxt, ~new_done)
    state["last"].copy_(torch.where(live, nxt, state["last"]))
    state["done"].copy_(torch.where(live, new_done, done))
    state["counts"].copy_(torch.where(live, counts, state["counts"]))
    step = live.to(torch.int64)
    state["step_idx"].add_(step)
    pool["pos"].add_(step)
    return torch.where(live, nxt, pad)


@torch.inference_mode()
def window_buffers(slots: int, chunk: int, rounds: int, device) -> dict:
    """The window program's own device buffers: the budget gate [S], the
    rounds run so far (scalar), the force flag (a chunk dispatch always
    runs its round) and the token block [S, rounds * chunk]."""
    dev = resolve_device(device)
    return {
        "budget": torch.zeros((slots,), dtype=torch.int64, device=dev),
        "run": torch.zeros((), dtype=torch.int64, device=dev),
        "force": torch.zeros((), dtype=torch.bool, device=dev),
        "toks": torch.zeros((slots, rounds * chunk), dtype=torch.int64,
                            device=dev),
        "cols": torch.arange(chunk, device=dev),
    }


@torch.inference_mode()
def begin_window(state: dict, win: dict, force: bool) -> None:
    """Start a dispatch: no rounds run yet, every token column pad."""
    win["run"].zero_()
    win["force"].fill_(force)
    win["toks"].copy_(state["pad_id"][:, None].expand_as(win["toks"]))


@torch.inference_mode()
def gated_round(
    params: Params, pool: Cache, state: dict, cfg: TransformerConfig,
    chunk: int, win: dict, mesh=None,
) -> None:
    """One chunk-round of the window program, with the early exit on the
    device: the round is live when forced or when some slot is not done
    and still has budget (``~done & run * chunk < budget``, the
    reference's while-loop test). A live round advances the state
    ``chunk`` steps and writes its tokens at columns ``run * chunk``;
    a round that is not live changes nothing and leaves pad. ``run``
    counts the rounds that ran. The unit a CUDA graph captures."""
    live = win["force"] | (
        ~state["done"] & (win["run"] * chunk < win["budget"])
    ).any()
    toks = [round_step(params, pool, state, cfg, live, mesh)
            for _ in range(chunk)]
    win["toks"].index_copy_(
        1, win["run"] * chunk + win["cols"], torch.stack(toks, dim=1)
    )
    win["run"].add_(live.to(torch.int64))


@torch.inference_mode()
def decode_slots_chunk(
    params: Params, pool: Cache, state: dict, cfg: TransformerConfig,
    chunk: int, mesh=None,
) -> Tuple[Cache, dict, torch.Tensor]:
    """Advance the whole pool ``chunk`` tokens, unconditionally, in
    place; returns (pool, state, tokens [S, chunk]). Eager: the step
    program replays the same rounds from a captured graph on the card."""
    slots = state["last"].shape[0]
    win = window_buffers(slots, chunk, 1, state["last"].device)
    begin_window(state, win, force=True)
    gated_round(params, pool, state, cfg, chunk, win, mesh)
    return pool, state, win["toks"]


@torch.inference_mode()
def decode_slots_window(
    params: Params, pool: Cache, state: dict, cfg: TransformerConfig,
    chunk: int, rounds: int, budget: Sequence[int], mesh=None,
) -> Tuple[Cache, dict, torch.Tensor, torch.Tensor]:
    """Advance the pool up to ``rounds`` chunk-rounds with the early exit
    (``gated_round``): ``budget`` [S] is each slot's remaining max_new
    allowance, which gates only the exit test, never the emission.
    Returns (pool, state, tokens [S, rounds*chunk], rounds_run as a
    device scalar); rounds not run leave pad and the state advances by
    exactly rounds_run chunks."""
    slots = state["last"].shape[0]
    win = window_buffers(slots, chunk, rounds, state["last"].device)
    win["budget"].copy_(torch.as_tensor(budget, dtype=torch.int64))
    begin_window(state, win, force=False)
    for _ in range(rounds):
        gated_round(params, pool, state, cfg, chunk, win, mesh)
    return pool, state, win["toks"], win["run"]


@torch.inference_mode()
def first_sample(
    logits: torch.Tensor, generator: torch.Generator, temperature, top_k,
    top_p, eos_id: int = -1, min_new: int = 0, bias_idx=None,
    bias_val=None,
) -> torch.Tensor:
    """Token 0 from prefill logits [1, vocab] -> a device scalar, as
    ``generate`` samples it: logit_bias, the min_new eos mask at step 0,
    then one draw from ``generator`` (counts are empty at sample 0, so
    penalties are a no-op)."""
    dev = logits.device

    def row(v, dtype):
        return torch.as_tensor(v, dtype=dtype).reshape(1).to(dev)

    if bias_idx is None:
        bias_idx = [-1] * BIAS_SLOTS_MAX
        bias_val = [0.0] * BIAS_SLOTS_MAX
    masked = apply_logit_bias(
        logits.float(),
        torch.as_tensor(bias_idx, dtype=torch.int64).reshape(1, -1).to(dev),
        torch.as_tensor(bias_val, dtype=torch.float32).reshape(1, -1).to(dev),
    )
    masked = mask_eos_before_min(
        masked, 0, row(min_new, torch.int64), row(eos_id, torch.int64)
    )
    return sample_logits(
        masked, [generator], row(temperature, torch.float32),
        row(top_k, torch.int64), row(top_p, torch.float32),
    )[0]
