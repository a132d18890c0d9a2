"""Beam-search decoding over the KV cache (counterpart of
``containerpilot_tpu/models/beam.py``).

The beam IS the batch axis: the prompt prefills once (batch 1), the
cache tiles to ``beam_width`` rows, and every step is one batched
``decode_step`` over the beams (on the card, K2 at m = beam_width under
int8 weights). Beam reordering gathers axis 1 of every cache leaf.

Finished beams (emitted eos) are frozen: they can only extend with
``pad_id`` at zero added log-probability (every other token at
NEG_INF), so finished candidates keep competing on their final scores.
``length_penalty`` rescales scores by ``((5 + len) / 6) ** alpha``
(GNMT); 0 disables.

Intended differences from the reference:

- The step loop is an eager Python loop over ``decode_step``, not one
  compiled scan; it runs every step, as the scan does, and syncs with
  the host only at the end.
- ``lax.top_k`` puts the lower index first among equal values, which
  ``torch.topk`` does not promise; the beams are chosen by a stable
  descending sort instead, so the same tokens come out.
- A gather builds new cache leaves (``index_select``) where XLA reuses
  the buffers; the old leaves are freed as the new ones are made.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..ops.attention import NEG_INF
from .decode import Cache, chunked_prefill, decode_step, prefill
from .transformer import Params, TransformerConfig


def _gather_beams(cache: Cache, idx: torch.Tensor) -> Cache:
    """Reorder the beam axis of every cache leaf: k/v and, under
    kv_int8, their scales carry the batch/beam on axis 1; ``pos`` is a
    position, shared by every beam."""
    return {
        name: (arr if name == "pos" else arr.index_select(1, idx))
        for name, arr in cache.items()
    }


def _top(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest entries of a 1-D tensor, lower index first among
    equal values (``lax.top_k``'s order) -> (values, indices)."""
    values, indices = torch.sort(scores, descending=True, stable=True)
    return values[:k], indices[:k]


def _penalize(scores: torch.Tensor, lengths: torch.Tensor,
              length_penalty: float) -> torch.Tensor:
    if length_penalty <= 0.0:
        return scores
    return scores / (((5.0 + lengths) / 6.0) ** length_penalty)


def _beam_loop(params: Params, cache: Cache, logits: torch.Tensor,
               cfg: TransformerConfig, max_new_tokens: int,
               beam_width: int, eos_id: int, pad_id: int,
               length_penalty: float):
    """From a batch-1 (cache, next-token logits) -> (best tokens
    [max_new_tokens] int64, its score, a 0-d tensor)."""
    dev = logits.device
    logp = torch.log_softmax(logits.float(), dim=-1)
    # first expansion: the top beam_width continuations of the prompt
    scores, first = _top(logp[0], beam_width)
    cache = _gather_beams(
        cache, torch.zeros((beam_width,), dtype=torch.int64, device=dev)
    )
    done = first == eos_id
    tokens = torch.full((beam_width, max_new_tokens), pad_id,
                        dtype=torch.int64, device=dev)
    tokens[:, 0] = first
    vocab = logits.shape[-1]
    # a finished beam: only pad survives, at an unchanged score
    frozen = torch.full((vocab,), NEG_INF, dtype=torch.float32, device=dev)
    frozen[pad_id] = 0.0
    last = first
    for step_idx in range(1, max_new_tokens):
        logits, cache = decode_step(params, cache, last, cfg)
        logp = torch.log_softmax(logits.float(), dim=-1)  # [beam, vocab]
        logp = torch.where(done[:, None], frozen[None, :], logp)
        total = scores[:, None] + logp
        scores, flat_idx = _top(total.reshape(-1), beam_width)
        parent = torch.div(flat_idx, vocab, rounding_mode="floor")
        token = flat_idx % vocab
        cache = _gather_beams(cache, parent)
        tokens = tokens[parent]
        tokens[:, step_idx] = token
        done = done[parent] | (token == eos_id)
        last = token
    lengths = torch.where(
        done,
        torch.argmax((tokens == eos_id).to(torch.int64), dim=1) + 1,
        max_new_tokens,
    ).to(torch.float32)
    final = _penalize(scores, lengths, length_penalty)
    best = torch.argmax(final)
    return tokens[best], final[best]


def validate_beam_args(cfg: TransformerConfig, n_rows: int,
                       beam_width: int) -> None:
    """The request-shape rules shared by ``beam_search`` and the serving
    handler (the reference's wording): a single row, a width within the
    vocab, no sliding window (the frozen-beam bookkeeping is not
    validated against a ring's wraparound)."""
    if n_rows != 1:
        raise ValueError("beam search decodes one prompt at a time")
    if not 1 <= beam_width <= cfg.vocab_size:
        raise ValueError(
            f"beam_width must be in [1, vocab {cfg.vocab_size}]"
        )
    if cfg.window > 0:
        raise ValueError(
            "beam search does not support sliding-window configs yet"
        )


@torch.inference_mode()
def beam_search(
    params: Params,
    prompt: torch.Tensor,
    cfg: TransformerConfig,
    max_new_tokens: int,
    max_len: int,
    beam_width: int = 4,
    eos_id: int = -1,
    pad_id: int = 0,
    length_penalty: float = 0.0,
    prefill_chunk: int = 0,
) -> Tuple[torch.Tensor, float]:
    """Deterministic beam search; ``prompt`` is [1, prompt_len] on the
    params' device. Returns (tokens [max_new_tokens] int64, score): the
    highest-scoring beam, padded with ``pad_id`` past its eos.
    ``beam_width=1`` is greedy ``generate``. ``prefill_chunk > 0``
    streams a longer prompt through ``chunked_prefill``."""
    validate_beam_args(cfg, prompt.shape[0], beam_width)
    if max_new_tokens < 1:
        raise ValueError("max_new_tokens must be >= 1")
    if prompt.shape[1] + max_new_tokens > max_len:
        raise ValueError(
            f"prompt_len {prompt.shape[1]} + max_new_tokens "
            f"{max_new_tokens} exceeds max_len {max_len}"
        )
    if not 0 <= pad_id < cfg.vocab_size or eos_id >= cfg.vocab_size:
        raise ValueError(
            f"pad_id must be in [0, vocab {cfg.vocab_size}) and "
            f"eos_id < vocab (eos < 0 disables)"
        )
    prompt = prompt.to(params["norm_out"].device)
    if prefill_chunk > 0 and prompt.shape[1] > prefill_chunk:
        logits, cache = chunked_prefill(params, prompt, cfg, max_len,
                                        prefill_chunk)
    else:
        logits, cache = prefill(params, prompt, cfg, max_len)
    tokens, score = _beam_loop(
        params, cache, logits, cfg, max_new_tokens, beam_width,
        int(eos_id), int(pad_id), float(length_penalty),
    )
    return tokens, float(score)

