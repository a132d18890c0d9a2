"""Non-batched decode strategies for the inference server (counterpart
of ``containerpilot_tpu/workload/serve_strategies.py``): chunked
prefill only so far. Beam search and context-parallel prefill are not
ported yet (ROADMAP.md queue 1)."""
from __future__ import annotations

from typing import Any, List

import torch


@torch.inference_mode()
def run_chunked(
    srv: Any, tokens: List[List[int]], prompt_len: int, max_new: int,
    temperature: float, top_k: int, top_p: float, eos_id: int, seed: int,
    min_new: int = 0,
    presence: float = 0.0,
    frequency: float = 0.0,
    logit_bias: Any = None,
) -> List[List[int]]:
    """Long single-row prompt: stream the prefill in pieces (peak
    prefill activations O(chunk) instead of O(prompt)), then decode with
    the server's sampling convention (row 0 of ``seed``). Runs on the
    inference thread."""
    from ..models.decode import generate_from_cache, row_generator
    from .serve_prefix import prefill_row

    logits, cache = prefill_row(
        None, tokens[0], srv.cfg, srv.params, srv.max_len,
        srv.prefill_chunk,
    )
    srv.batch_stats["calls"] += 1
    srv.batch_stats["rows"] += 1
    out = generate_from_cache(
        srv.params, cache, logits, srv.cfg,
        max_new_tokens=max_new, temperature=temperature,
        rng=[row_generator(seed, 0, logits.device)],
        top_k=top_k, top_p=top_p, eos_id=eos_id,
        min_new_tokens=min_new, presence_penalty=presence,
        frequency_penalty=frequency, logit_bias=logit_bias,
    )
    return out.tolist()
