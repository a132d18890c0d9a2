"""Non-batched decode strategies for the inference server (counterpart
of ``containerpilot_tpu/workload/serve_strategies.py``): beam search,
context-parallel prefill and chunked prefill. Each runs on the inference
thread (on every rank under a lockstep, parallel/serving.py; beams are
not ported there yet) and returns the generated rows; speculative
decoding rides a slot engine (serve_slots.py)."""
from __future__ import annotations

from typing import Any, List

import torch


def run_beam(
    srv: Any, tokens: List[List[int]], max_new_requested: int,
    beam_width: int, eos_id: int, length_penalty: float,
) -> List[List[int]]:
    """One prompt row through ``beam_search`` at the requested length
    (a beam's best 16 tokens do not start with its best 6, so the
    length is never bucketed)."""
    from ..models.beam import beam_search

    out, _score = beam_search(
        srv.params, torch.tensor(tokens, dtype=torch.int64,
                                 device=srv.device),
        srv.cfg, max_new_tokens=max_new_requested, max_len=srv.max_len,
        beam_width=beam_width, eos_id=eos_id,
        length_penalty=length_penalty, prefill_chunk=srv.prefill_chunk,
    )
    srv.batch_stats["calls"] += 1
    srv.batch_stats["rows"] += 1
    return [out.tolist()]


def _record(srv: Any, out: List[List[int]]) -> List[List[int]]:
    lockstep = getattr(srv, "lockstep", None)
    if lockstep is not None:
        lockstep.record_tokens(out)
    return out


@torch.inference_mode()
def run_cp(srv: Any, tokens: List[List[int]], p: dict) -> List[List[int]]:
    """Context-parallel prefill for one long row: ring attention over the
    server's seq mesh, the cache gathered once, then the normal decode
    (``parallel.cp_generate``) with the server's sampling convention
    (row 0 of the request's seed)."""
    from ..models.decode import row_generator
    from ..parallel.context import cp_generate

    srv.batch_stats["calls"] += 1
    srv.batch_stats["rows"] += 1
    out = cp_generate(
        srv.params, torch.tensor(tokens, dtype=torch.int64), srv.cfg,
        srv.cp_mesh, p["max_new"], srv.max_len,
        temperature=p["temperature"],
        rng=[row_generator(p["seed"], 0, srv.device)],
        top_k=p["top_k"], top_p=p["top_p"], eos_id=p["eos_id"],
        min_new_tokens=p["min_new"], presence_penalty=p["presence"],
        frequency_penalty=p["frequency"], logit_bias=p["logit_bias"],
    )
    return _record(srv, out.tolist())


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

    mesh = getattr(srv, "mesh", None)
    logits, cache = prefill_row(
        None, tokens[0], srv.cfg, srv.params, srv.max_len,
        srv.prefill_chunk, mesh,
    )
    srv.batch_stats["calls"] += 1
    srv.batch_stats["rows"] += 1
    out = generate_from_cache(
        srv.params, cache, logits, srv.cfg,
        max_new_tokens=max_new, temperature=temperature,
        rng=[row_generator(seed, 0, logits.device)],
        top_k=top_k, top_p=top_p, eos_id=eos_id,
        min_new_tokens=min_new, presence_penalty=presence,
        frequency_penalty=frequency, logit_bias=logit_bias, mesh=mesh,
    )
    return _record(srv, out.tolist())
