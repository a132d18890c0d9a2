"""Speculative decoding: a cheap draft proposes, the target verifies
(counterpart of ``containerpilot_tpu/models/speculative.py``).

Greedy speculative decoding: each round the draft proposes ``k`` tokens
by k+1 greedy ``decode_step``s, then the target scores
``[prev, d_1..d_k]`` in ONE ``decode_chunk`` of k+1 tokens. The accepted
prefix plus one target-chosen token are emitted, and both caches roll
back to the accepted frontier by resetting ``pos``. The output is the
target's greedy decode for any draft: the draft changes speed, never
content. ``layer_prefix_draft`` builds a draft from the target's own
first N layers (a leading-axis slice of the stacked layer leaves).

Rolling back a cache that is written in place: a round writes rows
pos..pos+k of both caches and the rewind sets ``pos`` to the accepted
frontier, so rows past it hold rejected k/v (and, under ``kv_int8``,
their scales). Nothing reads them: ``decode_chunk`` writes a chunk's
rows before it attends, and on a linear cache reads only ``:pos + m``.
A ring cache's writes cannot be undone, so windows are refused.

One host fetch per round (the proposals and the target's choices
together), the cadence of a plain decode loop's sampled token. On the
card the draft runs K2 at m = 1 under int8 weights and the verify chunk
at m = k + 1; prefills of long prompts run K1.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Tuple

import numpy as np
import torch

from .decode import Cache, decode_chunk, decode_step, prefill
from .transformer import Params, TransformerConfig


def layer_prefix_draft(
    params: Params, cfg: TransformerConfig, n_layers: int
) -> Tuple[Params, TransformerConfig]:
    """A free draft model: the target's first ``n_layers`` layers (views
    of every stacked layer leaf, the int8 ``*_q``/``*_s`` leaves
    included) with the shared embed, norm and unembed."""
    if not 0 < n_layers < cfg.n_layers:
        raise ValueError(
            f"draft layers must be in (0, {cfg.n_layers}), got {n_layers}"
        )
    draft_params = dict(params)
    draft_params["layers"] = {
        name: leaf[:n_layers] for name, leaf in params["layers"].items()
    }
    return draft_params, dataclasses.replace(cfg, n_layers=n_layers)


def _draft_round(draft_params: Params, draft_cfg: TransformerConfig,
                 dcache: Cache, prev: torch.Tensor, k: int):
    """k greedy proposals from (dcache, prev) by k+1 decode steps: the
    last step consumes the k-th proposal, so the draft cache holds k/v
    for all of them (rows pos..pos+k), aligned with the target's verify
    chunk for every acceptance count. Returns (drafts [k], dcache)."""
    drafts = []
    tok = prev
    for _ in range(k + 1):
        logits, dcache = decode_step(draft_params, dcache, tok, draft_cfg)
        tok = torch.argmax(logits, dim=-1)
        drafts.append(tok)
    return torch.cat(drafts[:k]), dcache


def _verify_round(params: Params, cfg: TransformerConfig, cache: Cache,
                  chunk: torch.Tensor):
    """One target forward over the m = k+1 tokens [prev, d_1..d_k] ->
    (the target's greedy choice at each position [k+1], cache): its
    choices for d_1..d_k, then the bonus token after a full accept."""
    logits, cache = decode_chunk(params, cache, chunk, cfg)
    return torch.argmax(logits, dim=-1)[0], cache


def _clamp_k(speculate: int, remaining: int, max_len: int, pos: int) -> int:
    """The one per-round k clamp, shared by the standalone loop and the
    step program: at most the tokens still wanted, and the verify chunk
    writes k+1 rows at pos..pos+k, so k <= max_len - pos - 1."""
    return min(speculate, remaining, max_len - pos - 1)


def _dispatch_round(params, draft_params, cfg: TransformerConfig,
                    draft_cfg: TransformerConfig, cache: Cache,
                    dcache: Cache, prev: torch.Tensor, k: int):
    """The device half of one round, no host sync: k draft proposals
    from ``prev``, then the target's verify chunk over [prev, d_1..d_k].
    Returns (drafts [k], target_choice [k+1], cache, dcache)."""
    drafts, dcache = _draft_round(draft_params, draft_cfg, dcache, prev, k)
    chunk = torch.cat([prev, drafts])[None, :]
    target_choice, cache = _verify_round(params, cfg, cache, chunk)
    return drafts, target_choice, cache, dcache


def _fetch_round(drafts: torch.Tensor, target_choice: torch.Tensor):
    """The round's one host fetch -> (drafts, target choices) as ints."""
    both = torch.cat([drafts, target_choice]).tolist()
    k = drafts.shape[0]
    return both[:k], both[k:]


def _accept_round(drafts_h, target_h, k: int) -> List[int]:
    """The host half: the accepted prefix of the proposals plus one
    target-chosen token (the correction at the first mismatch, or the
    bonus after a full accept)."""
    n_acc = 0
    while n_acc < k and int(drafts_h[n_acc]) == int(target_h[n_acc]):
        n_acc += 1
    emitted = [int(t) for t in drafts_h[:n_acc]]
    emitted.append(int(target_h[n_acc]))
    return emitted


def _rewind_caches(cache: Cache, dcache: Cache, pos: int):
    """Roll both caches back to the accepted frontier: the last emitted
    token is not processed yet (it is the next round's ``prev``). Rows
    past ``pos`` are overwritten before anything reads them."""
    return {**cache, "pos": pos}, {**dcache, "pos": pos}


def _check_pair(cfg: TransformerConfig, draft_cfg: TransformerConfig,
                speculate: int) -> None:
    if speculate < 1:
        raise ValueError("speculate must be >= 1")
    if cfg.window > 0 or draft_cfg.window > 0:
        raise ValueError(
            "speculative decoding does not compose with sliding-window "
            "attention (ring-cache writes are destructive; rollback would "
            "leave rejected k/v in live slots)"
        )
    if cfg.vocab_size != draft_cfg.vocab_size:
        raise ValueError("draft and target must share a vocab")


@torch.inference_mode()
def speculative_generate(
    params: Params,
    draft_params: Params,
    prompt: torch.Tensor,
    cfg: TransformerConfig,
    draft_cfg: TransformerConfig,
    max_new_tokens: int,
    max_len: int,
    speculate: int = 4,
    eos_id: int = -1,
) -> Tuple[torch.Tensor, dict]:
    """Greedy generation by draft-and-verify; batch 1.

    Returns ``(tokens [1, <= max_new_tokens], stats)``, stats counting
    rounds and accepted drafts. The tokens equal ``generate(...,
    temperature=0)`` up to and including the first ``eos_id``: with
    ``eos_id >= 0`` the loop stops after the round that emits it, so
    the row may be shorter than ``max_new_tokens``."""
    if prompt.shape[0] != 1:
        raise ValueError("speculative decoding serves batch 1")
    _check_pair(cfg, draft_cfg, speculate)
    if max_new_tokens < 1:
        raise ValueError("max_new_tokens must be >= 1")
    if prompt.shape[1] + max_new_tokens > max_len:
        raise ValueError(
            f"prompt_len {prompt.shape[1]} + max_new_tokens "
            f"{max_new_tokens} exceeds max_len {max_len}"
        )
    prompt = prompt.to(params["norm_out"].device)
    logits, cache = prefill(params, prompt, cfg, max_len)
    _dlogits, dcache = prefill(draft_params, prompt, draft_cfg, max_len)
    prev = torch.argmax(logits, dim=-1)  # [1]
    out = [int(prev[0])]
    pos = cache["pos"]
    rounds = accepted_total = 0
    while len(out) < max_new_tokens and not (eos_id >= 0
                                             and out[0] == eos_id):
        k = _clamp_k(speculate, max_new_tokens - len(out), max_len, pos)
        # pos == prompt_len + len(out) - 1 and prompt_len +
        # max_new_tokens <= max_len, so k >= 1 here
        assert k >= 1, (pos, len(out))
        drafts, target_choice, cache, dcache = _dispatch_round(
            params, draft_params, cfg, draft_cfg, cache, dcache, prev, k,
        )
        emitted = _accept_round(*_fetch_round(drafts, target_choice), k)
        out.extend(emitted)
        rounds += 1
        accepted_total += len(emitted) - 1
        pos += len(emitted)
        cache, dcache = _rewind_caches(cache, dcache, pos)
        prev = torch.tensor([emitted[-1]], device=prompt.device)
        if eos_id >= 0 and eos_id in emitted:
            break
    tokens = torch.tensor([out[:max_new_tokens]], dtype=torch.int64,
                          device=prompt.device)
    stats = {
        "rounds": rounds,
        "accepted_drafts": accepted_total,
        "tokens": len(out[:max_new_tokens]),
        "mean_accepted": accepted_total / rounds if rounds else 0.0,
    }
    return tokens, stats


@torch.inference_mode()
def warm_speculative(
    params: Params,
    draft_params: Params,
    cfg: TransformerConfig,
    draft_cfg: TransformerConfig,
    speculate: int,
    max_len: int,
) -> None:
    """Run every program shape the speculative path dispatches, before a
    server reports healthy: one tiny end-to-end generation, then a draft
    round and a verify chunk for every k in 1..``speculate`` (a request's
    k is decided per round at run time). Eager torch compiles nothing,
    but the first call of a shape pays for its library plans, K2's
    split-k workspace and the allocator's blocks."""
    plen = 4
    device = params["norm_out"].device
    prompt = torch.zeros((1, plen), dtype=torch.int64, device=device)
    max_new = min(speculate + 2, max_len - plen)
    if max_new >= 1:
        speculative_generate(
            params, draft_params, prompt, cfg, draft_cfg,
            max_new_tokens=max_new, max_len=max_len, speculate=speculate,
        )
    _logits, tcache = prefill(params, prompt, cfg, max_len)
    _dlogits, dcache = prefill(draft_params, prompt, draft_cfg, max_len)
    prev = torch.zeros((1,), dtype=torch.int64, device=device)
    # a request's k is at most max_len - pos - 1 with pos >= 1; each k
    # starts from the prompt's frontier (a rewind, as after a round)
    for k in range(1, min(speculate, max_len - 2) + 1):
        _draft_round(draft_params, draft_cfg, {**dcache, "pos": plen},
                     prev, k)
        _verify_round(params, cfg, {**tcache, "pos": plen},
                      torch.zeros((1, k + 1), dtype=torch.int64,
                                  device=device))


class SpeculativeStepProgram:
    """Speculative decoding as a slot-engine step program
    (models/stepprog.py's verbs): the engine owns admission, queueing,
    streaming and cancel; this program owns the draft/verify round, and
    the protocol's ``valid`` counts carry several tokens a dispatch.

    The shapes of ``speculative_generate``: one slot (the rollback is a
    per-sequence ``pos`` rewind), greedy only (the server routes only
    greedy, penalty-free, bias-free single rows here), one draft round
    and one verify chunk a dispatch (``dispatch_cost`` 2), k clamped per
    round by ``_clamp_k`` exactly as the standalone loop clamps it, so
    the emitted tokens are the same. ``supports_lookahead`` is False:
    round N+1 starts from round N's accepted frontier, a host decision.
    No CUDA graph: the rounds run eagerly."""

    supports_lookahead = False
    dispatch_cost = 2  # one draft round + one verify chunk
    rounds = 1

    def __init__(
        self,
        cfg: TransformerConfig,
        draft_cfg: TransformerConfig,
        params: Params,
        draft_params: Params,
        max_len: int,
        speculate: int = 4,
    ) -> None:
        _check_pair(cfg, draft_cfg, speculate)
        self.cfg = cfg
        self.draft_cfg = draft_cfg
        self.params = params
        self.draft_params = draft_params
        self.max_len = max_len
        self.speculate = speculate
        self.slots = 1
        # the most tokens one dispatch emits: k accepted drafts plus the
        # target's correction or bonus token
        self.chunk = speculate + 1
        self.reset()

    def reset(self) -> None:
        self._cache = None
        self._dcache = None
        self._prev = None
        self._pos = 0

    @torch.inference_mode()
    def admit(self, slot: int, req: Any, logits: torch.Tensor,
              row_cache: Cache) -> int:
        """The engine prefilled the target (``row_cache``, decoded into
        in place from here on); prefill the draft and take the target's
        greedy prefill argmax as token 0, ``speculative_generate``'s
        first step."""
        if slot != 0:
            raise ValueError("speculative program serves one slot")
        prompt = torch.tensor([req.tokens], dtype=torch.int64,
                              device=logits.device)
        _dlogits, self._dcache = prefill(
            self.draft_params, prompt, self.draft_cfg, self.max_len
        )
        self._cache = row_cache
        self._prev = torch.argmax(logits, dim=-1)  # [1]
        self._pos = len(req.tokens)
        return int(self._prev[0])

    def retire(self, slot: int) -> None:
        self.reset()

    @torch.inference_mode()
    def dispatch(self, budgets, fused: bool):
        """One draft round and one verify chunk, no host sync ->
        (drafts, target_choice, k) on the device. ``budgets[0]`` is
        max_new minus the tokens already emitted: the standalone loop's
        ``max_new_tokens - len(out)``."""
        k = _clamp_k(self.speculate, int(budgets[0]), self.max_len,
                     self._pos)
        assert k >= 1, (self._pos, budgets)
        drafts, target_choice, self._cache, self._dcache = _dispatch_round(
            self.params, self.draft_params, self.cfg, self.draft_cfg,
            self._cache, self._dcache, self._prev, k,
        )
        return drafts, target_choice, k

    @torch.inference_mode()
    def tokens(self, handle):
        """The round's one host fetch, acceptance and rewind -> (toks
        [1, chunk], valid [1], 1)."""
        drafts, target_choice, k = handle
        emitted = _accept_round(*_fetch_round(drafts, target_choice), k)
        self._pos += len(emitted)
        self._cache, self._dcache = _rewind_caches(
            self._cache, self._dcache, self._pos)
        self._prev = torch.tensor([emitted[-1]], device=drafts.device)
        toks = np.zeros((1, self.chunk), np.int64)
        toks[0, : len(emitted)] = emitted
        valid = np.full((1,), len(emitted), np.int64)
        return toks, valid, 1
