"""Prefix KV reuse for the inference server (counterpart of
``containerpilot_tpu/workload/serve_prefix.py``, without the host spill
tier: ``--kv-spill-mb`` is not ported yet).

Completed prompts' KV caches, keyed by their token tuple, LRU-bounded.
A new single-row request reuses the longest common prefix and only
prefills the (bucketed) suffix: the chat/agent regime where every turn
re-sends a long shared history.

The port updates caches in place (models/decode.py), so reuse never
extends a stored entry: ``reuse_admission`` first copies the entry's
k/v up to the reused length into a fresh row cache, then rewinds and
extends that copy. A hit therefore leaves the stored entry bit-
unchanged, and the next exact hit on it decodes the same tokens.

Thread safety: ``match_len`` runs on the event-loop thread while the
store side runs on the inference thread, so every OrderedDict access
holds ``_lock``.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, List, Optional, Tuple

import torch

from ..kvtier import digest as kvdigest

#: shorter matches aren't worth a device call; tied to the digest's
#: FP_TOKENS by construction
MIN_REUSE = kvdigest.FP_TOKENS
BUCKET = 16      # suffix lengths run in these steps


class PrefixCache:
    def __init__(self, entries: int) -> None:
        self.entries = entries
        self._cache: "OrderedDict[Tuple[int, ...], Any]" = OrderedDict()
        self._lock = threading.Lock()
        # the reference's schema; the spill fields stay zero (no spill
        # tier in the port yet)
        self.stats = {
            "hits": 0, "misses": 0, "tokens_reused": 0,
            "spilled": 0, "readmitted": 0, "spill_bytes": 0,
        }
        #: bumped on any contents change; versions the published digest
        self.version = 0
        self._digest_memo: Tuple[int, str] = (-1, "")

    def __len__(self) -> int:
        with self._lock:
            return len(self._cache)

    def match_len(self, row: List[int]) -> int:
        """Longest common prefix between ``row`` and any cached prompt."""
        return self.best_match(row)[0]

    def best_match(
        self, row: List[int]
    ) -> Tuple[int, Optional[Tuple[int, ...]]]:
        """(longest common prefix length, its key) over cached prompts."""
        with self._lock:
            keys: List[Tuple[int, ...]] = list(self._cache)
        best_len, best_key = 0, None
        for stored in keys:
            n = min(len(stored), len(row))
            i = 0
            while i < n and stored[i] == row[i]:
                i += 1
            if i > best_len:
                best_len, best_key = i, stored
        return best_len, best_key

    def get(self, key: Tuple[int, ...]) -> Optional[Any]:
        """A stored cache, marked most recently used; None if evicted
        between match and fetch."""
        with self._lock:
            cache = self._cache.get(key)
            if cache is not None:
                self._cache.move_to_end(key)
            return cache

    def store(self, key: Tuple[int, ...], cache: Any) -> None:
        with self._lock:
            self._cache[key] = cache
            self._cache.move_to_end(key)
            while len(self._cache) > self.entries:
                self._cache.popitem(last=False)
            self.version += 1

    def digest(self, max_bytes: Optional[int] = None) -> str:
        """Versioned fingerprint digest of every reusable prefix cached,
        for gateway routing; memoized per version."""
        version = self.version
        memo_version, memo = self._digest_memo
        if memo_version == version:
            return memo
        with self._lock:
            keys = list(self._cache)
        fps = [
            fp for fp in map(kvdigest.prefix_fingerprint, keys)
            if fp is not None
        ]
        encoded = kvdigest.encode_fingerprints(
            version, fps, max_bytes or kvdigest.DIGEST_MAX_BYTES
        )
        self._digest_memo = (version, encoded)
        return encoded


def plan_reuse(pc: PrefixCache, row: List[int]):
    """The one reuse plan of the prefix path and the slot engine's
    admission: the longest cached match, the suffix bucketed (a little of
    the matched prefix re-prefills). Returns (reuse_len, base cache or
    None)."""
    plen = len(row)
    best_len, best_key = pc.best_match(row)
    reuse = 0
    if best_len >= MIN_REUSE:
        suffix = plen - best_len
        bucket = max(1, -(-suffix // BUCKET) * BUCKET) if suffix > 0 else 1
        reuse = plen - min(bucket, plen)
    base = pc.get(best_key) if reuse > 0 and best_key is not None else None
    return (reuse, base) if base is not None else (0, None)


def _rewound_copy(base: Any, reuse: int) -> dict:
    """A fresh row cache holding ``base``'s first ``reuse`` positions
    (k/v, and their scales under kv_int8; zeros past them, as a fresh
    cache has) at pos ``reuse``: the stored entry is never written."""
    out = {"pos": reuse}
    for name, leaf in base.items():
        if name != "pos":
            fresh = torch.zeros_like(leaf)
            fresh[:, :, :reuse].copy_(leaf[:, :, :reuse])
            out[name] = fresh
    return out


@torch.inference_mode()
def reuse_admission(pc: PrefixCache, row_tokens: List[int], cfg, params,
                    chunk_len: int = 0):
    """The admission-side reuse protocol: plan the reuse, copy the cached
    base up to the reused length, extend the bucketed suffix (in bounded
    pieces when ``chunk_len`` applies) and count the hit/miss. Returns
    (logits [1, vocab], cache) on a hit, None on a miss; the caller
    stores the completed prompt's cache afterwards."""
    from ..models.decode import extend, extend_pieces

    reuse, base = plan_reuse(pc, row_tokens)
    if base is None:
        pc.stats["misses"] += 1
        return None
    cache = _rewound_copy(base, reuse)
    suffix = torch.tensor(
        [row_tokens[reuse:]], dtype=torch.int64, device=base["k"].device
    )
    if 0 < chunk_len < suffix.shape[1]:
        logits, cache = extend_pieces(params, cache, suffix, cfg, chunk_len)
    else:
        logits, cache = extend(params, cache, suffix, cfg)
    pc.stats["hits"] += 1
    pc.stats["tokens_reused"] += reuse
    return logits, cache


@torch.inference_mode()
def prefill_row(pc: Optional[PrefixCache], row: List[int], cfg, params,
                max_len: int, prefill_chunk: int = 0):
    """The one admission prefill policy of the serving paths (the slot
    engine, the prefix path, chunked prefill): with a prefix cache, a
    hit's copy+rewind+extend (``reuse_admission``); on a miss or without
    one, ``chunked_prefill`` when the prompt outgrows ``prefill_chunk``,
    else one ``prefill``. With a prefix cache the completed prompt's
    cache is then stored in it, so the caller must never write that
    cache (it decodes a copy). Returns (logits [1, vocab], cache)."""
    from ..models.decode import chunked_prefill, prefill

    hit = None if pc is None else reuse_admission(
        pc, row, cfg, params, chunk_len=prefill_chunk
    )
    if hit is not None:
        logits, cache = hit
    else:
        prompt = torch.tensor(
            [row], dtype=torch.int64, device=params["norm_out"].device
        )
        if 0 < prefill_chunk < len(row):
            logits, cache = chunked_prefill(
                params, prompt, cfg, max_len, prefill_chunk
            )
        else:
            logits, cache = prefill(params, prompt, cfg, max_len)
    if pc is not None:
        pc.store(tuple(row), cache)
    return logits, cache


@torch.inference_mode()
def generate_with_prefix(
    srv: Any, row: List[int], max_new: int, temperature: float,
    top_k: int, top_p: float, eos_id: int, seed: int,
    min_new: int = 0,
    presence: float = 0.0,
    frequency: float = 0.0,
    logit_bias: Any = None,
) -> List[List[int]]:
    """Single-row generation reusing the longest cached prompt prefix
    (runs on the inference thread). A miss prefills (chunked when the
    server's prefill_chunk applies) and seeds the cache. The stored
    cache is never written: decode continues in a copy."""
    from ..models.decode import generate_from_cache, row_generator

    logits, stored = prefill_row(
        srv.prefix_cache, row, srv.cfg, srv.params, srv.max_len,
        srv.prefill_chunk,
    )
    cache = {name: leaf if name == "pos" else leaf.clone()
             for name, leaf in stored.items()}
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
