"""Prefix KV reuse for the inference server (counterpart of
``containerpilot_tpu/workload/serve_prefix.py``).

Completed prompts' KV caches, keyed by their token tuple, LRU-bounded.
A new single-row request reuses the longest common prefix and only
prefills the (bucketed) suffix: the chat/agent regime where every turn
re-sends a long shared history.

The port updates caches in place (models/decode.py), so reuse never
extends a stored entry: ``reuse_admission`` first copies the entry's
k/v up to the reused length into a fresh row cache, then rewinds and
extends that copy. A hit therefore leaves the stored entry bit-
unchanged, and the next exact hit on it decodes the same tokens.

With a spill tier attached (``kvtier.HostSpillTier``, ``--kv-spill-mb``),
LRU eviction moves the entry's KV to byte-budgeted host RAM instead of
dropping it, and a later match readmits it through the same
``get``/``reuse_admission`` path; a handed-off entry (kvtier/handoff.py)
enters the same tier through ``adopt_host``. The stats
(``spilled``/``readmitted``/``spill_bytes``) stay zero without a tier, so
the ``/v1/model`` schema is the same either way.

Thread safety: ``match_len`` runs on the event-loop thread while the
store side runs on the inference thread, so every OrderedDict access
holds ``_lock``.
"""
from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Any, List, Optional, Tuple

import torch

from ..kvtier import digest as kvdigest

#: shorter matches aren't worth a device call; tied to the digest's
#: FP_TOKENS by construction
MIN_REUSE = kvdigest.FP_TOKENS
BUCKET = 16      # suffix lengths run in these steps


class PrefixCache:
    def __init__(self, entries: int, spill: Optional[Any] = None) -> None:
        self.entries = entries
        #: optional kvtier.HostSpillTier catching LRU evictions
        self.spill = spill
        self._cache: "OrderedDict[Tuple[int, ...], Any]" = OrderedDict()
        self._lock = threading.Lock()
        self.stats = {
            "hits": 0, "misses": 0, "tokens_reused": 0,
            "spilled": 0, "readmitted": 0, "spill_bytes": 0,
        }
        #: seconds the last admission spent readmitting from the spill
        #: tier: reset and read by the slot engine around its prefill to
        #: stamp the trace's ``kv`` stage and the ledger's kv_readmit
        self.readmit_seconds = 0.0
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
        """(longest common prefix length, its key) over device-resident
        and spilled prompts. Device keys scan first, so on equal length
        the base that needs no readmit wins; the spill tier is consulted
        by the row's fingerprint bucket, not scanned."""
        with self._lock:
            keys: List[Tuple[int, ...]] = list(self._cache)
        if self.spill is not None:
            keys.extend(
                self.spill.candidates(kvdigest.prefix_fingerprint(row))
            )
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
        """A stored cache, marked most recently used, readmitted from
        the spill tier when the device LRU evicted it; None if it is
        gone from both tiers."""
        with self._lock:
            cache = self._cache.get(key)
            if cache is not None:
                self._cache.move_to_end(key)
                return cache
        if self.spill is None:
            return None
        t0 = time.monotonic()
        cache = self.spill.take(key)
        if cache is None:
            return None
        self.stats["readmitted"] += 1
        self.readmit_seconds += time.monotonic() - t0
        # back into the device LRU as most recently used (which may
        # spill another entry in turn)
        self.store(key, cache)
        return cache

    def device_entry(self, key: Tuple[int, ...]) -> Optional[Any]:
        """The device-tier entry for ``key``, untouched: no readmit, no
        MRU bump (the handoff export's read)."""
        with self._lock:
            return self._cache.get(key)

    def adopt_host(self, key: Tuple[int, ...], host_tree: Any) -> int:
        """Inject a handed-off host entry (kvtier/handoff.py) into the
        spill tier and republish the digest. Returns the bytes adopted,
        0 without a spill tier or when the budget refuses it."""
        if self.spill is None:
            return 0
        adopted = self.spill.put_host(key, host_tree)
        if adopted:
            with self._lock:
                self.version += 1
            self.stats["spill_bytes"] = self.spill.bytes_used
        return adopted

    def store(self, key: Tuple[int, ...], cache: Any) -> None:
        evicted: List[Tuple[Tuple[int, ...], Any]] = []
        with self._lock:
            self._cache[key] = cache
            self._cache.move_to_end(key)
            while len(self._cache) > self.entries:
                evicted.append(self._cache.popitem(last=False))
            self.version += 1
        if self.spill is None:
            return
        for k, c in evicted:
            if len(k) < MIN_REUSE:
                continue  # below the reuse floor it can never match
            # device -> host happens inside put(), outside our lock
            if self.spill.put(k, c):
                self.stats["spilled"] += 1
        if evicted:
            self.version += 1
        self.stats["spill_bytes"] = self.spill.bytes_used

    def export_keys(self) -> List[Tuple[int, ...]]:
        """Every migratable prompt key held, device tier first in MRU
        order, then spilled keys (kvtier.plan_migration's input); none
        below the reuse floor."""
        with self._lock:
            keys = list(reversed(self._cache))
        if self.spill is not None:
            seen = set(keys)
            keys.extend(k for k in self.spill.keys() if k not in seen)
        return [k for k in keys if len(k) >= MIN_REUSE]

    def digest(self, max_bytes: Optional[int] = None) -> str:
        """Versioned fingerprint digest of every reusable prefix cached
        (device and spill tiers), for gateway routing; memoized per
        version."""
        version = self.version
        memo_version, memo = self._digest_memo
        if memo_version == version:
            return memo
        with self._lock:
            keys = list(self._cache)
        if self.spill is not None:
            keys.extend(self.spill.keys())
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
                max_len: int, prefill_chunk: int = 0, mesh=None):
    """The one admission prefill policy of the serving paths (the slot
    engine, the prefix path, chunked prefill): with a prefix cache, a
    hit's copy+rewind+extend (``reuse_admission``); on a miss or without
    one, ``chunked_prefill`` when the prompt outgrows ``prefill_chunk``,
    else one ``prefill``. With a prefix cache the completed prompt's
    cache is then stored in it, so the caller must never write that
    cache (it decodes a copy). Returns (logits [1, vocab], cache).
    ``mesh``: the params are a rank's blocks (no prefix cache then)."""
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
                params, prompt, cfg, max_len, prefill_chunk, mesh
            )
        else:
            logits, cache = prefill(params, prompt, cfg, max_len, mesh)
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
