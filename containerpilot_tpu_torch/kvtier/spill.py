"""Host-RAM KV spill tier: the floor under the prefix cache's LRU (the
port's own copy of ``containerpilot_tpu/kvtier/spill.py``).

- **Spill**: on LRU eviction the entry (a dict of device tensors and its
  ``pos``) is copied to host tensors and kept in a byte-budgeted LRU of
  its own. Entries larger than the whole budget are refused (counted);
  inserts evict least-recently-used spilled entries until the budget
  holds.
- **Readmit**: ``take()`` pops the host copy and copies it back to the
  tier's device. The round trip is bit-exact, so the prefix cache's
  rewind+extend reuse is untouched; the readmitted entry re-enters the
  device LRU as most recently used. Readmission allocates new device
  tensors: the slot engine copies a reused row into its pool, so no
  captured CUDA graph ever sees them.

Host trees are dicts with their keys sorted (the order ``jax.device_get``
gives a JAX entry, so a handed-off entry's skeleton is the same from
either package), tensors on the CPU and ``pos`` a Python int.

Thread safety: spills run on the engine's worker thread while matching
runs on the event-loop thread, so the index is locked; the copies happen
outside the lock, and ``take`` pops atomically, so two concurrent
readmits of one key cannot both serve it.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Set, Tuple

import torch

from .. import resolve_device
from .digest import prefix_fingerprint


def _leaf_nbytes(leaf: Any) -> int:
    if isinstance(leaf, torch.Tensor):
        return leaf.numel() * leaf.element_size()
    if isinstance(leaf, int):
        return 4  # travels as a 0-d int32, as a JAX entry's pos
    return int(getattr(leaf, "nbytes", 0))


def tree_nbytes(tree: Dict[str, Any]) -> int:
    """Total bytes of an entry's leaves."""
    return sum(_leaf_nbytes(leaf) for leaf in tree.values())


def to_host(cache: Dict[str, Any]) -> Dict[str, Any]:
    """A host copy of one cache entry, keys sorted. Blocking (device to
    host)."""
    return {
        name: cache[name].detach().to("cpu")
        if isinstance(cache[name], torch.Tensor) else cache[name]
        for name in sorted(cache)
    }


def to_device(host: Dict[str, Any], device: torch.device) -> Dict[str, Any]:
    """A host entry's leaves on ``device`` (``pos`` stays an int)."""
    return {
        name: leaf.to(device) if isinstance(leaf, torch.Tensor) else leaf
        for name, leaf in host.items()
    }


class HostSpillTier:
    """Byte-budgeted host-RAM LRU of evicted KV cache entries, readmitted
    to ``device`` (the entry point's rule: the card unless the caller
    asks for the CPU)."""

    def __init__(self, max_bytes: int, device="cuda") -> None:
        if max_bytes < 1:
            raise ValueError("spill tier max_bytes must be >= 1")
        self.max_bytes = int(max_bytes)
        self.device = resolve_device(device)
        self._lock = threading.Lock()
        #: key -> (host tree, nbytes)
        self._store: "OrderedDict[Tuple[int, ...], Tuple[Any, int]]" = (
            OrderedDict()
        )
        #: prefix fingerprint -> keys sharing it: a usable reuse match
        #: shares the row's first FP_TOKENS ids, so the per-request scan
        #: compares only this bucket
        self._by_fp: Dict[int, Set[Tuple[int, ...]]] = {}
        self._bytes = 0
        self.stats = {
            "spilled": 0,       # entries accepted into the tier
            "readmitted": 0,    # entries handed back to the device
            "evicted": 0,       # entries dropped for budget
            "refused": 0,       # entries larger than the whole budget
            "misses": 0,        # take() of a key not (or no longer) here
        }

    def __len__(self) -> int:
        with self._lock:
            return len(self._store)

    @property
    def bytes_used(self) -> int:
        with self._lock:
            return self._bytes

    def keys(self) -> List[Tuple[int, ...]]:
        """Snapshot of spilled keys, for digest publication."""
        with self._lock:
            return list(self._store)

    def candidates(self, fp: Optional[int]) -> List[Tuple[int, ...]]:
        """Spilled keys that could match a row with prefix fingerprint
        ``fp`` at >= MIN_REUSE tokens (collisions cost one exact
        compare, never a wrong answer)."""
        if fp is None:
            return []
        with self._lock:
            bucket = self._by_fp.get(fp)
            return list(bucket) if bucket else []

    def _index(self, key: Tuple[int, ...]) -> None:
        fp = prefix_fingerprint(key)
        if fp is not None:
            self._by_fp.setdefault(fp, set()).add(key)

    def _unindex(self, key: Tuple[int, ...]) -> None:
        fp = prefix_fingerprint(key)
        bucket = self._by_fp.get(fp)
        if bucket is not None:
            bucket.discard(key)
            if not bucket:
                del self._by_fp[fp]

    def put(self, key: Tuple[int, ...], cache: Any) -> bool:
        """Spill one evicted entry. Returns True when it was accepted;
        False when it exceeds the whole budget (refused)."""
        # device -> host outside the lock: a transfer must not block
        # concurrent match scans
        return self.put_host(key, to_host(cache)) > 0

    def put_host(self, key: Tuple[int, ...], host_tree: Any) -> int:
        """Insert an entry that is already host-side (a handed-off KV
        prefix rebuilt from the wire, kvtier/handoff.py). Returns the
        bytes stored, 0 when refused for budget. The entry then
        readmits through the same ``take``/``reuse_admission`` path a
        locally spilled one takes."""
        nbytes = tree_nbytes(host_tree)
        if nbytes > self.max_bytes:
            self.stats["refused"] += 1
            return 0
        with self._lock:
            old = self._store.pop(key, None)
            if old is not None:
                self._bytes -= old[1]
            else:
                self._index(key)
            self._store[key] = (host_tree, nbytes)
            self._bytes += nbytes
            while self._bytes > self.max_bytes and self._store:
                evicted, (_, dropped) = self._store.popitem(last=False)
                self._unindex(evicted)
                self._bytes -= dropped
                self.stats["evicted"] += 1
        self.stats["spilled"] += 1
        return nbytes

    def peek(self, key: Tuple[int, ...]) -> Optional[Any]:
        """Non-destructive host-side read for export (the handoff send
        path): no device copy, no LRU movement."""
        with self._lock:
            entry = self._store.get(key)
            return entry[0] if entry is not None else None

    def take(self, key: Tuple[int, ...]) -> Optional[Any]:
        """Pop one entry and copy it to the device, or None when the
        key isn't spilled (evicted for budget, never spilled, or
        already taken by a concurrent readmit)."""
        with self._lock:
            entry = self._store.pop(key, None)
            if entry is not None:
                self._bytes -= entry[1]
                self._unindex(key)
        if entry is None:
            self.stats["misses"] += 1
            return None
        self.stats["readmitted"] += 1
        return to_device(entry[0], self.device)

    def snapshot(self) -> Dict[str, int]:
        """Stats + size for surfaces (``/v1/model``)."""
        with self._lock:
            return {
                "max_bytes": self.max_bytes,
                "bytes": self._bytes,
                "entries": len(self._store),
                **self.stats,
            }
