"""Prefix digests: how a replica tells the fleet what it has cached
(the port's own copy of ``containerpilot_tpu/kvtier/digest.py``'s
fingerprint and codec).

``prefix_fingerprint(tokens)`` hashes the first ``FP_TOKENS`` ids of a
prompt to a stable 32-bit value (blake2b, never Python's ``hash()``:
it must agree across processes, runs and both packages, because
``/v1/model``'s ``prefix_digest`` goes over the same wire).
``encode_fingerprints(version, fps)`` packs a fingerprint set into
``v<version>:<8-hex each, sorted>``, truncated to ``DIGEST_MAX_BYTES``.
"""
from __future__ import annotations

import hashlib
from typing import Iterable, Optional, Sequence

#: prompt ids hashed into one fingerprint; equals serve_prefix's
#: MIN_REUSE (shorter prefixes are never reusable, so never advertised)
FP_TOKENS = 16

#: byte bound on one encoded digest (~128 fingerprints)
DIGEST_MAX_BYTES = 1024

_HEADER = "v"


def prefix_fingerprint(tokens: Sequence[int]) -> Optional[int]:
    """Stable 32-bit fingerprint of a prompt's first ``FP_TOKENS`` ids,
    or None when the prompt is too short to ever be reused."""
    if len(tokens) < FP_TOKENS:
        return None
    raw = b"".join(
        int(t).to_bytes(4, "little", signed=True)
        for t in tokens[:FP_TOKENS]
    )
    return int.from_bytes(
        hashlib.blake2b(raw, digest_size=4).digest(), "big"
    )


def encode_fingerprints(
    version: int,
    fps: Iterable[int],
    max_bytes: int = DIGEST_MAX_BYTES,
) -> str:
    """``v<version>:<hex8 hex8 ...>`` (no separators), size-bounded.
    Sorted so equal sets encode identically; truncation keeps the
    smallest fingerprints (a bounded digest is a sample)."""
    header = f"{_HEADER}{int(version)}:"
    budget = max(0, max_bytes - len(header))
    body = "".join(
        f"{fp & 0xFFFFFFFF:08x}" for fp in sorted(set(fps))
    )[: (budget // 8) * 8]
    return header + body
