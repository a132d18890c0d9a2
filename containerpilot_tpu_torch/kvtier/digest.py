"""Prefix digests: how a replica tells the fleet what it has cached
(the port's own copy of ``containerpilot_tpu/kvtier/digest.py``).

``prefix_fingerprint(tokens)`` hashes the first ``FP_TOKENS`` ids of a
prompt to a stable 32-bit value (blake2b, never Python's ``hash()``:
it must agree across processes, runs and both packages, because
``/v1/model``'s ``prefix_digest`` goes over the same wire).
``encode_fingerprints(version, fps)`` packs a fingerprint set into
``v<version>:<8-hex each, sorted>``, truncated to ``DIGEST_MAX_BYTES``;
``parse_digest`` is its tolerant reader. The heartbeat note's ``kv=``
counters and ``mg=`` migration progress are encoded and parsed here too,
and ``parse_kv_note`` splits a note into its ``key=value`` fields. Every
reader is tolerant: malformed input decodes to a zero value, never an
exception on the routing path.
"""
from __future__ import annotations

import hashlib
from typing import Dict, FrozenSet, Iterable, Optional, Sequence, Tuple

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


def parse_digest(raw: object) -> Tuple[Optional[int], FrozenSet[int]]:
    """Tolerant inverse of :func:`encode_fingerprints`. Garbage — a
    hostile note, a torn read, the wrong field — parses to
    ``(None, frozenset())``; the routing path never throws on it."""
    if not isinstance(raw, str) or not raw.startswith(_HEADER):
        return None, frozenset()
    head, sep, body = raw[len(_HEADER):].partition(":")
    if not sep or not head.isascii() or not head.isdigit():
        return None, frozenset()
    if len(body) % 8 != 0 or len(body) > DIGEST_MAX_BYTES:
        return None, frozenset()
    try:
        fps = frozenset(
            int(body[i:i + 8], 16) for i in range(0, len(body), 8)
        )
    except ValueError:
        return None, frozenset()
    return int(head), fps


def parse_kv_note(notes: object) -> Dict[str, str]:
    """Split a heartbeat check output (``ok occ=0.50 kv=1,2,3
    pd=v4:...``) into its ``key=value`` fields. Bare words (the
    leading ``ok``) are dropped; duplicate keys keep the last."""
    out: Dict[str, str] = {}
    if not isinstance(notes, str):
        return out
    for token in notes.split():
        key, sep, value = token.partition("=")
        if sep and key:
            out[key] = value
    return out


#: migration-note counter names, wire order (all cumulative over the
#: replica's life; ``active`` is a 0/1 flag, not a counter)
MIGRATION_FIELDS = ("done", "total", "failed", "timeout", "active")


def encode_migration_note(
    done: int,
    total: int,
    failed: int,
    timeout: int,
    active: bool,
    landed: Iterable[Tuple[int, str]] = (),
    max_bytes: int = DIGEST_MAX_BYTES,
) -> str:
    """Encode a drain-migration progress report for the ``mg=``
    heartbeat-note field: ``done,total,failed,timeout,active`` plus
    zero or more ``;<fp hex8>:<target_id>`` landing segments — all
    non-whitespace, so :func:`parse_kv_note` carries it intact.
    Landings are size-bounded; callers pass them most-recent-first so
    truncation drops the repoints the gateway has already seen."""
    head = "%d,%d,%d,%d,%d" % (
        max(0, int(done)), max(0, int(total)), max(0, int(failed)),
        max(0, int(timeout)), 1 if active else 0,
    )
    out = [head]
    budget = max_bytes - len(head)
    for fp, target in landed:
        tid = "".join(
            ch for ch in str(target) if not ch.isspace() and ch != ";"
        )
        seg = f";{int(fp) & 0xFFFFFFFF:08x}:{tid}"
        if len(seg) > budget:
            break
        out.append(seg)
        budget -= len(seg)
    return "".join(out)


def parse_migration_note(
    raw: object,
) -> Tuple[Dict[str, int], Dict[int, str]]:
    """Tolerant inverse of :func:`encode_migration_note`. Returns
    ``(counters, landed)`` where counters zero-fill on short or torn
    input (same discipline as :func:`parse_kv_counters`: a half-
    written note must not zero a replica's migration state) and
    malformed landing segments are skipped, never thrown on."""
    out = {name: 0 for name in MIGRATION_FIELDS}
    landed: Dict[int, str] = {}
    if not isinstance(raw, str) or not raw:
        return out, landed
    head, _, tail = raw.partition(";")
    for name, part in zip(MIGRATION_FIELDS, head.split(",")):
        try:
            out[name] = max(0, int(part))
        except ValueError:
            break
    out["active"] = min(1, out["active"])
    for seg in tail.split(";") if tail else ():
        fp_hex, sep, target = seg.partition(":")
        if not sep or len(fp_hex) != 8 or not target:
            continue
        try:
            fp = int(fp_hex, 16)
        except ValueError:
            continue
        landed.setdefault(fp, target)
    return out, landed


def parse_kv_counters(raw: object) -> Dict[str, int]:
    """Decode the ``kv=`` note field: five comma-separated ints
    (hits, misses, tokens_reused, spilled, readmitted). Short or
    malformed values yield the fields that did parse, zero-filled —
    a half-written note must not zero a replica's routing state."""
    names = ("hits", "misses", "tokens_reused", "spilled", "readmitted")
    out = {name: 0 for name in names}
    if not isinstance(raw, str) or not raw:
        return out
    for name, part in zip(names, raw.split(",")):
        try:
            out[name] = max(0, int(part))
        except ValueError:
            break
    return out
