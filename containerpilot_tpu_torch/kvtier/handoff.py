"""Live KV handoff: ship one prefix-cache entry replica -> replica (the
port's own copy of ``containerpilot_tpu/kvtier/handoff.py``).

A disaggregated fleet runs a prompt through a *prefill* replica's
slot-engine admission, then moves the resulting KV prefix to a *decode*
replica so its decode never pays the prefill. This is the wire for that
move, the weight transfer's discipline (fleet/standby.py):

    u64 manifest_len | manifest JSON | chunk bytes back-to-back

served by ``POST /v1/kv`` as one close-delimited cp-mux/1 stream, with
``?chunk=K`` resuming at the first unverified chunk and ONE transparent
redial on connection death. Every chunk carries a blake2b-8 digest; a
mismatch is corruption, so the transfer fails at once and the receiver
returns None: the decode replica then prefills locally, exactly as an
unhinted request would.

The manifest is self-describing: a JSON skeleton mirrors the entry's
dict/list/tuple structure with leaf indices at the arrays, and
``rebuild_kv`` reassembles the tree with no template. The codec is the
reference's byte for byte (dtype names, shapes, chunking, the JSON), so
a JAX replica and a torch replica read each other's entries: bf16 rides
as its bit pattern named ``"bfloat16"``, and the port's ``pos`` (a
Python int) travels as the 0-d int32 leaf a JAX entry has and comes back
an int.

Byte parity holds by construction: the receiver injects the rebuilt
host tree into its spill tier (``PrefixCache.adopt_host``), and the next
request readmits it through the same ``reuse_admission`` path a locally
spilled entry takes.
"""
from __future__ import annotations

import asyncio
import json
import logging
from typing import Any, Dict, List, Optional, Tuple

log = logging.getLogger("containerpilot.kvtier")

__all__ = [
    "KVTransferError",
    "KV_CHUNK",
    "KV_PATH",
    "KV_PULL_PATH",
    "MIGRATE_PATH",
    "encode_kv_manifest",
    "fetch_kv",
    "kv_transfer_plan",
    "plan_migration",
    "push_kv",
    "rebuild_kv",
]

#: path a replica serves (and pulls) prefix-cache entries on
KV_PATH = "/v1/kv"

#: path a replica adopts a peer's entry on ({"tokens", "from"}); a
#: draining replica drives it in reverse to evacuate its sessions
KV_PULL_PATH = "/v1/kv/pull"

#: path a replica reports (and takes) migration instructions on
MIGRATE_PATH = "/v1/migrate"

#: bytes per chunk
KV_CHUNK = 256 * 1024

#: sanity cap on a KV manifest (skeleton + tables)
_MANIFEST_CAP = 8 * 1024 * 1024

_MANIFEST_LEN_BYTES = 8


class KVTransferError(RuntimeError):
    """The handoff failed in a way a redial cannot fix (digest
    mismatch, manifest drift, malformed skeleton): the receiver falls
    back to a local prefill, it does not retry the peer."""


# -- the self-describing tree codec ------------------------------------


def _flatten(node: Any, leaves: List[Any]) -> Any:
    """Walk a host tree into a JSON skeleton; every non-container node
    becomes ``{"x": i}`` pointing into ``leaves``. Dict keys must be
    strings (a KV cache's are)."""
    if isinstance(node, dict):
        if any(not isinstance(k, str) for k in node):
            raise KVTransferError(
                "KV tree has non-string dict keys; not transferable"
            )
        return {"d": {k: _flatten(v, leaves) for k, v in node.items()}}
    if isinstance(node, (list, tuple)):
        kind = "l" if isinstance(node, list) else "t"
        return {kind: [_flatten(v, leaves) for v in node]}
    leaves.append(node)
    return {"x": len(leaves) - 1}


def _unflatten(skeleton: Any, leaves: List[Any]) -> Any:
    if not isinstance(skeleton, dict) or len(skeleton) != 1:
        raise KVTransferError("malformed KV skeleton node")
    (kind, value), = skeleton.items()
    if kind == "d":
        if not isinstance(value, dict):
            raise KVTransferError("malformed KV skeleton dict")
        out = {k: _unflatten(v, leaves) for k, v in value.items()}
        pos = out.get("pos")
        if getattr(pos, "ndim", None) == 0:
            out["pos"] = int(pos)  # the port's cache holds pos as an int
        return out
    if kind in ("l", "t"):
        if not isinstance(value, list):
            raise KVTransferError("malformed KV skeleton sequence")
        seq = [_unflatten(v, leaves) for v in value]
        return seq if kind == "l" else tuple(seq)
    if kind == "x":
        if not isinstance(value, int) or not 0 <= value < len(leaves):
            raise KVTransferError("KV skeleton leaf index out of range")
        return leaves[value]
    raise KVTransferError(f"unknown KV skeleton node kind {kind!r}")


def kv_transfer_plan(
    host_tree: Any, chunk_bytes: int = KV_CHUNK
) -> Tuple[Dict[str, Any], List[bytes]]:
    """(manifest, per-leaf byte blobs) for one KV entry, leaves in the
    tree's own order (``spill.to_host`` sorts a port entry's keys, as
    ``jax.device_get`` sorts a JAX one's). Blocking: executor-wrap it.
    Deterministic for the same entry, so a resumed stream's digests
    match the first attempt's manifest."""
    from ..fleet.standby import _chunk_digest, leaf_image

    raw_leaves: List[Any] = []
    skeleton = _flatten(host_tree, raw_leaves)
    leaves: List[Dict[str, Any]] = []
    blobs: List[bytes] = []
    chunks: List[Dict[str, Any]] = []
    for index, leaf in enumerate(raw_leaves):
        dtype, shape, data = leaf_image(leaf)
        leaves.append({"dtype": dtype, "shape": shape, "bytes": len(data)})
        blobs.append(data)
        for offset in range(0, len(data) or 1, chunk_bytes):
            piece = data[offset:offset + chunk_bytes]
            chunks.append(
                {
                    "leaf": index,
                    "offset": offset,
                    "len": len(piece),
                    "digest": _chunk_digest(piece),
                }
            )
    manifest = {
        "version": 1,
        "skeleton": skeleton,
        "total_bytes": sum(entry["bytes"] for entry in leaves),
        "leaves": leaves,
        "chunks": chunks,
    }
    return manifest, blobs


def encode_kv_manifest(manifest: Dict[str, Any]) -> bytes:
    """Length-prefixed manifest blob — the stream's first bytes."""
    body = json.dumps(manifest, sort_keys=True).encode()
    return len(body).to_bytes(_MANIFEST_LEN_BYTES, "big") + body


def rebuild_kv(manifest: Dict[str, Any], chunks: List[bytes]) -> Any:
    """Reassemble the host KV tree (CPU tensors, ``pos`` an int) from a
    verified chunk list: the manifest's skeleton is the treedef. Raises
    KVTransferError on any structural disagreement."""
    from ..fleet.standby import leaf_from_bytes

    specs = manifest.get("leaves")
    chunk_specs = manifest.get("chunks")
    skeleton = manifest.get("skeleton")
    if not isinstance(specs, list) or not isinstance(chunk_specs, list):
        raise KVTransferError("KV manifest missing its tables")
    if len(chunks) != len(chunk_specs):
        raise KVTransferError(
            f"{len(chunks)} chunks received, manifest names "
            f"{len(chunk_specs)}"
        )
    by_leaf: List[List[bytes]] = [[] for _ in specs]
    for spec, data in zip(chunk_specs, chunks):
        leaf = spec.get("leaf")
        if not isinstance(leaf, int) or not 0 <= leaf < len(specs):
            raise KVTransferError("KV chunk names a leaf out of range")
        by_leaf[leaf].append(data)
    leaves: List[Any] = []
    for spec, pieces in zip(specs, by_leaf):
        data = b"".join(pieces)
        if len(data) != int(spec["bytes"]):
            raise KVTransferError(
                f"leaf byte count {len(data)} != manifest "
                f"{spec['bytes']}"
            )
        try:
            leaves.append(leaf_from_bytes(data, spec["dtype"],
                                          spec["shape"]))
        except (TypeError, ValueError) as exc:
            raise KVTransferError(
                f"leaf does not reassemble: {exc}"
            ) from None
    return _unflatten(skeleton, leaves)


# -- the fetch client (decode-replica side) ----------------------------


async def fetch_kv_chunks(
    address: str,
    port: int,
    tokens: List[int],
    *,
    connect_timeout: float = 5.0,
    read_timeout: float = 30.0,
) -> Tuple[Dict[str, Any], List[bytes]]:
    """Fetch one prompt's KV entry from a peer over cp-mux/1:
    (manifest, verified chunks), with the weight transfer's resume,
    redial and digest discipline (``standby.fetch_chunked``)."""
    from ..fleet.standby import fetch_chunked

    # one row in the token-matrix shape every serve endpoint parses
    body = json.dumps({"tokens": [list(tokens)]}).encode()
    return await fetch_chunked(
        address, port, "POST", KV_PATH, body=body,
        manifest_cap=_MANIFEST_CAP, error=KVTransferError, what="KV",
        connect_timeout=connect_timeout, read_timeout=read_timeout,
    )


async def fetch_kv(
    address: str,
    port: int,
    tokens: List[int],
    *,
    connect_timeout: float = 5.0,
    read_timeout: float = 30.0,
) -> Optional[Tuple[Any, int]]:
    """Fetch + reassemble one prompt's KV entry from a peer:
    ``(host_tree, total_bytes)`` on success, None on ANY failure —
    poisoned chunk, declined upgrade, 404, second connection death — so
    the caller falls back to a local prefill and corrupt KV is never
    served. Assembly runs on an executor; no device copy happens here."""
    from ..fleet.pool import UpstreamError

    try:
        manifest, chunks = await fetch_kv_chunks(
            address, port, tokens,
            connect_timeout=connect_timeout,
            read_timeout=read_timeout,
        )
    except (KVTransferError, UpstreamError, OSError) as exc:
        log.warning(
            "kv handoff: fetch from %s:%d failed (%s); falling back "
            "to local prefill", address, port, exc,
        )
        return None
    loop = asyncio.get_running_loop()
    try:
        host_tree = await loop.run_in_executor(
            None, rebuild_kv, manifest, chunks
        )
    except (KVTransferError, ValueError, TypeError) as exc:
        log.warning(
            "kv handoff: fetched entry does not reassemble (%s); "
            "falling back to local prefill", exc,
        )
        return None
    return host_tree, int(manifest.get("total_bytes", 0))


# -- drain migration: the same wire, driven in reverse ------------------


def plan_migration(
    keys: Any, targets: List[Tuple[str, Any]]
) -> List[Dict[str, Any]]:
    """Deterministic reverse-push plan for a draining replica: which
    cached prefix goes to which survivor.

    ``keys`` are the drainer's cached prompt keys (token tuples, device
    + spill tiers); ``targets`` are ``(target_id, fingerprint_set)``
    pairs, each survivor's advertised ``pd=`` digest, parsed. The plan
    is a list of ``{"key", "fp", "target", "warm"}`` entries:

    - keys under the fingerprint floor are dropped (never reusable);
    - a fingerprint already warm on a survivor lands there with
      ``warm=True``: zero bytes move, but the gateway's pin repoints;
    - every key sharing a fingerprint goes to ONE survivor (a
      conversation's turns share their first FP_TOKENS ids);
    - cold fingerprints go to the digest-coldest target (fewest
      advertised + already-planned fingerprints), ties broken by id.

    Pure and deterministic: the same keys and targets give the same
    plan regardless of input order.
    """
    from .digest import prefix_fingerprint

    plan: List[Dict[str, Any]] = []
    if not targets:
        return plan
    warmth: Dict[str, Any] = {
        tid: frozenset(fps) for tid, fps in targets
    }
    ids = sorted(warmth)
    # longest prefixes first: they carry the most recompute, and the
    # family placement they decide is the one the shorter turns join
    ordered = sorted(
        {tuple(k) for k in keys}, key=lambda k: (-len(k), k)
    )
    assigned: Dict[str, int] = {tid: 0 for tid in ids}
    placed: Dict[int, str] = {}  # fp -> survivor chosen this plan
    for key in ordered:
        fp = prefix_fingerprint(list(key))
        if fp is None:
            continue
        tid = placed.get(fp)
        if tid is None:
            warm_ids = [t for t in ids if fp in warmth[t]]
            tid = warm_ids[0] if warm_ids else min(
                ids,
                key=lambda t: (len(warmth[t]) + assigned[t], t),
            )
            placed[fp] = tid
        warm = fp in warmth[tid]
        if not warm:
            assigned[tid] += 1
        plan.append(
            {"key": key, "fp": fp, "target": tid, "warm": warm}
        )
    return plan


async def push_kv(
    address: str,
    port: int,
    tokens: List[int],
    source: str,
    *,
    connect_timeout: float = 5.0,
    read_timeout: float = 30.0,
) -> Optional[int]:
    """POST a pull instruction at a survivor: ask ``address:port`` to
    ``fetch_kv`` this prompt's entry from ``source`` (the draining
    replica's advertised ``host:port``) and adopt it into its spill
    tier. Returns the adopted byte count, None on ANY failure (declined
    upgrade, non-200, transport death after the one redial): the drainer
    counts it and moves on."""
    from ..fleet.pool import UpstreamError
    from ..fleet.standby import dial_peer

    authority = f"{address}:{port}"
    body = json.dumps(
        {"tokens": [list(tokens)], "from": source, "migrate": True}
    ).encode()
    redialed = False
    conn = None
    try:
        while True:
            try:
                conn = await dial_peer(address, port, connect_timeout)
                stream = await conn.open_stream(
                    "POST", KV_PULL_PATH, body=body
                )
                status, _headers = await stream.response_head(
                    read_timeout
                )
                payload = await stream.read_body(
                    read_timeout, _MANIFEST_CAP
                )
                if status != 200:
                    log.warning(
                        "kv migrate: %s refused the push (%d)",
                        authority, status,
                    )
                    return None
                try:
                    return int(
                        json.loads(payload.decode()).get("bytes", 0)
                    )
                except (ValueError, AttributeError,
                        UnicodeDecodeError):
                    return 0
            except UpstreamError as exc:
                if redialed:
                    log.warning(
                        "kv migrate: push to %s failed (%s)",
                        authority, exc,
                    )
                    return None
                redialed = True
                if conn is not None:
                    conn.close("redialing")
                    conn = None
                log.warning(
                    "kv migrate: peer stream died (%s); redialing "
                    "once", exc,
                )
    except OSError as exc:
        log.warning(
            "kv migrate: push to %s failed (%s)", authority, exc
        )
        return None
    finally:
        if conn is not None:
            conn.close("push done")
