"""Warm standby (the port's own copy of
``containerpilot_tpu/fleet/standby.py``): the replica half, peer weight
transfer over cp-mux/1, and the autoscaler half, ``StandbyLauncher``,
which turns a scale-up into the promotion of a warm standby.

A standby boots, loads weights and warms exactly like an active replica,
registers under ``role=standby`` and waits for
``POST /v3/standby/promote``. With ``--weights-from`` it fetches the
weights from a warm peer (``GET /v1/weights``) instead of reading a
checkpoint: digest-verified chunks, resume at the first unverified chunk
with ONE transparent redial. ANY failure (declined upgrade, digest
mismatch, second connection death, shape mismatch) returns None and the
caller falls back to its own load: the transfer is an accelerator, never
a new way to fail a boot.

Wire format (one close-delimited stream, carried as a cp-mux/1 stream)::

    u64 manifest_len | manifest JSON | chunk bytes back-to-back

The manifest names every leaf in ``jax.tree_util`` order (dict keys
sorted at every level; the name is ``keystr`` of its path, e.g.
``['layers']['wq']``) with its dtype name, shape and byte length, and
every chunk (owning leaf, offset, length, blake2b-8 digest). bf16 leaves
travel as their bit pattern and are named ``"bfloat16"``, so a JAX
replica reads what a torch replica sends and the reverse; the port maps
the dtype names itself (``leaf_image``/``leaf_from_bytes``), since numpy
has no bf16 without ``ml_dtypes``.
"""
from __future__ import annotations

import asyncio
import hashlib
import json
import logging
import random
from typing import Any, Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from ..utils.tasks import spawn
from .pool import MuxConnection, UpstreamError, dial_mux

log = logging.getLogger("containerpilot.fleet")

#: replica roles as they ride catalog heartbeat notes (``role=``); an
#: absent field means active
ROLE_ACTIVE = "active"
ROLE_STANDBY = "standby"
#: the disaggregated fleet's phase roles: routing advice, not a serving
#: restriction
ROLE_PREFILL = "prefill"
ROLE_DECODE = "decode"

#: path a peer serves its weights on (and the standby fetches from)
WEIGHTS_PATH = "/v1/weights"

#: bytes per manifest chunk
WEIGHT_CHUNK = 256 * 1024

_MANIFEST_LEN_BYTES = 8

#: torch dtype -> the wire's dtype name (numpy's ``dtype.name``)
_WIRE_NAMES = {
    torch.float32: "float32", torch.float16: "float16",
    torch.bfloat16: "bfloat16", torch.float64: "float64",
    torch.int8: "int8", torch.uint8: "uint8", torch.int16: "int16",
    torch.int32: "int32", torch.int64: "int64", torch.bool: "bool",
}


class WeightTransferError(RuntimeError):
    """The peer transfer failed in a way a redial cannot fix (digest
    mismatch, manifest drift, shape disagreement): fall back to the
    local load, do not retry the peer."""


def equal_jitter(
    backoff: float, rng: random.Random, fraction: float = 0.5
) -> float:
    """The fleet's ONE retry-delay shape (the gateway's request
    retries, the autoscaler's launch retries, and the standby
    refill all call this): a deterministic floor plus a uniform
    random slice of ``fraction`` of the backoff — failures retried
    by many actors at once spread out instead of re-arriving as one
    synchronized wave."""
    spread = backoff * fraction
    return backoff - spread + rng.random() * spread


# -- the leaf codec (shared with kvtier/handoff.py) --------------------


def _chunk_digest(data: bytes) -> str:
    return hashlib.blake2b(data, digest_size=8).hexdigest()


def leaf_image(leaf: Any) -> Tuple[str, List[int], bytes]:
    """(dtype name, shape, bytes) of one leaf as the wire carries it: a
    torch tensor on any device (bf16 as its bit pattern), a numpy array
    (an ``ml_dtypes`` bf16 array included) or a Python int, which
    travels as the 0-d int32 a JAX cache's ``pos`` is. Blocking (a
    device tensor is copied to the host): call it from an executor."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu").contiguous()
        name = _WIRE_NAMES.get(t.dtype)
        if name is None:
            raise ValueError(f"no wire name for {t.dtype}")
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return name, list(leaf.shape), t.numpy().tobytes()
    if isinstance(leaf, int) and not isinstance(leaf, bool):
        arr = np.asarray(leaf, np.int32)
    else:
        arr = np.asarray(leaf)
    return arr.dtype.name, list(arr.shape), arr.tobytes()


def leaf_from_bytes(data: bytes, dtype: str, shape: List[int]) -> torch.Tensor:
    """The CPU tensor a wire leaf decodes to (the inverse of
    ``leaf_image``). Raises ValueError for an unknown dtype name or a
    byte count that does not fill the shape."""
    if dtype == "bfloat16":
        arr = np.frombuffer(data, np.uint16).reshape(shape)
        return torch.from_numpy(arr.copy()).view(torch.bfloat16)
    if dtype not in _WIRE_NAMES.values():
        raise ValueError(f"unknown wire dtype {dtype!r}")
    arr = np.frombuffer(data, np.dtype(dtype)).reshape(shape)
    return torch.from_numpy(arr.copy())


def param_leaves(params: Any, path: str = "") -> List[Tuple[str, Any]]:
    """``(keystr path, leaf)`` of a params dict in ``jax.tree_util``
    flatten order: dict keys sorted at every level."""
    if isinstance(params, dict):
        out: List[Tuple[str, Any]] = []
        for key in sorted(params):
            out += param_leaves(params[key], f"{path}[{key!r}]")
        return out
    return [(path, params)]


def leaf_bytes(leaf: Any) -> bytes:
    """One leaf's deterministic host-side byte image. Blocking (device
    to host): call it from an executor, never on the loop."""
    return leaf_image(leaf)[2]


def weights_manifest(
    params: Any, chunk_bytes: int = WEIGHT_CHUNK
) -> Dict[str, Any]:
    """The transfer manifest: every leaf (name/dtype/shape/bytes) and
    every chunk (leaf index, offset, length, digest) in flat
    ``tree_util`` order. Blocking (a host copy per leaf): executor-wrap
    it. The chunk bytes are re-derived at serve time, so the server
    never holds a second full copy of the params."""
    return manifest_of_leaves(param_leaves(params), chunk_bytes)


def manifest_of_leaves(
    named_leaves: Any, chunk_bytes: int = WEIGHT_CHUNK
) -> Dict[str, Any]:
    """``weights_manifest`` of ``(name, leaf)`` pairs in flat order, an
    iterable that may make each leaf as it is reached (a server over
    ranks gathers them one at a time): no leaf is kept."""
    leaves: List[Dict[str, Any]] = []
    chunks: List[Dict[str, Any]] = []
    for index, (name, leaf) in enumerate(named_leaves):
        dtype, shape, data = leaf_image(leaf)
        leaves.append(
            {"name": name, "dtype": dtype, "shape": shape,
             "bytes": len(data)}
        )
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
    return {
        "version": 1,
        "total_bytes": sum(entry["bytes"] for entry in leaves),
        "leaves": leaves,
        "chunks": chunks,
    }


def encode_manifest(manifest: Dict[str, Any]) -> bytes:
    """Length-prefixed manifest blob — the stream's first bytes."""
    body = json.dumps(manifest, sort_keys=True).encode()
    return len(body).to_bytes(_MANIFEST_LEN_BYTES, "big") + body


def _unflatten_like(like: Any, leaves: List[Any]) -> Any:
    """A tree shaped like ``like`` holding ``leaves`` in flatten order."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {key: build(node[key]) for key in sorted(node)}
        return next(it)

    return build(like)


def rebuild_params(
    manifest: Dict[str, Any], chunks: List[bytes], like: Any
) -> Any:
    """Reassemble a CPU params tree from verified chunks, shaped like
    ``like`` (the fetcher's own seeded or restored params: the treedef
    the wire cannot carry). Raises WeightTransferError on any structural
    disagreement; the caller falls back."""
    local = param_leaves(like)
    specs = manifest["leaves"]
    if len(specs) != len(local):
        raise WeightTransferError(
            f"peer serves {len(specs)} leaves, local model has "
            f"{len(local)} — config mismatch"
        )
    if len(chunks) != len(manifest["chunks"]):
        raise WeightTransferError(
            f"{len(chunks)} chunks received, manifest names "
            f"{len(manifest['chunks'])}"
        )
    by_leaf: List[List[bytes]] = [[] for _ in specs]
    for chunk_spec, data in zip(manifest["chunks"], chunks):
        by_leaf[chunk_spec["leaf"]].append(data)
    rebuilt: List[Any] = []
    for spec, pieces, (_name, leaf) in zip(specs, by_leaf, local):
        try:
            t = leaf_from_bytes(b"".join(pieces), spec["dtype"],
                                spec["shape"])
        except ValueError as exc:
            raise WeightTransferError(
                f"leaf {spec['name']} does not reassemble: {exc}"
            ) from None
        local_shape = tuple(getattr(leaf, "shape", t.shape))
        if local_shape != tuple(t.shape):
            raise WeightTransferError(
                f"leaf {spec['name']}: peer shape {tuple(t.shape)} "
                f"!= local {local_shape} — config mismatch"
            )
        rebuilt.append(t)
    return _unflatten_like(like, rebuilt)


# -- the fetch client (standby side) ----------------------------------


async def dial_peer(
    address: str, port: int, connect_timeout: float
) -> MuxConnection:
    """One upgraded cp-mux/1 connection to a peer for one transfer;
    UpstreamError when the dial fails or the peer declines the
    upgrade."""
    conn = await dial_mux(address, port, connect_timeout)
    if conn is None:
        raise UpstreamError(
            f"{address}:{port} declined the cp-mux/1 upgrade"
        )
    return conn


class _ChunkedReader:
    """Reassemble exact-length reads off a mux stream's arbitrary
    DATA-frame boundaries."""

    def __init__(self, stream: Any, timeout: float) -> None:
        self._stream = stream
        self._timeout = timeout
        self._buf = bytearray()

    async def read_exact(self, n: int) -> bytes:
        while len(self._buf) < n:
            piece = await self._stream.read_chunk(self._timeout)
            if not piece:
                raise UpstreamError(
                    "peer weight stream ended "
                    f"{n - len(self._buf)} bytes early"
                )
            self._buf += piece
        out = bytes(self._buf[:n])
        del self._buf[:n]
        return out


async def read_framed_manifest(
    reader: _ChunkedReader, cap: int, what: str
) -> Dict[str, Any]:
    """The length-prefixed manifest at the head of a weight or KV
    stream; UpstreamError when it is implausible or malformed."""
    raw_len = await reader.read_exact(_MANIFEST_LEN_BYTES)
    length = int.from_bytes(raw_len, "big")
    if not 0 < length <= cap:
        raise UpstreamError(f"implausible {what} manifest length {length}")
    try:
        manifest = json.loads((await reader.read_exact(length)).decode())
    except (ValueError, UnicodeDecodeError) as exc:
        raise UpstreamError(f"malformed {what} manifest: {exc}") from None
    if not isinstance(manifest, dict) or not isinstance(
        manifest.get("chunks"), list
    ):
        raise UpstreamError(f"{what} manifest missing its chunk table")
    return manifest


async def fetch_chunked(
    address: str,
    port: int,
    method: str,
    path: str,
    *,
    body: bytes = b"",
    manifest_cap: int,
    error: type,
    what: str,
    connect_timeout: float,
    read_timeout: float,
) -> Tuple[Dict[str, Any], List[bytes]]:
    """Fetch one manifest-framed stream (weights or a KV entry) from a
    peer over cp-mux/1: (manifest, verified chunks). ONE transparent
    redial on connection death, resuming at the first unverified chunk
    (``?chunk=K``: the peer served none of the missing bytes, so
    re-requesting them cannot double-apply anything). Digest mismatches
    and manifest drift raise ``error`` immediately: a redial cannot fix
    corruption."""
    got: List[bytes] = []
    manifest: Optional[Dict[str, Any]] = None
    redialed = False
    conn: Optional[MuxConnection] = None
    try:
        while True:
            try:
                conn = await dial_peer(address, port, connect_timeout)
                stream = await conn.open_stream(
                    method, f"{path}?chunk={len(got)}", body=body
                )
                status, _headers = await stream.response_head(
                    read_timeout
                )
                if status != 200:
                    raise UpstreamError(f"{what} fetch answered {status}")
                reader = _ChunkedReader(stream, read_timeout)
                fresh = await read_framed_manifest(
                    reader, manifest_cap, what
                )
                if manifest is None:
                    manifest = fresh
                elif fresh != manifest:
                    # the peer's tree changed between attempts: the
                    # verified prefix belongs to a different serialization
                    raise error(
                        f"peer {what} manifest changed across the redial"
                    )
                specs = manifest["chunks"]
                while len(got) < len(specs):
                    spec = specs[len(got)]
                    data = await reader.read_exact(int(spec["len"]))
                    if _chunk_digest(data) != spec["digest"]:
                        raise error(
                            f"{what} chunk {len(got)} digest mismatch"
                        )
                    got.append(data)
                return manifest, got
            except error:
                raise
            except UpstreamError:
                if redialed:
                    raise
                redialed = True
                # drop the dead connection so the retry dials fresh;
                # fully-verified chunks stay counted
                if conn is not None:
                    conn.close("redialing")
                    conn = None
                log.warning(
                    "%s stream from %s:%d died at chunk %d; redialing "
                    "once to resume", what, address, port, len(got),
                )
    finally:
        if conn is not None:
            conn.close("transfer done")


async def fetch_weight_chunks(
    address: str,
    port: int,
    *,
    connect_timeout: float = 5.0,
    read_timeout: float = 120.0,
) -> Tuple[Dict[str, Any], List[bytes]]:
    """A peer's full weight stream over cp-mux/1: (manifest, verified
    chunks), with ``fetch_chunked``'s redial and digest discipline."""
    return await fetch_chunked(
        address, port, "GET", WEIGHTS_PATH,
        manifest_cap=64 * 1024 * 1024, error=WeightTransferError,
        what="weight", connect_timeout=connect_timeout,
        read_timeout=read_timeout,
    )


async def fetch_params(
    address: str,
    port: int,
    like: Any,
    *,
    connect_timeout: float = 5.0,
    read_timeout: float = 120.0,
) -> Optional[Any]:
    """Fetch a warm peer's weights as a tree shaped like ``like``, each
    leaf on the device of ``like``'s leaf, or None on ANY failure — the
    caller falls back to its own load."""
    try:
        manifest, chunks = await fetch_weight_chunks(
            address, port,
            connect_timeout=connect_timeout,
            read_timeout=read_timeout,
        )
    except (WeightTransferError, UpstreamError, OSError) as exc:
        log.warning(
            "standby: peer weight transfer from %s:%d failed (%s); "
            "falling back to local load", address, port, exc,
        )
        return None

    def assemble() -> Any:
        host = rebuild_params(manifest, chunks, like)
        placed = [
            leaf.to(ref.device) for (_n, leaf), (_m, ref) in zip(
                param_leaves(host), param_leaves(like))
        ]
        return _unflatten_like(like, placed)

    loop = asyncio.get_running_loop()
    try:
        return await loop.run_in_executor(None, assemble)
    except (WeightTransferError, ValueError, TypeError) as exc:
        log.warning(
            "standby: fetched weights did not match the local model "
            "(%s); falling back to local load", exc,
        )
        return None


# -- the pool (autoscaler side) ---------------------------------------


class StandbyLauncher:
    """Autoscaler launcher that turns scale-up into PROMOTION.

    Wraps an inner launcher speaking the plain duck type plus three
    standby verbs::

        count() -> int / ids() -> list[str]   ACTIVE replicas only
        async launch() -> str                 cold active launch
        async retire(id)                      drain + stop
        async launch_standby() -> str         boot one standby replica
        async promote(id) -> bool             standby -> active; False
                                              when the standby is gone
                                              or already promoted

    ``launch()`` claims a warm standby (popped BEFORE any await, so
    two concurrent launches can never promote the same one — the
    promotion-race invariant) and promotes it; a dead/contended
    standby is dropped and the next tried; an empty pool falls back
    to the inner cold launch. Every launch — promoted or cold —
    schedules a background refill that boots standbys until the pool
    holds ``standby_count`` again, retrying failures with the
    fleet's equal-jitter backoff discipline. The autoscaler's
    kill-repair path calls the same ``launch()``, so crash recovery
    promotes too."""

    def __init__(
        self,
        inner: Any,
        standby_count: int = 1,
        *,
        refill_backoff: float = 0.25,
        refill_backoff_cap: float = 4.0,
        jitter_seed: Optional[int] = None,
    ) -> None:
        if standby_count < 0:
            raise ValueError("standby_count must be >= 0")
        self.inner = inner
        self.standby_count = standby_count
        self.refill_backoff = refill_backoff
        self.refill_backoff_cap = refill_backoff_cap
        self._rng = random.Random(jitter_seed)
        self._pool: List[str] = []
        self.promotions = 0
        self.promote_failures = 0
        self.cold_launches = 0
        self.refill_failures = 0
        #: how the LAST successful launch happened ("promoted"/"cold")
        #: — the autoscaler stamps it into its scale log so the TTFRT
        #: report can separate the promoted path from the cold one
        self.last_launch: Dict[str, str] = {}
        self._refill_task: Optional["asyncio.Task[None]"] = None
        self._tasks: Set["asyncio.Task"] = set()

    # -- the autoscaler duck type -------------------------------------

    def count(self) -> int:
        return self.inner.count()

    def ids(self) -> List[str]:
        return self.inner.ids()

    def standby_ids(self) -> List[str]:
        return list(self._pool)

    async def launch(self) -> str:
        """Promote a warm standby when one exists; cold-launch
        otherwise. Either way the pool refills in the background."""
        while self._pool:
            # claim BEFORE the await: concurrent launches pop
            # different standbys, so exactly one promoter ever
            # targets each — the loser of a pool race simply gets
            # the next standby (or the cold path), never a 409
            standby_id = self._pool.pop(0)
            try:
                promoted = await self.inner.promote(standby_id)
            except Exception as exc:
                log.warning(
                    "standby: promote %s raised (%s); trying next",
                    standby_id, exc,
                )
                promoted = False
            if promoted:
                self.promotions += 1
                self.last_launch = {
                    "mode": "promoted", "replica": standby_id,
                }
                self._ensure_refill()
                return standby_id
            # the standby died (or someone else promoted it) between
            # joining the pool and now: drop it and keep going
            self.promote_failures += 1
        self.last_launch = {"mode": "cold"}
        self._ensure_refill()
        replica_id = await self.inner.launch()
        # counted AFTER the await: a raising launcher is the
        # autoscaler's launch_failures, not a cold launch that never
        # happened skewing the promoted-vs-cold split
        self.cold_launches += 1
        return replica_id

    async def retire(self, replica_id: str) -> None:
        await self.inner.retire(replica_id)

    # -- pool maintenance ---------------------------------------------

    async def prefill(self) -> None:
        """Boot the initial standby set synchronously (the fleet-boot
        path; refills after that are background)."""
        while len(self._pool) < self.standby_count:
            self._pool.append(await self.inner.launch_standby())

    def _ensure_refill(self) -> None:
        if self.standby_count <= 0:
            return
        if self._refill_task is not None and not self._refill_task.done():
            return
        self._refill_task = spawn(
            self._refill_loop(), name="standby-refill",
            owner=self._tasks,
        )

    async def _refill_loop(self) -> None:
        """Boot standbys until the pool is full again. A standby that
        crashes mid-boot counts a failure and retries after an
        equal-jitter backoff (doubling, capped) — the same discipline
        the gateway's retry path uses, so a broken launcher can't
        storm the host with boot attempts."""
        backoff = self.refill_backoff
        while len(self._pool) < self.standby_count:
            try:
                standby_id = await self.inner.launch_standby()
            except Exception as exc:
                self.refill_failures += 1
                delay = equal_jitter(backoff, self._rng)
                log.warning(
                    "standby: refill launch failed (%s); retrying "
                    "in %.2fs", exc, delay,
                )
                await asyncio.sleep(delay)
                backoff = min(backoff * 2, self.refill_backoff_cap)
                continue
            self._pool.append(standby_id)
            backoff = self.refill_backoff
        log.info(
            "standby: pool refilled to %d (%s)",
            len(self._pool), self._pool,
        )

    async def stop(self) -> None:
        """Cancel the background refill (shutdown path)."""
        task = self._refill_task
        self._refill_task = None
        if task is not None and not task.done():
            task.cancel()
            try:
                await task
            except asyncio.CancelledError:
                log.debug("standby: refill task cancelled at stop")

    def standby_stats(self) -> Dict[str, Any]:
        """The pool's surface on /fleet (via the autoscaler stats)."""
        return {
            "standby_count": self.standby_count,
            "pool": list(self._pool),
            "promotions": self.promotions,
            "promote_failures": self.promote_failures,
            "cold_launches": self.cold_launches,
            "refill_failures": self.refill_failures,
        }
