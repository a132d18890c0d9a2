"""The device mesh as a ``torch.distributed`` world (counterpart of
``containerpilot_tpu/parallel/mesh.py``).

The reference drives every device of its mesh from one process and lets
XLA insert the collectives. PyTorch runs one process a rank, so here a
mesh is the world split into process groups, one per axis of size > 1,
and the collectives are called by the port's own code
(``parallel/collectives.py``, ``models/transformer.py``,
``parallel/train.py``, ``parallel/pipeline.py``).

The axes and their order are the reference's: ``("data", "model")``,
``("data", "seq", "model")`` when ``seq > 1`` and ``("data", "pipe",
"model")`` when ``pipe > 1``. Rank r sits at the row-major position r of
that grid, as device r sits in ``np.asarray(devices).reshape(...)``, so
``model`` is the innermost (fastest-varying) axis.

Backends, chosen explicitly and printed by the trainer:

- ranks that each have their own card use NCCL;
- ranks that share a card (the one-card machine), or run on the CPU, use
  gloo. Gloo runs collectives on CPU tensors only here: a collective on
  a CUDA tensor copies it into a host buffer, runs there and copies the
  result back ("host staging"; ``Mesh.staging`` says so). The model's
  compute stays on the card.

A mesh made without a process group (``make_mesh(world_size=N,
rank=r)`` before ``init_process_group``) is a layout only: it answers
the rank's coordinates for ``sharding.shard_params`` and refuses any
collective over an axis of size > 1.
"""
from __future__ import annotations

import copy
import itertools
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class MeshPlan:
    """A named factorization of the rank count.

    ``seq`` > 1 adds a context-parallel axis (the ring of
    ops/ring_attention.py, parallel/context.py); ``pipe`` > 1 adds a
    pipeline-stage axis for GPipe microbatching (parallel/pipeline.py).
    """

    data: int
    model: int
    seq: int = 1
    pipe: int = 1

    @property
    def n_devices(self) -> int:
        return self.data * self.model * self.seq * self.pipe


def _factor(n: int, max_model: int) -> MeshPlan:
    """Largest power-of-two model axis up to max_model that divides n."""
    model = 1
    m = 2
    while m <= max_model and n % m == 0:
        model = m
        m *= 2
    return MeshPlan(data=n // model, model=model)


def axes_of(plan: MeshPlan) -> Tuple[Tuple[str, int], ...]:
    """(axis name, size) in the reference's order for this plan."""
    if plan.seq > 1:
        return (("data", plan.data), ("seq", plan.seq),
                ("model", plan.model))
    if plan.pipe > 1:
        return (("data", plan.data), ("pipe", plan.pipe),
                ("model", plan.model))
    return (("data", plan.data), ("model", plan.model))


class Mesh:
    """One rank's view of the mesh: the plan, the rank's coordinates, a
    process group per axis of size > 1, the rank's device, and the
    collectives over an axis."""

    def __init__(self, plan: MeshPlan, rank: int = 0,
                 groups: Optional[Dict[str, object]] = None,
                 device=None, backend: str = "") -> None:
        self.plan = plan
        self.rank = rank
        self._axes = axes_of(plan)
        self.axis_names = tuple(name for name, _ in self._axes)
        self.shape = dict(self._axes)
        self.size = plan.n_devices
        self.coords = dict(zip(self.axis_names, _unravel(rank, self._axes)))
        self.groups = dict(groups or {})
        self.device = torch.device(device or "cpu")
        self.backend = backend
        # gloo runs CUDA tensors' collectives through host buffers
        self.staging = backend == "gloo" and self.device.type == "cuda"
        # bytes staged through the host, both ways (shared with views)
        self.traffic = {"host_bytes": 0}
        # how the model's layers read this mesh (with_options)
        self.fsdp = None         # rule tree of FSDP-sharded params
        self.batch_stats = True  # MoE routing statistics over all of data

    def with_options(self, fsdp=None, batch_stats: bool = True) -> "Mesh":
        """A view of this mesh (same groups) for the model's layers:
        ``fsdp`` the rule tree when the params are FSDP shards,
        ``batch_stats`` False when MoE statistics stay per data shard
        (the pipeline's per-microbatch aux)."""
        view = copy.copy(self)
        view.fsdp, view.batch_stats = fsdp, batch_stats
        return view

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, rank={self.rank}, coords={self.coords}, "
                f"backend={self.backend or 'none'}, staging={self.staging})")

    def axis_size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def axis_index(self, axis: str) -> int:
        return self.coords.get(axis, 0)

    def group(self, axis: str):
        """The process group of ``axis`` (None for an axis of size 1)."""
        if self.axis_size(axis) == 1:
            return None
        try:
            return self.groups[axis]
        except KeyError:
            raise RuntimeError(
                f"mesh {self.shape} was made without a process group (a "
                f"layout only): no collective over {axis!r}") from None

    def ranks_along(self, axis: str) -> List[int]:
        """Global ranks of this rank's group along ``axis``, in axis
        order."""
        out = []
        for i in range(self.axis_size(axis)):
            coords = dict(self.coords, **{axis: i})
            out.append(_ravel(coords, self._axes))
        return out

    # -- collectives over one axis (no-ops on an axis of size 1) --------

    def _buf(self, t: torch.Tensor) -> torch.Tensor:
        """A fresh buffer holding ``t`` for a collective to run on: a
        host copy of a CUDA tensor under gloo, else a clone."""
        if self.staging and t.is_cuda:
            self.traffic["host_bytes"] += t.numel() * t.element_size()
            return t.detach().to("cpu")
        return t.detach().clone().contiguous()

    def _back(self, buf: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        if buf.device == like.device:
            return buf
        self.traffic["host_bytes"] += buf.numel() * buf.element_size()
        return buf.to(like.device)

    def all_reduce(self, t: torch.Tensor, axis: str, op: str = "sum"
                   ) -> torch.Tensor:
        """A new tensor: ``t`` reduced (sum, max or mean) over ``axis``."""
        group = self.group(axis)
        if group is None:
            return t
        buf = self._buf(t)
        reduce_op = dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM
        dist.all_reduce(buf, op=reduce_op, group=group)
        if op == "mean":
            buf = buf / self.axis_size(axis)
        return self._back(buf, t)

    def all_reduce_world(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over every rank of the world."""
        if self.size == 1:
            return t
        if not dist.is_initialized():
            raise RuntimeError("no process group: a layout-only mesh")
        buf = self._buf(t)
        dist.all_reduce(buf)
        return self._back(buf, t)

    def all_gather(self, t: torch.Tensor, axis: str, dim: int
                   ) -> torch.Tensor:
        """The shards of ``axis`` concatenated along ``dim`` in axis
        order."""
        group = self.group(axis)
        if group is None:
            return t
        src = self._buf(t)
        parts = [torch.empty_like(src) for _ in range(self.axis_size(axis))]
        dist.all_gather(parts, src, group=group)
        return self._back(torch.cat(parts, dim=dim), t)

    def reduce_scatter(self, t: torch.Tensor, axis: str, dim: int
                       ) -> torch.Tensor:
        """``t`` summed over ``axis``, then this rank's slice of ``dim``."""
        group = self.group(axis)
        if group is None:
            return t
        n = self.axis_size(axis)
        src = self._buf(t)
        parts = [p.contiguous() for p in src.chunk(n, dim=dim)]
        out = torch.empty_like(parts[0])
        dist.reduce_scatter(out, parts, group=group)
        return self._back(out, t)

    def broadcast(self, t: torch.Tensor, axis: str, src_index: int
                  ) -> torch.Tensor:
        """A new tensor: position ``src_index``'s ``t`` on every rank of
        ``axis`` (every rank passes a tensor of the same shape)."""
        group = self.group(axis)
        if group is None:
            return t
        buf = self._buf(t)
        dist.broadcast(buf, src=self.ranks_along(axis)[src_index],
                       group=group)
        return self._back(buf, t)

    def ring_shift(self, tensors: List[torch.Tensor], axis: str
                   ) -> List[torch.Tensor]:
        """The ring's hop: each tensor goes to position i + 1 along
        ``axis`` and the one from position i - 1 comes back, all in one
        batch of sends and receives (no ordering for gloo to deadlock
        on). Returns the received tensors, shaped as the sent ones."""
        group = self.group(axis)
        if group is None:
            return list(tensors)
        n, i = self.axis_size(axis), self.axis_index(axis)
        ranks = self.ranks_along(axis)
        bufs = [self._buf(t) for t in tensors]
        outs = [torch.empty_like(b) for b in bufs]
        ops = [dist.P2POp(dist.isend, b, ranks[(i + 1) % n], group)
               for b in bufs]
        ops += [dist.P2POp(dist.irecv, o, ranks[(i - 1) % n], group)
                for o in outs]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return [self._back(o, t) for o, t in zip(outs, tensors)]

    def isend(self, t: torch.Tensor, axis: str, to_index: int, tag: int,
              pending: list) -> None:
        """Start sending ``t`` to position ``to_index`` along ``axis``;
        the work and its buffer go on ``pending`` (wait on them with
        ``wait_all``)."""
        buf = self._buf(t)
        dst = self.ranks_along(axis)[to_index]
        pending.append((dist.isend(buf, dst=dst, tag=tag), buf))

    def recv(self, like: torch.Tensor, axis: str, from_index: int,
             tag: int) -> torch.Tensor:
        """Receive a tensor shaped as ``like`` from ``from_index`` along
        ``axis`` (blocking)."""
        buf = torch.empty(like.shape, dtype=like.dtype,
                          device="cpu" if self.staging else like.device)
        src = self.ranks_along(axis)[from_index]
        dist.irecv(buf, src=src, tag=tag).wait()
        return self._back(buf, like)


def wait_all(pending: list) -> None:
    """Wait for every send started with ``Mesh.isend``."""
    while pending:
        work, _buf = pending.pop(0)
        work.wait()


def _unravel(rank: int, axes) -> Tuple[int, ...]:
    coords = []
    for _name, size in reversed(axes):
        coords.append(rank % size)
        rank //= size
    return tuple(reversed(coords))


def _ravel(coords: Dict[str, int], axes) -> int:
    rank = 0
    for name, size in axes:
        rank = rank * size + coords[name]
    return rank


def rank_device(rank: int, device="cuda") -> torch.device:
    """Rank r's device: ``cuda:(r % device_count)``, or the CPU when the
    caller asks for it."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    from .. import resolve_device

    resolve_device("cuda")  # raises without a card
    return torch.device("cuda", rank % torch.cuda.device_count())


def make_mesh(plan: Optional[MeshPlan] = None, max_model: int = 4, *,
              world_size: Optional[int] = None, rank: Optional[int] = None,
              device=None) -> Mesh:
    """Build this rank's mesh over the world.

    With a process group initialized, the world is its ranks and every
    rank must call this with the same plan (the groups are made
    collectively). Without one, ``world_size`` (default 1) and ``rank``
    give a layout-only mesh. ``plan`` defaults to the reference's
    factorization of the world size: up to ``max_model`` on ``model``,
    the rest on ``data``."""
    initialized = dist.is_initialized()
    if initialized:
        n, me = dist.get_world_size(), dist.get_rank()
        if world_size not in (None, n) or rank not in (None, me):
            raise ValueError(
                f"world {n} rank {me} from the process group, asked "
                f"for world {world_size} rank {rank}")
    else:
        n = 1 if world_size is None else world_size
        me = 0 if rank is None else rank
    if plan is None:
        plan = _factor(n, max_model)
    if plan.n_devices != n:
        raise ValueError(f"mesh plan {plan} does not cover {n} devices")
    if plan.seq > 1 and plan.pipe > 1:
        raise ValueError("seq and pipe axes cannot be combined (yet)")
    if not 0 <= me < n:
        raise ValueError(f"rank {me} outside a world of {n}")
    axes = axes_of(plan)
    groups = {}
    backend = ""
    if initialized:
        backend = dist.get_backend()
        # every rank creates every group, in the same order
        for axis, size in axes:
            if size == 1:
                continue
            others = [(name, s) for name, s in axes if name != axis]
            for fixed in itertools.product(*(range(s) for _, s in others)):
                coords = dict(zip((name for name, _ in others), fixed))
                ranks = [_ravel(dict(coords, **{axis: i}), axes)
                         for i in range(size)]
                group = dist.new_group(ranks)
                if me in ranks:
                    groups[axis] = group
    return Mesh(plan, me, groups, device=device, backend=backend)
