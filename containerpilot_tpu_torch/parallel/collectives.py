"""Differentiable collectives over one mesh axis: the conjugate pairs of
tensor parallelism and FSDP's gather, as ``torch.autograd.Function``s.

Where the reference's XLA inserts a collective and its transpose from
the PartitionSpecs, the port calls one of these:

- ``copy_to(x, axis)``: identity forward, sum over ``axis`` backward (the
  entry of a column-parallel region: every rank's partial gradient of
  the replicated input is summed);
- ``reduce_from(x, axis)``: sum over ``axis`` forward, identity backward
  (the exit of a row-parallel region, and any replicated value built
  from per-rank parts, such as the vocab-parallel softmax's sums);
- ``mean_from(x, axis)``: mean over ``axis`` forward, identity backward
  (a statistic over the global batch whose gradient is averaged over
  ``data`` afterwards, as every data-parallel gradient is);
- ``gather_from(x, axis, dim)``: all-gather along ``dim`` forward,
  reduce-scatter (sum) backward (FSDP's gather of a parameter at use).

Each is the identity, without a node, on an axis of size 1 or without a
mesh: a one-rank world computes exactly the unsharded path.
"""
from __future__ import annotations

import torch


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.mesh.all_reduce(grad, ctx.axis), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, op):
        return mesh.all_reduce(x, axis, op)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return mesh.all_gather(x, axis, dim)

    @staticmethod
    def backward(ctx, grad):
        return (ctx.mesh.reduce_scatter(grad.contiguous(), ctx.axis, ctx.dim),
                None, None, None)


def _live(mesh, axis) -> bool:
    return mesh is not None and mesh.axis_size(axis) > 1


def copy_to(x: torch.Tensor, mesh, axis: str = "model") -> torch.Tensor:
    return _CopyTo.apply(x, mesh, axis) if _live(mesh, axis) else x


def reduce_from(x: torch.Tensor, mesh, axis: str = "model",
                op: str = "sum") -> torch.Tensor:
    return _ReduceFrom.apply(x, mesh, axis, op) if _live(mesh, axis) else x


def mean_from(x: torch.Tensor, mesh, axis: str = "data") -> torch.Tensor:
    return reduce_from(x, mesh, axis, "mean")


def gather_from(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    return _GatherFrom.apply(x, mesh, axis, dim) if _live(mesh, axis) else x


def max_over(x: torch.Tensor, mesh, axis: str = "model") -> torch.Tensor:
    """Max over ``axis``, outside autograd (a softmax's shift)."""
    x = x.detach()
    return mesh.all_reduce(x, axis, "max") if _live(mesh, axis) else x
