"""Pipeline parallelism: GPipe microbatching over a ``pipe`` mesh axis
(counterpart of ``containerpilot_tpu/parallel/pipeline.py``).

The layer-stacked parameters ``[L, ...]`` are cut along their leading
axis over ``pipe`` (each stage holds L/S contiguous layers) and
microbatches stream through the stages with point-to-point handoffs.

Schedule: S stages, M microbatches, M + S - 1 ticks. At tick t stage 0
takes microbatch ``min(t, M-1)`` (masked once t >= M), every stage
applies its local layers, the result goes to the next stage, and the
last stage banks microbatch ``t - S + 1``. The reference computes the
masked ticks and throws their results away; here a stage skips the
ticks where it holds no real microbatch (stage s is busy during ticks
s..s+M-1), which changes no result: the garbage never reaches a banked
output or the aux loss. The bubble is (S-1)/(M+S-1).

The handoff and its gradient are one ``torch.autograd.Function``
(``_Handoff``): forward it sends this stage's output to the next stage
and receives the previous stage's; backward it sends the received
activations' gradient back to the previous stage and receives its own
output's from the next. Every handoff a stage makes is on its loss's
autograd path (a handoff that receives nothing returns a zero scalar
that joins the aux sum), so every rank runs every backward handoff;
messages are tagged by tick and direction, so the order in which
autograd runs them does not matter. A handoff that only receives takes a
zero computed from a parameter as its input: ``autograd.grad`` skips
every node off the paths to the tensors it differentiates for.

Embedding runs on stage 0 (its gradient is summed over ``pipe``
afterwards, as the reference's replicated embedding's is) and the
unembedding and loss replicated: the final activations are broadcast
off the last stage, whose own loss carries the gradient back. Tensor
parallelism stays live inside each stage, and data parallelism outside
(microbatch rows over ``data``). The MoE aux loss is the mean of
per-microbatch statistics (averaged over ``data``), as the reference
documents: the loss is nonlinear in the batch partition.
"""
from __future__ import annotations

from typing import Any, List, Tuple

import torch

from ..models.transformer import (
    Params,
    TransformerConfig,
    _logits,
    _rms_norm,
    embed,
    next_token_loss,
    run_layers,
)
from .collectives import mean_from, reduce_from
from .mesh import wait_all


class _Handoff(torch.autograd.Function):
    """One stage's handoff at tick ``tick``: send ``y`` to the next stage
    (when ``send``) and return what the previous stage sent (when
    ``recv``; else a zero scalar)."""

    @staticmethod
    def forward(ctx, y, mesh, tick, ticks, send, recv, like, pending):
        stage = mesh.axis_index("pipe")
        ctx.mesh, ctx.send, ctx.recv, ctx.pending = mesh, send, recv, pending
        ctx.tag = ticks + tick  # the backward's messages
        ctx.y_meta = (y.shape, y.dtype, y.device)
        if send:
            mesh.isend(y, "pipe", stage + 1, tick, pending)
        if recv:
            return mesh.recv(like, "pipe", stage - 1, tick)
        return y.new_zeros(())

    @staticmethod
    def backward(ctx, grad):
        mesh = ctx.mesh
        stage = mesh.axis_index("pipe")
        if ctx.recv:
            mesh.isend(grad.contiguous(), "pipe", stage - 1, ctx.tag,
                       ctx.pending)
        shape, dtype, device = ctx.y_meta
        like = torch.empty(shape, dtype=dtype, device=device)
        if ctx.send:
            grad_y = mesh.recv(like, "pipe", stage + 1, ctx.tag)
        else:
            grad_y = torch.zeros_like(like)
        return (grad_y,) + (None,) * 7


class _FromLastStage(torch.autograd.Function):
    """The last stage's banked outputs on every stage; the gradient goes
    back through the last stage's own copy (its loss is the one loss)."""

    @staticmethod
    def forward(ctx, outputs, mesh):
        ctx.last = mesh.axis_index("pipe") == mesh.axis_size("pipe") - 1
        return mesh.broadcast(outputs, "pipe", mesh.axis_size("pipe") - 1)

    @staticmethod
    def backward(ctx, grad):
        return (grad if ctx.last else None), None


def _validate(cfg: TransformerConfig, mesh, b: int, n_microbatches: int,
              axis_name: str) -> None:
    if axis_name not in mesh.axis_names:
        raise ValueError(f"mesh has no {axis_name!r} axis: {mesh.axis_names}")
    n_stages = mesh.shape[axis_name]
    if cfg.n_layers % n_stages:
        raise ValueError(
            f"n_layers {cfg.n_layers} not divisible by {n_stages} stages"
        )
    if b % n_microbatches:
        raise ValueError(
            f"batch {b} not divisible by {n_microbatches} microbatches"
        )
    mb = b // n_microbatches
    data_size = mesh.shape.get("data", 1)
    if mb % data_size:
        raise ValueError(
            f"microbatch size {mb} not divisible by data axis {data_size}"
        )


def microbatch_rows(tokens: torch.Tensor, mesh, n_microbatches: int
                    ) -> torch.Tensor:
    """This data rank's rows, microbatch-major: its ``mb / dp`` rows of
    each microbatch (the reference's x_spec shards microbatch contents
    over ``data``)."""
    dp = mesh.axis_size("data")
    per = tokens.reshape(n_microbatches, -1, *tokens.shape[1:])
    mine = per.chunk(dp, dim=1)[mesh.axis_index("data")]
    return mine.reshape(-1, *tokens.shape[1:])


def _pipeline_hidden(params: Params, rows: torch.Tensor,
                     cfg: TransformerConfig, mesh, n_microbatches: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """This rank's rows (microbatch-major) through the pipeline -> (final
    normed hidden [rows, s, d] on every stage, aux summed over stages,
    averaged over data, over M)."""
    view = mesh.with_options(batch_stats=False)
    n_stages = mesh.axis_size("pipe")
    stage = mesh.axis_index("pipe")
    n_local = cfg.n_layers // n_stages
    mbl, s = rows.shape[0] // n_microbatches, rows.shape[1]
    ticks = n_microbatches + n_stages - 1
    dev = params["norm_out"].device
    dtype = cfg.dtype
    x_mb = None
    if stage == 0:
        x_mb = embed(params, rows, cfg, view).reshape(
            n_microbatches, mbl, s, -1)
    like = torch.empty((mbl, s, cfg.d_model), dtype=dtype, device=dev)
    # a receive-only handoff's input: a zero on a path to a parameter, so
    # autograd.grad with respect to the params runs its backward too
    anchor = params["norm_out"].reshape(-1)[0] * 0.0
    pending: List = mesh.traffic.setdefault("pending", [])
    acts = y = None
    outputs = [None] * n_microbatches
    aux = torch.zeros((), device=dev)
    for t in range(ticks):
        busy = stage <= t < stage + n_microbatches
        if busy:
            my_in = x_mb[t] if stage == 0 else acts
            y, stage_aux = run_layers(params, my_in, cfg, view,
                                      n_layers=n_local)
            aux = aux + stage_aux
            if stage == n_stages - 1:
                outputs[t - stage] = y
        send = busy and stage < n_stages - 1
        recv = stage > 0 and stage - 1 <= t < stage - 1 + n_microbatches
        if send or recv:
            got = _Handoff.apply(y if send else anchor, mesh, t, ticks,
                                 send, recv, like, pending)
            if recv:
                acts = got
            else:
                aux = aux + got  # a zero that keeps the handoff on the path
    if stage == n_stages - 1:
        banked = torch.stack(outputs)
    else:
        banked = torch.zeros((n_microbatches, mbl, s, cfg.d_model),
                             dtype=dtype, device=dev)
    banked = _FromLastStage.apply(banked, mesh)
    aux = mean_from(reduce_from(aux, mesh, "pipe"), mesh, "data")
    x = _rms_norm(banked.reshape(n_microbatches * mbl, s, -1),
                  params["norm_out"])
    return x, aux / n_microbatches


def pipeline_forward_with_aux(params: Params, tokens: torch.Tensor,
                              cfg: TransformerConfig, mesh,
                              n_microbatches: int = 4,
                              axis_name: str = "pipe"):
    """Forward through pipeline-sharded layers (no gradient): tokens
    [batch, seq], the same on every rank; batch must divide by
    n_microbatches and n_layers by the pipe axis. Returns (logits
    [batch, seq, vocab] in the batch's order, gathered over ``data`` and
    ``model``, aux) like forward_with_aux. ``params`` are this rank's
    blocks under ``pipeline_sharding_rules``."""
    _validate(cfg, mesh, tokens.shape[0], n_microbatches, axis_name)
    with torch.no_grad():
        rows = microbatch_rows(tokens, mesh, n_microbatches)
        x, aux = _pipeline_hidden(params, rows, cfg, mesh, n_microbatches)
        logits = _logits(x, params, cfg, mesh)
        wait_all(mesh.traffic["pending"])
        logits = mesh.all_gather(logits, "model", -1)
        # rows back to the batch's order: [M, dp, mb/dp] -> [M * mb]
        per = logits.reshape(n_microbatches, -1, *logits.shape[1:])
        per = mesh.all_gather(per, "data", 1)
    return per.reshape(tokens.shape[0], *logits.shape[1:]), aux


def pipeline_loss_fn(params: Params, tokens: torch.Tensor,
                     cfg: TransformerConfig, mesh,
                     n_microbatches: int = 4) -> torch.Tensor:
    """Next-token CE through the pipeline (drop-in for loss_fn): the
    rank's data rows' mean, the same on every stage. After a backward
    through it, ``wait_all(mesh.traffic["pending"])`` completes the
    handoffs' sends."""
    _validate(cfg, mesh, tokens.shape[0], n_microbatches, "pipe")
    rows = microbatch_rows(tokens, mesh, n_microbatches)
    x, aux = _pipeline_hidden(params, rows[:, :-1], cfg, mesh, n_microbatches)
    logits = _logits(x, params, cfg, mesh)
    return next_token_loss(logits, aux, rows, cfg, mesh)


def pipeline_value_and_grad(params: Params, tokens: torch.Tensor,
                            cfg: TransformerConfig, mesh,
                            n_microbatches: int, layout):
    """The global batch's pipelined loss and this rank's gradients, as
    ``make_pipeline_train_step`` feeds the optimizer: the embedding's
    gradient (stage 0's) summed over ``pipe``, every gradient averaged
    over ``data``."""
    from .train import tree_leaves

    leaves = tree_leaves(params)
    loss = pipeline_loss_fn(params, tokens, cfg, mesh, n_microbatches)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    wait_all(mesh.traffic["pending"])
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    embed_at = sorted(params).index("embed")  # tree_leaves' sorted order
    grads[embed_at] = mesh.all_reduce(grads[embed_at], "pipe")
    grads = layout.sync_grads(grads)
    return mesh.all_reduce(loss.detach(), "data", "mean"), grads


def pipeline_sharding_rules(cfg: Any = None, mesh: Any = None) -> Any:
    """Param rules for a ("data", "pipe"[, "model"]) mesh: layer stacks
    shard their leading layer axis over ``pipe`` while keeping the
    tensor-parallel ``model`` rules inside each stage (pp x tp). Without
    a model axis on the mesh, the in-stage rules replicate."""
    from .sharding import param_sharding_rules

    rules = param_sharding_rules(cfg, mesh)
    has_model = mesh is not None and "model" in mesh.axis_names

    def stage_rule(rule):
        rest = tuple(rule)[1:]  # the leading dim is the layer axis
        if not has_model:
            rest = tuple(None if a == "model" else a for a in rest)
        return ("pipe", *rest)

    rules["layers"] = {k: stage_rule(v) for k, v in rules["layers"].items()}
    if not has_model:
        rules["embed"] = (None, None)
        rules["unembed"] = (None, None)
    return rules
