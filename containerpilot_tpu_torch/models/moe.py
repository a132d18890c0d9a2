"""Switch-routed mixture of experts (counterpart of
``containerpilot_tpu/models/moe.py``).

Top-1 (switch) routing with the reference's two layers:

- ``moe_layer``: drop-free, dense dispatch. Every expert runs the whole
  sequence, masked to the tokens routed to it, so a token's result
  depends on that token alone and incremental decoding equals the full
  forward. It costs E times the top-1 expert work.
- ``moe_layer_capacity``: each expert takes at most
  ``ceil(F * s / E)`` tokens of a batch row; overflow tokens drop to the
  residual (training only: ``decode.prefill`` refuses it).

The router product runs in float32 (the package keeps TF32 off); the
expert products take the compute dtype in and give it out, as the
reference's einsums without ``preferred_element_type`` do, and GELU is
the tanh form (``jax.nn.gelu``'s default) in float32. The one-hot is an
``==`` against ``arange``, no host sync, so the slot engine's captured
graph replays it. The products are plain torch (``torch.bmm`` and
``torch.einsum``): the reference computes them outside any Pallas
kernel.

The aux load-balancing loss is the switch formulation:
``E * sum_e(fraction of tokens_e * mean router prob_e)``.

With a ``mesh`` whose ``model`` axis is live, the experts are sharded
over it (``moe_w_in``/``moe_w_out`` hold the rank's E/tp experts): every
rank routes every token with the replicated router, runs its local
experts (dense dispatch, or its slots of the capacity buffer), and the
partial outputs are summed over ``model``. A token's output comes from
exactly one rank, so the sum adds exact zeros and the routes, keep
pattern and values are the unsharded layer's. The gate and the experts'
input enter through ``copy_to`` (their gradient, partial per rank, is
summed). Under data parallelism the fraction and mean router prob are
taken over the global batch (averaged over ``data``, and over ``seq``
under context parallelism), as the reference's batch-sharded program
computes them.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F


def _route(x: torch.Tensor, router_w: torch.Tensor, mesh=None):
    """Top-1 routing shared by both layers -> (probs [b, s, E], gate
    [b, s], onehot [b, s, E] float32, aux_loss scalar). ``argmax``
    returns the first maximal index, as ``jnp.argmax`` does, and the
    gate is the max prob itself, not a gather on the index. Both
    layers take each token's expert from the one-hot alone."""
    n_experts = router_w.shape[-1]
    probs = torch.softmax(x.float() @ router_w.float(), dim=-1)
    expert_idx = torch.argmax(probs, dim=-1)
    gate = probs.max(dim=-1).values
    onehot = (
        expert_idx[..., None]
        == torch.arange(n_experts, device=x.device)
    ).float()
    fraction = onehot.mean(dim=(0, 1))
    router_mean = probs.mean(dim=(0, 1))
    if mesh is not None and mesh.batch_stats:
        from ..parallel.collectives import mean_from

        # the whole batch's statistics: every data and seq shard
        for axis in ("data", "seq"):
            fraction = mean_from(fraction, mesh, axis)
            router_mean = mean_from(router_mean, mesh, axis)
    aux_loss = n_experts * (fraction * router_mean).sum()
    return probs, gate, onehot, aux_loss


def _experts_live(mesh) -> bool:
    return mesh is not None and mesh.axis_size("model") > 1


def _gelu(h: torch.Tensor) -> torch.Tensor:
    return F.gelu(h.float(), approximate="tanh").to(h.dtype)


def moe_layer(
    x: torch.Tensor,         # [b, s, d] in the compute dtype
    router_w: torch.Tensor,  # [d, E]
    w_in: torch.Tensor,      # [E, d, f] (the rank's E/tp under ``mesh``)
    w_out: torch.Tensor,     # [E, f, d]
    mesh=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Drop-free, dense dispatch -> (output [b, s, d], aux_loss).

    Each expert's input is x masked to its tokens ([E, b*s, d]), one
    batched product over the expert axis each way. The combine takes
    each token's own expert row times its gate: the reference's combine
    einsum adds exact zeros for every other expert, so the result is
    the same single rounding of gate * expert_out."""
    _probs, gate, onehot, aux_loss = _route(x, router_w, mesh)
    b, s, d = x.shape
    n_experts = w_in.shape[0]
    dt = x.dtype
    idx = onehot.argmax(dim=-1)  # [b, s]: argmax(probs), as routed
    if _experts_live(mesh):
        from ..parallel.collectives import copy_to, reduce_from

        first = mesh.axis_index("model") * n_experts
        onehot = onehot[..., first:first + n_experts]
        x, gate = copy_to(x, mesh), copy_to(gate, mesh)
        idx = idx - first
        mine = (idx >= 0) & (idx < n_experts)
        idx = idx.clamp(0, n_experts - 1)
    expert_in = onehot.to(dt).permute(2, 0, 1)[..., None] * x  # [E,b,s,d]
    hidden = _gelu(torch.bmm(expert_in.reshape(n_experts, b * s, d),
                             w_in.to(dt)))
    expert_out = torch.bmm(hidden, w_out.to(dt)).reshape(n_experts, b, s, d)
    chosen = expert_out.gather(
        0, idx[None, :, :, None].expand(1, b, s, d))[0]
    if _experts_live(mesh):
        out = chosen * (gate * mine).to(dt)[..., None]
        return reduce_from(out, mesh), aux_loss
    return chosen * gate.to(dt)[..., None], aux_loss


def moe_layer_capacity(
    x: torch.Tensor,
    router_w: torch.Tensor,  # [d, E]
    w_in: torch.Tensor,      # [E, d, f]
    w_out: torch.Tensor,     # [E, f, d]
    capacity_factor: float,
    mesh=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Capacity-bounded switch MoE -> (output [b, s, d], aux_loss).

    A token's queue position within its expert is a cumsum over the
    one-hot along the sequence; tokens with ``pos < capacity`` scatter
    into a [b, E * C + 1, d] buffer whose last row takes every
    overflow token and is dropped, and results gather back by the same
    slot with 0 for dropped tokens. Kept slots are unique, so the
    scatter's gradient is the gather of the buffer's, as for the
    reference's ``.at[].set(mode="drop")`` and ``take(mode="fill")``.
    ``capacity`` is a host integer from static shapes."""
    b, s, d = x.shape
    n_experts = router_w.shape[-1]
    capacity = max(1, math.ceil(capacity_factor * s / n_experts))

    _probs, gate, onehot, aux_loss = _route(x, router_w, mesh)
    expert_idx = onehot.argmax(dim=-1)  # [b, s]
    pos = ((torch.cumsum(onehot, dim=1) - 1.0) * onehot).sum(-1).long()
    keep = pos < capacity
    if _experts_live(mesh):
        from ..parallel.collectives import copy_to, reduce_from

        # the rank's experts own buffer slots; every other token (and
        # every overflow token) goes to the dropped row
        n_experts = w_in.shape[0]
        expert_idx = expert_idx - mesh.axis_index("model") * n_experts
        keep = keep & (expert_idx >= 0) & (expert_idx < n_experts)
        x, gate = copy_to(x, mesh), copy_to(gate, mesh)
    slot = torch.where(keep, expert_idx * capacity + pos,
                       n_experts * capacity)[..., None].expand(b, s, d)

    dt = x.dtype
    buf = x.new_zeros((b, n_experts * capacity + 1, d)).scatter(1, slot, x)
    expert_in = buf[:, :-1].reshape(b, n_experts, capacity, d)
    hidden = _gelu(torch.einsum("becd,edf->becf", expert_in, w_in.to(dt)))
    expert_out = torch.einsum("becf,efd->becd", hidden, w_out.to(dt))
    flat = torch.cat([expert_out.reshape(b, n_experts * capacity, d),
                      expert_out.new_zeros((b, 1, d))], dim=1)
    out = flat.gather(1, slot)
    out = out * (gate * keep).to(dt)[..., None]
    if _experts_live(mesh):
        out = reduce_from(out, mesh)
    return out, aux_loss
