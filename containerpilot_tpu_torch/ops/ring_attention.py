"""Ring attention: causal attention with the sequence sharded over a
mesh axis (counterpart of ``containerpilot_tpu/ops/ring_attention.py``,
forward only).

Each rank of the ``seq`` axis holds a contiguous sequence shard of Q, K
and V. K/V blocks rotate around the ring (``Mesh.ring_shift``: one
batch of sends to rank i + 1 and receives from rank i - 1) while every
rank accumulates its queries' attention with blockwise online softmax
in float32: O(local_seq) memory a rank, the numerics of one-device
causal attention up to reassociation.

Hop s gives rank i the K/V block that started on rank ``(i - s) mod
P``; global positions make the causal mask exact across shards. Hop 0 is
the rank's own (diagonal) block, so every query row is live from the
first hop. A block from a later shard is entirely in the future of
every local query: its hop only rotates, with no score computed.

The reference's body is an einsum under ``shard_map``, not a Pallas
kernel, so the hop stays plain torch here (no Hopper kernel replaces
it). ``ring_attention_local`` is the per-rank body the model's
attention hook calls (parallel/context.py); ``ring_attention`` takes the
whole [batch, seq, heads, head_dim] arrays, as the reference does,
cuts each rank's block (batch over ``data``, sequence over ``seq``,
heads over ``model``), rings it and gathers the result back whole.
"""
from __future__ import annotations

import torch

from .attention import NEG_INF


def ring_attention_local(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         mesh, axis_name: str = "seq") -> torch.Tensor:
    """The per-rank body: q [b, lq, h, hd] and k/v [b, lq, kvh, hd], this
    rank's shard of ``axis_name``. Grouped-query attention is native: K/V
    rotate at kv-head width and the queries are carried as [kvh, group]
    pairs of axes, so no repeated copy is made."""
    idx = mesh.axis_index(axis_name)
    size = mesh.axis_size(axis_name)
    b, lq, h, hd = q.shape
    kvh = k.shape[2]
    group = h // kvh
    dev = q.device
    # queries grouped by the kv head they attend with: [b, lq, kvh, g, hd]
    qf = q.float().reshape(b, lq, kvh, group, hd) * hd ** -0.5
    q_pos = idx * lq + torch.arange(lq, device=dev)
    m = torch.full((b, kvh, group, lq), NEG_INF, dtype=torch.float32,
                   device=dev)
    l = torch.zeros((b, kvh, group, lq), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, lq, kvh, group, hd), dtype=torch.float32,
                      device=dev)
    k_blk, v_blk = k, v
    for s in range(size):
        src = (idx - s) % size
        if src <= idx:  # a later shard's keys are all in the future
            scores = torch.einsum("bqkgd,bskd->bkgqs", qf, k_blk.float())
            k_pos = src * lq + torch.arange(lq, device=dev)
            mask = q_pos[:, None] >= k_pos[None, :]  # [lq, lk] global causal
            scores = torch.where(mask, scores, NEG_INF)
            m_new = torch.maximum(m, scores.amax(dim=-1))
            # rows masked so far keep m at NEG_INF; guard the exps
            m_safe = torch.where(m_new <= NEG_INF / 2, 0.0, m_new)
            correction = torch.where(m <= NEG_INF / 2, 0.0,
                                     torch.exp(m - m_safe))
            p = torch.exp(scores - m_safe[..., None])
            p = torch.where(mask, p, 0.0)
            l = l * correction + p.sum(dim=-1)
            corr_acc = correction.permute(0, 3, 1, 2)[..., None]
            acc = acc * corr_acc + torch.einsum("bkgqs,bskd->bqkgd", p,
                                                v_blk.float())
            m = m_new
        if s < size - 1:  # the last hop's rotation would be discarded
            k_blk, v_blk = mesh.ring_shift([k_blk, v_blk], axis_name)
    denom = torch.clamp_min(l, 1e-30).permute(0, 3, 1, 2)[..., None]
    return (acc / denom).reshape(b, lq, h, hd).to(q.dtype)


def _validate(q, k, v, mesh, axis_name):
    if axis_name not in mesh.axis_names:
        raise ValueError(f"mesh has no {axis_name!r} axis: {mesh.axis_names}")
    axis_size = mesh.shape[axis_name]
    if q.shape[1] % axis_size:
        raise ValueError(
            f"seq len {q.shape[1]} not divisible by {axis_name}={axis_size}"
        )
    kvh = k.shape[2]
    if k.shape != v.shape or kvh < 1 or q.shape[2] % kvh:
        raise ValueError(
            f"kv shape {tuple(k.shape)} incompatible with q "
            f"{tuple(q.shape)}: kv heads must divide the query heads and "
            "k/v must agree"
        )


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mesh, axis_name: str = "seq") -> torch.Tensor:
    """Causal attention of whole [batch, seq, heads, head_dim] inputs
    (the same on every rank) with the sequence ringed over ``axis_name``:
    each rank takes its block (batch over ``data``, sequence over
    ``axis_name``, heads over ``model``), runs ``ring_attention_local``
    and the blocks are gathered back, so every rank returns the whole
    output. The global sequence length must divide by the axis size; a
    collective over the mesh (every rank calls it)."""
    _validate(q, k, v, mesh, axis_name)
    kvh, h = k.shape[2], q.shape[2]
    tp = mesh.axis_size("model")
    if tp > 1 and kvh != h and kvh % tp:
        # grouped kv heads don't divide the model axis: the per-rank group
        # factor would be wrong, so rotate repeated heads (the GQA saving
        # is given up for correctness, as in the reference)
        k = k.repeat_interleave(h // kvh, dim=2)
        v = v.repeat_interleave(h // kvh, dim=2)

    def block(t):
        for dim, axis in ((0, "data"), (1, axis_name), (2, "model")):
            n = mesh.axis_size(axis)
            if n > 1:
                t = t.chunk(n, dim=dim)[mesh.axis_index(axis)]
        return t.contiguous()

    out = ring_attention_local(block(q), block(k), block(v), mesh, axis_name)
    for dim, axis in ((2, "model"), (1, axis_name), (0, "data")):
        out = mesh.all_gather(out, axis, dim)
    return out
