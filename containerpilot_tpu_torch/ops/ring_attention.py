"""Ring attention: causal attention with the sequence sharded over a
mesh axis (counterpart of ``containerpilot_tpu/ops/ring_attention.py``).

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

The backward, which JAX derives from the forward, is written out here
(``_RingAttention``): the forward saves only its output and the float32
row log-sum-exp, and the backward runs a second ring in the other
direction (``collectives.ring_shift_back``), each K/V block travelling
with its float32 dK/dV accumulators while dQ accumulates at home, with
the flash gradients (``D = rowsum(dO * O)``, ``dS = P * (dO V^T - D)``).
After P hops every dK/dV is back on the rank that owns its block.

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


def _positions(index: int, length: int, device) -> torch.Tensor:
    return index * length + torch.arange(length, device=device)


def _ring_forward(q, k, v, mesh, axis_name):
    """The forward ring -> (out [b, lq, h, hd] in q's dtype, lse [b, kvh,
    g, lq] float32, the row log-sum-exp of the scaled scores)."""
    idx = mesh.axis_index(axis_name)
    size = mesh.axis_size(axis_name)
    b, lq, h, hd = q.shape
    kvh = k.shape[2]
    group = h // kvh
    dev = q.device
    # queries grouped by the kv head they attend with: [b, lq, kvh, g, hd]
    qf = q.float().reshape(b, lq, kvh, group, hd) * hd ** -0.5
    q_pos = _positions(idx, lq, dev)
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
            mask = q_pos[:, None] >= _positions(src, lq, dev)[None, :]
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
    l_safe = torch.clamp_min(l, 1e-30)
    out = acc / l_safe.permute(0, 3, 1, 2)[..., None]
    lse = m + torch.log(l_safe)
    return out.reshape(b, lq, h, hd).to(q.dtype), lse


def _ring_backward(q, k, v, out, lse, d_out, mesh, axis_name):
    """The backward ring -> (dq, dk, dv) in their inputs' dtypes. Hop s
    of the reverse ring gives rank i the block of rank ``(i + s) mod P``
    with that block's dK/dV accumulators; one more reverse hop after the
    last brings every accumulator home."""
    from ..parallel.collectives import ring_shift_back

    idx = mesh.axis_index(axis_name)
    size = mesh.axis_size(axis_name)
    b, lq, h, hd = q.shape
    kvh = k.shape[2]
    group = h // kvh
    dev = q.device
    scale = hd ** -0.5
    qf = q.float().reshape(b, lq, kvh, group, hd) * scale
    dof = d_out.float().reshape(b, lq, kvh, group, hd)
    # D_i = rowsum(dO_i * O_i): [b, kvh, g, lq]
    d_rows = (dof * out.float().reshape(b, lq, kvh, group, hd)).sum(-1)
    d_rows = d_rows.permute(0, 2, 3, 1)
    q_pos = _positions(idx, lq, dev)
    dq = torch.zeros((b, lq, kvh, group, hd), dtype=torch.float32,
                     device=dev)
    k_blk, v_blk = k, v
    dk = torch.zeros((b, lq, kvh, hd), dtype=torch.float32, device=dev)
    dv = torch.zeros_like(dk)
    for s in range(size):
        src = (idx + s) % size
        if src <= idx:
            kf, vf = k_blk.float(), v_blk.float()
            scores = torch.einsum("bqkgd,bskd->bkgqs", qf, kf)
            mask = q_pos[:, None] >= _positions(src, lq, dev)[None, :]
            p = torch.where(mask, torch.exp(scores - lse[..., None]), 0.0)
            dp = torch.einsum("bqkgd,bskd->bkgqs", dof, vf)
            ds = p * (dp - d_rows[..., None])
            dq = dq + torch.einsum("bkgqs,bskd->bqkgd", ds, kf)
            # grouped query heads sum into their kv head
            dk = dk + torch.einsum("bkgqs,bqkgd->bskd", ds, qf)
            dv = dv + torch.einsum("bkgqs,bqkgd->bskd", p, dof)
        if s < size - 1:
            k_blk, v_blk, dk, dv = ring_shift_back([k_blk, v_blk, dk, dv],
                                                   mesh, axis_name)
    if size > 1:  # the accumulators' last hop home
        dk, dv = ring_shift_back([dk, dv], mesh, axis_name)
    dq = (dq * scale).reshape(b, lq, h, hd)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _RingAttention(torch.autograd.Function):
    """The ring with its written-out backward: saves q, k, v, the output
    and the float32 row log-sum-exp, never the [lq, lk] scores."""

    @staticmethod
    def forward(ctx, q, k, v, mesh, axis_name):
        out, lse = _ring_forward(q, k, v, mesh, axis_name)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mesh, ctx.axis_name = mesh, axis_name
        return out

    @staticmethod
    def backward(ctx, d_out):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _ring_backward(q, k, v, out, lse, d_out, ctx.mesh,
                                    ctx.axis_name)
        return dq, dk, dv, None, None


def ring_attention_local(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         mesh, axis_name: str = "seq") -> torch.Tensor:
    """The per-rank body: q [b, lq, h, hd] and k/v [b, lq, kvh, hd], this
    rank's shard of ``axis_name``. Grouped-query attention is native: K/V
    rotate at kv-head width and the queries are carried as [kvh, group]
    pairs of axes, so no repeated copy is made; dK/dV come back at
    kv-head width, summed over each group. Differentiable: a collective
    in the backward too, so every rank of the axis runs it."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v)):
        return _RingAttention.apply(q, k, v, mesh, axis_name)
    return _ring_forward(q, k, v, mesh, axis_name)[0]


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


def ring_blocks(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                mesh, axis_name: str = "seq"):
    """This rank's blocks of whole [batch, seq, heads, head_dim] q/k/v
    (batch over ``data``, sequence over ``axis_name``, heads over
    ``model``), as ``ring_attention`` feeds ``ring_attention_local``.
    Where grouped kv heads do not divide the model axis, k/v are
    repeated to full heads first (the reference's MQA fallback; the GQA
    saving is given up for correctness), outside the ring's autograd
    Function, so autograd sums the copies' gradients."""
    _validate(q, k, v, mesh, axis_name)
    kvh, h = k.shape[2], q.shape[2]
    tp = mesh.axis_size("model")
    if tp > 1 and kvh != h and kvh % tp:
        k = k.repeat_interleave(h // kvh, dim=2)
        v = v.repeat_interleave(h // kvh, dim=2)

    def block(t):
        for dim, axis in ((0, "data"), (1, axis_name), (2, "model")):
            n = mesh.axis_size(axis)
            if n > 1:
                t = t.chunk(n, dim=dim)[mesh.axis_index(axis)]
        return t.contiguous()

    return block(q), block(k), block(v)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mesh, axis_name: str = "seq") -> torch.Tensor:
    """Causal attention of whole [batch, seq, heads, head_dim] inputs
    (the same on every rank) with the sequence ringed over ``axis_name``:
    each rank takes its block (``ring_blocks``), runs
    ``ring_attention_local`` and the blocks are gathered back, so every
    rank returns the whole output. The global sequence length must
    divide by the axis size; a collective over the mesh (every rank
    calls it)."""
    out = ring_attention_local(*ring_blocks(q, k, v, mesh, axis_name), mesh,
                               axis_name)
    for dim, axis in ((2, "model"), (1, axis_name), (0, "data")):
        out = mesh.all_gather(out, axis, dim)
    return out
