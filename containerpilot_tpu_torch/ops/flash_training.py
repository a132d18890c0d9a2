"""Memory-efficient causal attention for training: the flash-attention
algorithm with a written-out backward, O(seq) activation memory both
ways (counterpart of ``containerpilot_tpu/ops/flash_training.py``).

The plain path (attention.py) materializes the [seq, seq] score matrix
in both passes; this op streams KV blocks with online softmax in the
forward (saving only out + per-row logsumexp) and replays blocks in the
backward using the standard flash gradients:

    D_i   = rowsum(dO_i * O_i)
    dP_ij = dO_i @ V_j^T
    dS_ij = P_ij * (dP_ij - D_i)
    dQ_i += dS_ij @ K_j ;  dK_j += dS_ij^T @ Q_i ;  dV_j += P_ij^T @ dO_i

Fully-future (qi < kj) block pairs are skipped: causal attention does
about half the block-pair work. The reference's body is ``lax.scan``
over einsums, not a Pallas kernel, so this stays plain torch (Python
loops over blocks); the card's training path takes the flash kernels
(ops/flash.py) instead. Cross-rank sequence sharding is
ops/ring_attention.py.
"""
from __future__ import annotations

import torch

from .attention import NEG_INF

__all__ = ["memory_efficient_attention"]


def _check(q: torch.Tensor, block: int) -> None:
    s = q.shape[1]
    if s % block:
        raise ValueError(f"seq len {s} not a multiple of block {block}")


def _block_mask(qi: int, kj: int, block: int, device) -> torch.Tensor:
    """[block, block] bool: the global causal mask of block pair (qi, kj),
    shared by forward and backward so the passes cannot disagree."""
    pos = torch.arange(block, device=device)
    return (qi * block + pos)[:, None] >= (kj * block + pos)[None, :]


def _forward(q, k, v, block):
    """-> (out [b, s, h, hd] in q's dtype, lse [b, h, s] float32)."""
    b, s, h, hd = q.shape
    scale = hd ** -0.5
    n = s // block
    outs, lses = [], []
    for qi in range(n):
        qf = q[:, qi * block:(qi + 1) * block].float() * scale
        m = torch.full((b, h, block), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((b, h, block), dtype=torch.float32, device=q.device)
        acc = torch.zeros((b, block, h, hd), dtype=torch.float32,
                          device=q.device)
        for kj in range(qi + 1):  # later blocks are all in the future
            kf = k[:, kj * block:(kj + 1) * block].float()
            vf = v[:, kj * block:(kj + 1) * block].float()
            mask = _block_mask(qi, kj, block, q.device)
            scores = torch.where(mask, torch.einsum("bqhd,bkhd->bhqk", qf,
                                                    kf), NEG_INF)
            m_new = torch.maximum(m, scores.amax(dim=-1))
            m_safe = torch.where(m_new <= NEG_INF / 2, 0.0, m_new)
            p = torch.where(mask, torch.exp(scores - m_safe[..., None]), 0.0)
            corr = torch.where(m <= NEG_INF / 2, 0.0, torch.exp(m - m_safe))
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr.transpose(1, 2)[..., None] + torch.einsum(
                "bhqk,bkhd->bqhd", p, vf)
            m = m_new
        l_safe = torch.clamp_min(l, 1e-30)
        outs.append((acc / l_safe.transpose(1, 2)[..., None]).to(q.dtype))
        lses.append(m + torch.log(l_safe))
    return torch.cat(outs, dim=1), torch.cat(lses, dim=-1)


def _backward(q, k, v, out, lse, d_out, block):
    b, s, h, hd = q.shape
    scale = hd ** -0.5
    n = s // block
    # D_i = rowsum(dO * O): [b, h, s]
    d_rows = (d_out.float() * out.float()).sum(-1).transpose(1, 2)
    dq = torch.zeros((b, s, h, hd), dtype=torch.float32, device=q.device)
    dks, dvs = [], []
    for kj in range(n):
        kf = k[:, kj * block:(kj + 1) * block].float()
        vf = v[:, kj * block:(kj + 1) * block].float()
        dk = torch.zeros((b, block, h, hd), dtype=torch.float32,
                         device=q.device)
        dv = torch.zeros_like(dk)
        for qi in range(kj, n):  # only past-or-diagonal pairs contribute
            rows = slice(qi * block, (qi + 1) * block)
            qf = q[:, rows].float() * scale
            dof = d_out[:, rows].float()
            mask = _block_mask(qi, kj, block, q.device)
            scores = torch.einsum("bqhd,bkhd->bhqk", qf, kf)
            p = torch.where(mask, torch.exp(scores - lse[..., rows, None]),
                            0.0)
            dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
            ds = p * (dp - d_rows[..., rows, None])
            dk = dk + torch.einsum("bhqk,bqhd->bkhd", ds, qf)
            dv = dv + torch.einsum("bhqk,bqhd->bkhd", p, dof)
            dq[:, rows] += torch.einsum("bhqk,bkhd->bqhd", ds, kf)
        dks.append(dk)
        dvs.append(dv)
    dq = dq * scale
    return (dq.to(q.dtype), torch.cat(dks, dim=1).to(k.dtype),
            torch.cat(dvs, dim=1).to(v.dtype))


class _MemoryEfficientAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, block):
        out, lse = _forward(q, k, v, block)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.block = block
        return out

    @staticmethod
    def backward(ctx, d_out):
        q, k, v, out, lse = ctx.saved_tensors
        return (*_backward(q, k, v, out, lse, d_out, ctx.block), None)


def memory_efficient_attention(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, block: int = 256
                               ) -> torch.Tensor:
    """Causal attention with O(seq) activation memory in both passes.

    Same [batch, seq, heads, head_dim] contract as causal_attention; seq
    must be a multiple of ``block`` (pad upstream for ragged lengths)."""
    _check(q, block)
    return _MemoryEfficientAttention.apply(q, k, v, block)
