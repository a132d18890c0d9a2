"""Causal attention: the plain torch path (counterpart of
``containerpilot_tpu/ops/attention.py``)."""
from __future__ import annotations

import torch

NEG_INF = -1e30  # a large finite negative, as in the reference (not -inf)

__all__ = ["NEG_INF", "causal_attention"]


def causal_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: int = 0
) -> torch.Tensor:
    """[batch, seq, heads, head_dim] -> same; causal masked softmax.

    ``window > 0`` limits each query to the last ``window`` keys:
    position i attends j iff ``i - window < j <= i``. Scores and softmax
    in float32, weights cast to q's dtype, value product accumulated in
    float32, as the reference does."""
    s, hd = q.shape[1], q.shape[3]
    scale = hd ** -0.5
    scores = torch.einsum("bqhk,bshk->bhqs", q.float(), k.float()) * scale
    idx = torch.arange(s, device=q.device)
    mask = idx[None, :] <= idx[:, None]
    if window > 0:
        mask &= idx[None, :] > idx[:, None] - window
    scores = torch.where(mask, scores, NEG_INF)
    weights = torch.softmax(scores, dim=-1).to(q.dtype)
    # in bf16: bf16 x bf16 products, float32 accumulation, one rounding
    return torch.einsum("bhqs,bshk->bqhk", weights, v).to(q.dtype)
