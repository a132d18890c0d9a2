"""Model-FLOPs accounting for the trainer (counterpart of
``containerpilot_tpu/workload/flops.py``).

PaLM-style: a training step costs ~6 FLOPs per parameter per token plus
the attention score/value products, 12 * L * d_model * span per token,
where ``span`` is the mean number of keys a query attends ((seq+1)/2 for
full causal, ~window with a sliding window). MFU = achieved FLOP/s over
the card's published dense bf16 peak, read from this module's own table
of NVIDIA cards (the reference's TPU table describes other chips).
"""
from __future__ import annotations

from typing import Any, Optional

# dense bf16 tensor-core peak FLOP/s (NVIDIA data sheets, SXM parts),
# matched by substring of torch.cuda.get_device_name()
PEAK_BF16 = [
    ("h200", 989e12),
    ("h100", 989e12),
    ("a100", 312e12),
]


def peak_flops(device_name: str) -> Optional[float]:
    """The card's bf16 peak, None when the name is not in the table
    (the CPU, an unlisted card): MFU is then not reported."""
    name = device_name.lower()
    for key, peak in PEAK_BF16:
        if key in name:
            return peak
    return None


def count_params(params: Any) -> int:
    if isinstance(params, dict):
        return sum(count_params(v) for v in params.values())
    return params.numel()


def train_flops_per_token(
    cfg: Any, n_params: int, seq: int, n_frozen: int = 0
) -> float:
    """FLOPs one training step spends per token: the window bounds the
    attention span, only one of E experts runs per token, and frozen
    params (LoRA base) cost 4 FLOPs each instead of 6. The span is the
    exact mean over positions of min(pos+1, window)."""
    w = float(seq if cfg.window <= 0 else min(seq, cfg.window))
    attn_span = w - w * (w - 1.0) / (2.0 * seq)
    active = float(n_params)
    if getattr(cfg, "moe_experts", 0) > 1:
        expert_total = (
            2.0 * cfg.n_layers * cfg.moe_experts * cfg.d_model * cfg.d_ff
        )
        active -= expert_total * (1.0 - 1.0 / cfg.moe_experts)
    frozen = min(float(n_frozen), active)
    return (
        6.0 * (active - frozen)
        + 4.0 * frozen
        + 12.0 * cfg.n_layers * cfg.d_model * attn_span
    )


def train_step_flops(cfg: Any, n_params: int, batch: int,
                     seq: int) -> float:
    return train_flops_per_token(cfg, n_params, seq) * batch * seq
