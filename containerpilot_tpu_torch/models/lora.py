"""LoRA: low-rank adaptation for parameter-efficient fine-tuning
(counterpart of ``containerpilot_tpu/models/lora.py``).

The base weights stay frozen and a low-rank delta ``W' = W + alpha * A @
B`` is learned on the attention q/v projections. The pairs are stacked
over layers like every base leaf (``A [L, d, r]``, ``B [L, r, out]``),
and training uses the merged formulation: ``apply_lora`` builds ``W +
delta`` once per step, and autograd through the merge gives dA/dB while
the base, which does not require grad, gets no gradient. ``B`` starts at
zero, so a fresh adapter reproduces the base model exactly.

Serving merges once at startup (no runtime cost, the same decode path).
An int8-quantized base is not adaptable in place: merge into the float
weights before quantizing.
"""
from __future__ import annotations

from typing import Dict, Tuple, Union

import torch

from .. import resolve_device
from .transformer import Params, TransformerConfig

LORA_TARGETS = ("wq", "wv")  # the classic attention q/v target set


def lora_out_dim(cfg: TransformerConfig, target: str) -> int:
    """Flattened output width of an attention projection target."""
    if target == "wq":
        return cfg.n_heads * cfg.head_dim
    if target in ("wk", "wv"):
        return cfg.kv_heads * cfg.head_dim
    raise ValueError(
        f"lora target must be one of wq/wk/wv, got {target!r}"
    )


def init_lora_params(
    rng: Union[int, torch.Generator],
    cfg: TransformerConfig,
    rank: int,
    targets: Tuple[str, ...] = LORA_TARGETS,
    device="cuda",
) -> Dict[str, torch.Tensor]:
    """Layer-stacked LoRA pairs in float32: A ~ N(0, 1/r) drawn from
    ``rng`` (a seed, or a torch.Generator on ``device``), B = 0, so the
    initial delta is exactly zero. The numbers differ from the
    reference's ``jax.random`` draws (parity tests bridge JAX adapters)."""
    if rank < 1:
        raise ValueError("lora rank must be >= 1")
    dev = resolve_device(device)
    if isinstance(rng, torch.Generator):
        gen = rng
    elif dev.type == "meta":  # shapes only (checkpoint restore targets)
        gen = None
    else:
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(rng))
    L, d = cfg.n_layers, cfg.d_model
    out: Dict[str, torch.Tensor] = {}
    for target in targets:
        n = lora_out_dim(cfg, target)
        out[f"{target}_a"] = torch.randn(
            (L, d, rank), generator=gen, dtype=torch.float32, device=dev
        ) * rank ** -0.5
        out[f"{target}_b"] = torch.zeros((L, rank, n), dtype=torch.float32,
                                         device=dev)
    return out


def apply_lora(
    params: Params,
    lora: Dict[str, torch.Tensor],
    cfg: TransformerConfig,
    alpha: float = 2.0,
) -> Params:
    """Merged weights ``W + alpha * A @ B`` per target, reshaped to the
    base projection's [L, d, heads, head_dim] and added in the base's
    dtype. A new params dict; the base's tensors are untouched, so
    gradients taken with respect to ``lora`` leave it frozen."""
    layers = dict(params["layers"])
    targets = sorted({k.rsplit("_", 1)[0] for k in lora})
    for target in targets:
        if f"{target}_q" in params["layers"] or target not in layers:
            raise ValueError(
                f"lora target {target!r} not adaptable (int8-quantized "
                "or missing); merge before quantizing"
            )
        base = layers[target]
        delta = torch.einsum(
            "ldr,lrn->ldn", lora[f"{target}_a"], lora[f"{target}_b"]
        ) * alpha
        layers[target] = base + delta.reshape(base.shape).to(base.dtype)
    return {**params, "layers": layers}
