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
from ..ops import prng
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
    rng: Union[int, torch.Tensor],
    cfg: TransformerConfig,
    rank: int,
    targets: Tuple[str, ...] = LORA_TARGETS,
    device="cuda",
) -> Dict[str, torch.Tensor]:
    """Layer-stacked LoRA pairs in float32: A ~ N(0, 1/r), B = 0, so the
    initial delta is exactly zero. ``rng`` is a seed or a threefry key
    [2] (``ops/prng.py``): the reference's draws exactly (``split(rng,
    len(targets))``, a key a target, ``jax.random.normal``)."""
    if rank < 1:
        raise ValueError("lora rank must be >= 1")
    dev = resolve_device(device)
    if not isinstance(rng, torch.Tensor):
        rng = prng.prng_key(int(rng))
    keys = prng.split(rng.cpu(), len(targets))
    L, d = cfg.n_layers, cfg.d_model
    out: Dict[str, torch.Tensor] = {}
    for key, target in zip(keys, targets):
        n = lora_out_dim(cfg, target)
        if dev.type == "meta":  # shapes only (checkpoint restore targets)
            out[f"{target}_a"] = torch.empty((L, d, rank),
                                             dtype=torch.float32, device=dev)
        else:
            out[f"{target}_a"] = prng.normal(
                key.to(dev), (L, d, rank)).mul_(rank ** -0.5)
        out[f"{target}_b"] = torch.zeros((L, rank, n), dtype=torch.float32,
                                         device=dev)
    return out


def holds_block(base_leaf: torch.Tensor, b: torch.Tensor) -> bool:
    """True when ``base_leaf`` (a target's [L, d, heads, head_dim]) is a
    rank's block, its heads of a tensor-parallel layer: narrower than
    the adapter's whole B."""
    return base_leaf[0, 0].numel() < b.shape[-1]


def apply_lora(
    params: Params,
    lora: Dict[str, torch.Tensor],
    cfg: TransformerConfig,
    alpha: float = 2.0,
    mesh=None,
) -> Params:
    """Merged weights ``W + alpha * A @ B`` per target, reshaped to the
    base projection's [L, d, heads, head_dim] and added in the base's
    dtype. A new params dict; the base's tensors are untouched, so
    gradients taken with respect to ``lora`` leave it frozen.

    With a ``mesh``, ``params`` may be a rank's tensor-parallel blocks:
    a target whose base holds only the rank's heads merges the rank's
    columns of B (heads over ``model``), so A's gradient on each rank is
    a partial sum over ``model``."""
    layers = dict(params["layers"])
    targets = sorted({k.rsplit("_", 1)[0] for k in lora})
    for target in targets:
        if f"{target}_q" in params["layers"] or target not in layers:
            raise ValueError(
                f"lora target {target!r} not adaptable (int8-quantized "
                "or missing); merge before quantizing"
            )
        base = layers[target]
        b = lora[f"{target}_b"]
        if mesh is not None and holds_block(base, b):
            width = base[0, 0].numel()
            first = mesh.axis_index("model") * width
            b = b[..., first:first + width]
        delta = torch.einsum("ldr,lrn->ldn", lora[f"{target}_a"], b) * alpha
        layers[target] = base + delta.reshape(base.shape).to(base.dtype)
    return {**params, "layers": layers}
