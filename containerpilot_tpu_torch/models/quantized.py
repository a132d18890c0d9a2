"""Model-level weight-only int8 (counterpart of
``containerpilot_tpu/models/quantized.py``).

``quantize_model_params`` turns every large matmul weight into int8
plus broadcast-ready float32 scales; norms stay float. Two execution
paths, as in the reference:

- dense dequant (``maybe_dequant_layer``): rebuild one layer's weights
  in the compute dtype, for prefill-sized token counts;
- fused int8 (``fused_qkv``/``fused_attn_out``/``fused_mlp``): every
  decode projection runs through ``ops.quant.int8_matmul_padded``, which
  on the card is the hand-written kernel K2 streaming int8 weights.

Quantization runs on the float32 masters, before any cast to the
compute dtype; the scales and the MoE router stay float32
(``cast_params`` leaves every ``*_s`` leaf and ``router`` alone). An MoE
layer's experts quantize per expert and dequantize one layer at a time:
``can_fuse_int8`` refuses a tree without ``w_gate_q``, as the reference
does, so K2 never runs on an MoE model.

Under tensor parallelism (a ``mesh`` with a live ``model`` axis) the
int8 leaves are each rank's blocks, cut from the quantized full masters
with the float rules (``parallel.sharding.shard_params``): a
column-parallel weight holds its own columns' scales, a row-parallel one
(``wo``, ``w_down``) the full per-column scales, so its partial product
is already scaled when it is summed over ``model``. ``can_fuse_int8``
judges the rank's local shapes, and K2 runs on each rank's block.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from ..ops.quant import int8_matmul_padded, quantize_int8_axes

_LAYER_QUANT_AXES: Dict[str, Tuple[int, ...]] = {
    "wq": (1,),        # [L, d, h, hd]: reduce d
    "wk": (1,),
    "wv": (1,),
    "wo": (1, 2),      # [L, h, hd, d]: reduce h, hd
    "w_gate": (1,),    # [L, d, f]
    "w_up": (1,),
    "w_down": (1,),    # [L, f, d]
    "moe_w_in": (2,),  # [L, E, d, f]: reduce d (per expert)
    "moe_w_out": (2,), # [L, E, f, d]
}

_TOP_QUANT_AXES: Dict[str, Tuple[int, ...]] = {
    "embed": (1,),     # [vocab, d]: reduce d -> scale per vocab row
    "unembed": (0,),   # [d, vocab]: reduce d -> scale per vocab col
}


def quantize_model_params(params: Any) -> Any:
    """Each listed weight W becomes W_q (int8) + W_s (float32 scales);
    other leaves unchanged. Run on the float32 masters."""
    out = dict(params)
    layers = dict(params["layers"])
    for key, axes in _LAYER_QUANT_AXES.items():
        if key in layers:
            w_q, scales = quantize_int8_axes(layers.pop(key), axes)
            layers[key + "_q"] = w_q
            layers[key + "_s"] = scales
    out["layers"] = layers
    for key, axes in _TOP_QUANT_AXES.items():
        if key in out:
            w_q, scales = quantize_int8_axes(out.pop(key), axes)
            out[key + "_q"] = w_q
            out[key + "_s"] = scales
    return out


def is_quantized(params: Any) -> bool:
    return "wq_q" in params.get("layers", {}) or "embed_q" in params


def keeps_float32(name: str) -> bool:
    """True for the leaves that stay float32 when the rest is cast to
    the compute dtype: the quantization scales (``*_s``) and the MoE
    ``router``, which the reference reads as its float32 master
    (``router_w.astype(float32)``); a bf16 copy could route a token to
    another expert."""
    return name.endswith("_s") or name == "router"


def cast_params(params: Any, dtype: torch.dtype) -> Any:
    """Cast every floating leaf but ``keeps_float32``'s to the compute
    dtype, once at load: the same numbers as the reference's per-call
    ``.astype(dtype)`` of float32 masters, without the per-call cast.
    int8 leaves, ``*_s`` scales and the router are kept as they are."""
    def cast(name: str, leaf: torch.Tensor) -> torch.Tensor:
        if leaf.is_floating_point() and not keeps_float32(name):
            return leaf.to(dtype)
        return leaf

    out = {k: cast(k, v) for k, v in params.items() if k != "layers"}
    out["layers"] = {
        k: cast(k, v) for k, v in params["layers"].items()
    }
    return out


def maybe_dequant_layer(
    layer_params: Dict[str, torch.Tensor], dtype: torch.dtype
) -> Dict[str, torch.Tensor]:
    """Rebuild a dense layer dict from a quantized one (no-op for
    full-precision input); one layer at a time."""
    if "wq_q" not in layer_params and "moe_w_in_q" not in layer_params:
        return layer_params
    dense = dict(layer_params)
    for key in _LAYER_QUANT_AXES:
        q = dense.pop(key + "_q", None)
        s = dense.pop(key + "_s", None)
        if q is not None:
            dense[key] = (q.float() * s).to(dtype)
    return dense


def embed_lookup(
    params: Any, tokens: torch.Tensor, dtype: torch.dtype
) -> torch.Tensor:
    """Embedding gather that dequantizes only the gathered rows when the
    table is stored int8."""
    if "embed" in params:
        return params["embed"][tokens].to(dtype)
    rows = params["embed_q"][tokens].float()
    scales = params["embed_s"][tokens]  # [..., 1]
    return (rows * scales).to(dtype)


def maybe_dequant_top(params: Any, key: str, dtype: torch.dtype) -> torch.Tensor:
    """Fetch a top-level tensor, dequantizing if stored int8."""
    if key in params:
        return params[key].to(dtype)
    return (params[key + "_q"].float() * params[key + "_s"]).to(dtype)


def param_bytes(params: Any) -> int:
    total = 0
    for key, leaf in params.items():
        if key == "layers":
            total += param_bytes(leaf)
        else:
            total += leaf.numel() * leaf.element_size()
    return total


# ---------------------------------------------------------------------------
# fused int8 serving path: projections through the dequant-GEMM kernel
# ---------------------------------------------------------------------------

# beyond this many rows the GEMMs are compute-bound and dense wins;
# below it they are weight-streaming-bound and int8 halves the bytes
FUSED_MAX_ROWS = 256

_GEMM_TILE = 128


def can_fuse_int8(
    layers: Dict[str, torch.Tensor], cfg: Any, rows: int
) -> bool:
    """True when the decode projections can run through the fused int8
    GEMM: dense (non-MoE) quantized weights, a weight-streaming-bound
    row count, tile-aligned dims (the reference's rule), judged on the
    leaves' own shapes (a rank's blocks under tensor parallelism)."""
    if "wq_q" not in layers or "w_gate_q" not in layers:
        return False
    if rows > FUSED_MAX_ROWS:
        return False
    _l, d, heads, hd = layers["wq_q"].shape
    kv_out = layers["wk_q"].shape[2] * hd
    return all(n % _GEMM_TILE == 0 for n in (
        d, heads * hd, kv_out, layers["w_gate_q"].shape[2]))


def _fused_proj(
    h2d: torch.Tensor, layer_params: Dict[str, torch.Tensor], key: str
) -> torch.Tensor:
    """[rows, k] @ dequant(W[key]); W's non-layer axes flatten to the
    GEMM's (k, n)."""
    k = h2d.shape[-1]
    return int8_matmul_padded(
        h2d,
        layer_params[key + "_q"].reshape(k, -1),
        layer_params[key + "_s"].reshape(-1),
    )


def _sum_over_model(out: torch.Tensor, mesh) -> torch.Tensor:
    """A row-parallel partial product summed over ``model``."""
    if mesh is None or mesh.axis_size("model") == 1:
        return out
    return mesh.all_reduce(out, "model")


def fused_qkv(
    x: torch.Tensor, layer_params: Dict[str, torch.Tensor], cfg: Any,
    offset, mesh=None,
):
    """The _qkv contract (pre-norm, projections, RoPE at an int or
    [batch] per-row ``offset``) with int8-fused projections. Under
    tensor parallelism q and sharded k/v are the rank's heads; kv heads
    that do not divide by ``model`` are projected whole and cut to the
    kv of the rank's query heads, as ``_qkv`` does."""
    from .transformer import _rms_norm, _rope, repeat_kv

    b, s, d = x.shape
    h = _rms_norm(x, layer_params["norm_attn"]).reshape(b * s, d)
    hd = cfg.head_dim
    heads = layer_params["wq_q"].shape[1]
    kvh = layer_params["wk_q"].shape[1]
    q = _fused_proj(h, layer_params, "wq").reshape(b, s, heads, hd)
    k = _fused_proj(h, layer_params, "wk").reshape(b, s, kvh, hd)
    v = _fused_proj(h, layer_params, "wv").reshape(b, s, kvh, hd)
    if heads < cfg.n_heads and kvh == cfg.kv_heads:  # kv replicated
        first = mesh.axis_index("model") * heads
        k, v = (repeat_kv(t, cfg.n_heads)[:, :, first:first + heads]
                for t in (k, v))
    return _rope(q, cfg.rope_theta, offset), _rope(k, cfg.rope_theta, offset), v


def fused_attn_out(
    x: torch.Tensor, attn: torch.Tensor,
    layer_params: Dict[str, torch.Tensor], cfg: Any, mesh=None,
) -> torch.Tensor:
    """Output projection + residual, int8-fused (wo's h*hd axes flatten
    to the GEMM's k); row-parallel under tensor parallelism."""
    b, s, h, hd = attn.shape
    out = _fused_proj(
        attn.reshape(b * s, h * hd), layer_params, "wo"
    ).reshape(b, s, -1)
    return x + _sum_over_model(out, mesh)


def fused_mlp(
    x: torch.Tensor, layer_params: Dict[str, torch.Tensor], cfg: Any,
    mesh=None,
) -> torch.Tensor:
    """SwiGLU block + residual with all three GEMMs int8-fused (gate/up
    column-parallel, down row-parallel under tensor parallelism)."""
    from .transformer import _rms_norm

    b, s, d = x.shape
    h = _rms_norm(x, layer_params["norm_mlp"]).reshape(b * s, d)
    gate = _fused_proj(h, layer_params, "w_gate").float()
    up = _fused_proj(h, layer_params, "w_up").float()
    act = (torch.nn.functional.silu(gate) * up).to(cfg.dtype)
    down = _fused_proj(act, layer_params, "w_down").reshape(b, s, d)
    return x + _sum_over_model(down, mesh)


# ---------------------------------------------------------------------------
# step-program face: int8 weights under the slot engine
# ---------------------------------------------------------------------------

# Defined lazily (module __getattr__): transformer.py imports this module
# at its top, and the step-program base lives in stepprog.py, which
# imports transformer; an eager subclass here would close that cycle.
_QUANTIZED_PROGRAM = None


def _quantized_program_class():
    global _QUANTIZED_PROGRAM
    if _QUANTIZED_PROGRAM is not None:
        return _QUANTIZED_PROGRAM
    from .stepprog import PlainStepProgram

    class QuantizedStepProgram(PlainStepProgram):
        """Weight-only-int8 step program for the slot engine: the same
        step body and captured round as the plain program. Its pool
        step runs every projection through ``fused_qkv``,
        ``fused_attn_out`` and ``fused_mlp`` (K2 at m = S on the card)
        whenever ``can_fuse_int8`` holds for S rows, and dequantizes one
        layer at a time otherwise. It refuses params that are not
        quantized, so a mis-wired full-precision dict fails at startup
        rather than as 4x the expected memory at first decode."""

        def __init__(self, cfg, params, max_len, slots, chunk, rounds=1,
                     mesh=None):
            if not is_quantized(params):
                raise ValueError(
                    "QuantizedStepProgram needs quantize_model_params "
                    "output (no *_q leaves found)"
                )
            super().__init__(cfg, params, max_len, slots, chunk,
                             rounds=rounds, mesh=mesh)

    _QUANTIZED_PROGRAM = QuantizedStepProgram
    return _QUANTIZED_PROGRAM


def __getattr__(name: str):
    if name == "QuantizedStepProgram":
        return _quantized_program_class()
    raise AttributeError(name)
