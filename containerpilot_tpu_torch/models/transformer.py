"""The flagship decoder-only transformer in PyTorch (counterpart of
``containerpilot_tpu/models/transformer.py``).

Plain functions over a params dict that keeps the reference's leaf names
and stacked-per-layer shapes (``wq [L, d, h, hd]``, ``wo [L, h, hd, d]``,
...), so a JAX pytree bridges leaf for leaf (``bridge.py``). The
reference's ``lax.scan`` over layers is a Python loop over the layer
index; its ``jax.checkpoint`` per layer is ``torch.utils.checkpoint``
(``remat``). Training differentiates the float32 masters through
autograd: attention at/above the flash threshold is ``flash_attention``
(K1 forward, K3 + K4 backward on the card) whenever autograd records,
and the GQA-native forward-only kernel otherwise (serving).

Order of operations follows the reference exactly, because that is
where bf16 numbers diverge:

- ``_rms_norm``: variance in float32, ``rsqrt`` cast to x's dtype, then
  two multiplies in x's dtype;
- ``_rope``: the half-split form; cos/sin computed in float32 and cast
  to x's dtype before the multiply;
- projections cast to the compute dtype right away run as one matmul in
  that dtype (bf16 inputs, float32 accumulation, one rounding — the
  package disables reduced-precision bf16 reductions); products the
  reference keeps in float32 (gate/up, logits) go through ``_dot_f32``,
  which never rounds them to bf16.

Tensor parallelism (``mesh`` with a ``model`` axis > 1; the params are
then each rank's blocks, ``parallel/sharding.py``) follows Megatron: the
normed input enters each column-parallel region through ``copy_to``
(identity forward, gradient summed over ``model``), attention runs on the
rank's local heads (K1/K3/K4 at h/tp heads), ``wo`` and ``w_down`` end
in one all-reduce each (``reduce_from``), the vocab-parallel embed is a
masked lookup of the rank's rows summed over ``model``, and the loss's
log-softmax runs across vocab shards (a max and a sum all-reduced, the
target logit from its owning shard). MoE experts over ``model`` run the
dense dispatch on the rank's local experts and sum the partial outputs.
Under FSDP (``mesh.fsdp``) each layer gathers its data-sharded
parameters at use. With ``mesh=None``, or a world of one, every function
runs exactly the unsharded path.

Context parallelism binds ``cfg.attention_fn`` (parallel/context.py's
ring over the mesh's ``seq`` axis): the layers then see a rank's
sequence shard, RoPE runs at the shard's global positions
(``seq_offset``), and the hook replaces the auto attention, taking
unrepeated kv heads when it is marked ``gqa_native``.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Any, Dict, Tuple, Union

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from .. import resolve_device
from ..ops import prng, tuning
from ..ops.attention import causal_attention
from ..ops.flash import flash_attention, flash_attention_forward
from .moe import moe_layer, moe_layer_capacity
from .quantized import embed_lookup, maybe_dequant_layer, maybe_dequant_top


@dataclass(frozen=True)
class TransformerConfig:
    """Field for field the reference's config, with ``dtype`` a torch
    dtype. ``attention_fn`` is a hook that replaces the auto attention
    (``parallel.context.context_parallel_config`` binds the ring); it
    takes no part in equality or hashing."""

    vocab_size: int = 32_000
    d_model: int = 512
    n_heads: int = 8
    n_kv_heads: int = 0
    n_layers: int = 4
    d_ff: int = 1408
    max_seq_len: int = 2048
    rope_theta: float = 10_000.0
    dtype: Any = torch.bfloat16
    flash_min_seq: int = tuning.AUTO
    remat: Any = True
    loss_chunk: int = 0
    kv_int8: bool = False
    window: int = 0
    moe_experts: int = 0
    moe_aux_weight: float = 0.01
    moe_train_capacity: float = 0.0
    attention_fn: Any = field(default=None, compare=False, repr=False)

    def __post_init__(self) -> None:
        if self.moe_train_capacity > 0 and self.moe_experts == 0:
            raise ValueError("moe_train_capacity requires moe_experts > 0")
        if self.remat not in (True, False, "full", "dots", "none"):
            raise ValueError(
                f"remat must be True/False/'full'/'dots'/'none', "
                f"got {self.remat!r}"
            )
        if self.loss_chunk < 0:
            raise ValueError(
                f"loss_chunk must be >= 0, got {self.loss_chunk}"
            )

    @property
    def head_dim(self) -> int:
        if self.d_model % self.n_heads:
            raise ValueError("d_model must divide by n_heads")
        return self.d_model // self.n_heads

    @property
    def kv_heads(self) -> int:
        kv = self.n_kv_heads or self.n_heads
        if self.n_heads % kv:
            raise ValueError("n_heads must divide by n_kv_heads")
        return kv


Params = Dict[str, Any]

FLASH_BLOCK = 128


def flash_eligible(cfg: TransformerConfig, seq: int, kind: str = "train",
                   device="cuda") -> bool:
    """True when attention on ``device`` should take the flash kernel:
    at/above the threshold of that device's platform and block-aligned
    (a window must be block-aligned too)."""
    min_seq = tuning.resolve_min_seq(cfg.flash_min_seq, kind=kind,
                                     device=device)
    return (
        min_seq > 0
        and seq >= min_seq
        and seq % FLASH_BLOCK == 0
        and (cfg.window == 0 or cfg.window % FLASH_BLOCK == 0)
    )


def init_params(
    rng: Union[int, torch.Tensor], cfg: TransformerConfig, device="cuda",
) -> Params:
    """Float32 master parameters, stacked per layer. ``rng`` is a seed or
    a threefry key [2] (``ops/prng.py``): the reference's
    ``init_params(PRNGKey(seed))`` exactly, its key tree (``split(rng,
    4)`` into embed, attention, MLP and unembed keys, then a key a leaf)
    and its ``jax.random.normal`` draws, each leaf made on ``device`` by
    ``prng.normal`` in chunks of flat counters. Cast once to the compute
    dtype with ``quantized.cast_params``. An MoE config (``moe_experts >
    0``) gets ``router [L, d, E]``, ``moe_w_in [L, E, d, f]`` and
    ``moe_w_out [L, E, f, d]`` in place of the SwiGLU weights, with the
    same fan-in scaling and keys."""
    dev = resolve_device(device)
    d, h, hd, f, L = (
        cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.d_ff, cfg.n_layers,
    )
    kv = cfg.kv_heads
    if not isinstance(rng, torch.Tensor):
        rng = prng.prng_key(int(rng))
    keys = list(prng.split(rng.cpu(), 4))
    ks, km = list(prng.split(keys[1], 4)), list(prng.split(keys[2], 3))

    def normal(key, shape, scale):
        if dev.type == "meta":
            # shapes only: an op on meta tensors imports torch._dynamo
            # (seconds), which a restore target does not need
            return torch.empty(shape, dtype=torch.float32, device=dev)
        return prng.normal(key.to(dev), shape).mul_(scale)

    def dense(key, shape, fan_in):
        return normal(key, shape, fan_in ** -0.5)

    layers = {
        "wq": dense(ks[0], (L, d, h, hd), d),
        "wk": dense(ks[1], (L, d, kv, hd), d),
        "wv": dense(ks[2], (L, d, kv, hd), d),
        "wo": dense(ks[3], (L, h, hd, d), h * hd),
        "norm_attn": torch.ones((L, d), dtype=torch.float32, device=dev),
        "norm_mlp": torch.ones((L, d), dtype=torch.float32, device=dev),
    }
    if cfg.moe_experts > 0:
        E = cfg.moe_experts
        layers["router"] = dense(km[0], (L, d, E), d)
        layers["moe_w_in"] = dense(km[1], (L, E, d, f), d)
        layers["moe_w_out"] = dense(km[2], (L, E, f, d), f)
    else:
        layers["w_gate"] = dense(km[0], (L, d, f), d)
        layers["w_up"] = dense(km[1], (L, d, f), d)
        layers["w_down"] = dense(km[2], (L, f, d), f)
    return {
        "embed": normal(keys[0], (cfg.vocab_size, d), 0.02),
        "layers": layers,
        "norm_out": torch.ones((d,), dtype=torch.float32, device=dev),
        "unembed": dense(keys[3], (d, cfg.vocab_size), d),
    }


def layer_params(params: Params, i: int) -> Dict[str, torch.Tensor]:
    """Layer i's slice of the stacked layer params (views, no copy)."""
    return {k: v[i] for k, v in params["layers"].items()}


class _MmF32(torch.autograd.Function):
    """``torch.mm(a, b, out_dtype=float32)`` on the card, which has no
    derivative of its own: the backward is two bf16 GEMMs with float32
    accumulation, each gradient in its input's dtype.

    Precision differs from the reference here: the float32 cotangent is
    rounded to bf16 before both GEMMs, where the reference's transpose
    contracts the float32 cotangent itself. A float32 GEMM for the
    activation gradient would cost far more than the step's whole bf16
    product time; the card's check holds this backward to 1e-2 of the
    float32 product. A frozen operand (the unembed under LoRA) costs no
    GEMM."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.mm(a, b, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, grad):
        a, b = ctx.saved_tensors
        g = grad.to(a.dtype)
        need_a, need_b = ctx.needs_input_grad
        return (g @ b.t() if need_a else None,
                a.t() @ g if need_b else None)


def _dot_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [..., k] @ b [k, n] -> float32 without rounding the product to
    a narrower dtype: the reference's einsum with
    preferred_element_type=float32. On the card a bf16 GEMM with a
    float32 output; on the CPU the exact float32 product of the
    (exactly representable) bf16 values."""
    if a.dtype == torch.float32:
        return a @ b
    if a.is_cuda:
        out = _MmF32.apply(a.reshape(-1, a.shape[-1]), b)
        return out.reshape(*a.shape[:-1], b.shape[-1])
    return a.float() @ b.float()


def _rms_norm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    var = x.float().square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + 1e-6).to(x.dtype)) * scale.to(x.dtype)


def _rope(
    x: torch.Tensor, theta: float, offset: Union[int, torch.Tensor] = 0
) -> torch.Tensor:
    """Rotary embedding over head_dim, half-split form. x: [batch, seq,
    heads, head_dim]; ``offset`` shifts the absolute positions: an int
    for the whole batch (prefill, decode chunks), or a [batch] integer
    tensor of per-row positions on x's device (a slot pool, where every
    row sits at its own position). Both forms compute the same float32
    angles for the same position."""
    b, s, h, hd = x.shape
    half = hd // 2
    dev = x.device
    freqs = theta ** (
        -torch.arange(0, half, dtype=torch.float32, device=dev) / half
    )
    steps = torch.arange(s, dtype=torch.float32, device=dev)
    if isinstance(offset, torch.Tensor):
        positions = offset.to(torch.float32)[:, None] + steps[None, :]
        angles = positions[:, :, None] * freqs
        cos = torch.cos(angles)[:, :, None, :].to(x.dtype)
        sin = torch.sin(angles)[:, :, None, :].to(x.dtype)
    else:
        angles = (offset + steps)[:, None] * freqs[None, :]
        cos = torch.cos(angles)[None, :, None, :].to(x.dtype)
        sin = torch.sin(angles)[None, :, None, :].to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _proj(h: torch.Tensor, w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """h [..., k] @ w (leading axis k, the rest flattened) in the
    compute dtype: float32 accumulation, one rounding."""
    return torch.matmul(h, w.reshape(w.shape[0], -1).to(dtype))


def _tp(mesh) -> bool:
    """True when ``mesh`` shards the model over a live ``model`` axis."""
    return mesh is not None and mesh.axis_size("model") > 1


def _qkv(
    x: torch.Tensor, lp: Dict[str, torch.Tensor], cfg: TransformerConfig,
    offset: Union[int, torch.Tensor] = 0, mesh=None,
):
    """Pre-norm + q/k/v projections with RoPE at ``offset`` (an int, or
    [batch] per-row positions); k/v keep ``cfg.kv_heads`` heads. Under
    tensor parallelism q and (sharded) k/v are the rank's local heads;
    replicated k/v (kv heads that do not divide by ``model``) are
    computed whole, their gradient summed over ``model``, and cut to the
    kv heads of the rank's q heads."""
    dt = cfg.dtype
    b, s, _ = x.shape
    h = _rms_norm(x, lp["norm_attn"])
    hd = cfg.head_dim
    if _tp(mesh):
        from ..parallel.collectives import copy_to

        hq = copy_to(h, mesh)
        heads = lp["wq"].shape[1]
        q = _proj(hq, lp["wq"], dt).reshape(b, s, heads, hd)
        if lp["wk"].shape[1] < cfg.kv_heads:  # kv heads sharded
            kvh = lp["wk"].shape[1]
            k = _proj(hq, lp["wk"], dt).reshape(b, s, kvh, hd)
            v = _proj(hq, lp["wv"], dt).reshape(b, s, kvh, hd)
        else:
            first = mesh.axis_index("model") * heads
            k, v = (
                repeat_kv(copy_to(_proj(h, lp[w], dt), mesh).reshape(
                    b, s, cfg.kv_heads, hd), cfg.n_heads)[:, :, first:first + heads]
                for w in ("wk", "wv"))
        return (_rope(q, cfg.rope_theta, offset),
                _rope(k, cfg.rope_theta, offset), v)
    q = _proj(h, lp["wq"], dt).reshape(b, s, cfg.n_heads, hd)
    k = _proj(h, lp["wk"], dt).reshape(b, s, cfg.kv_heads, hd)
    v = _proj(h, lp["wv"], dt).reshape(b, s, cfg.kv_heads, hd)
    return _rope(q, cfg.rope_theta, offset), _rope(k, cfg.rope_theta, offset), v


def repeat_kv(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    """Broadcast GQA k/v [b, s, kv, hd] to [b, s, n_heads, hd]."""
    kv = x.shape[2]
    if kv == n_heads:
        return x
    return x.repeat_interleave(n_heads // kv, dim=2)


def _attn_out(
    x: torch.Tensor, attn: torch.Tensor, lp: Dict[str, torch.Tensor],
    cfg: TransformerConfig, mesh=None,
) -> torch.Tensor:
    """Output projection + residual; row-parallel under tensor
    parallelism (the rank's heads, then one all-reduce)."""
    b, s, h, hd = attn.shape
    wo = lp["wo"].reshape(h * hd, -1)
    out = _proj(attn.reshape(b, s, h * hd), wo, cfg.dtype)
    if _tp(mesh):
        from ..parallel.collectives import reduce_from

        out = reduce_from(out, mesh)
    return x + out


def _mlp(
    x: torch.Tensor, lp: Dict[str, torch.Tensor], cfg: TransformerConfig,
    mesh=None,
) -> torch.Tensor:
    """SwiGLU block + residual; gate and up stay float32 as in the
    reference, the activation is cast once. Under tensor parallelism
    gate/up are column-parallel and down row-parallel (one all-reduce)."""
    dt = cfg.dtype
    h = _rms_norm(x, lp["norm_mlp"])
    if _tp(mesh):
        from ..parallel.collectives import copy_to, reduce_from

        h = copy_to(h, mesh)
    gate = _dot_f32(h, lp["w_gate"].to(dt))
    up = _dot_f32(h, lp["w_up"].to(dt))
    act = (torch.nn.functional.silu(gate) * up).to(dt)
    out = _proj(act, lp["w_down"], dt)
    if _tp(mesh):
        out = reduce_from(out, mesh)
    return x + out


def _ffn(
    x: torch.Tensor, lp: Dict[str, torch.Tensor], cfg: TransformerConfig,
    mesh=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The feed-forward half -> (x, aux_loss): dense SwiGLU, or the
    switch-routed experts on the normed input plus the residual (the
    capacity layer when ``cfg.moe_train_capacity > 0``)."""
    if cfg.moe_experts > 0:
        h = _rms_norm(x, lp["norm_mlp"])
        experts = (lp["router"], lp["moe_w_in"], lp["moe_w_out"])
        if cfg.moe_train_capacity > 0:
            out, aux = moe_layer_capacity(h, *experts,
                                          cfg.moe_train_capacity, mesh=mesh)
        else:
            out, aux = moe_layer(h, *experts, mesh=mesh)
        return x + out, aux
    return _mlp(x, lp, cfg, mesh), torch.zeros((), device=x.device)


def _attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    cfg: TransformerConfig, kind: str,
) -> torch.Tensor:
    """The auto attention: flash at/above the threshold, the plain masked
    softmax below it. While autograd records, flash is the
    differentiable ``flash_attention`` on k/v repeated to full heads (the
    reference's ``_layer``); otherwise the GQA-native forward kernel.
    The head count is q's own (the rank's local heads under tensor
    parallelism)."""
    s, heads = q.shape[1], q.shape[2]
    if cfg.attention_fn is not None:
        return hooked_attention(q, k, v, cfg)
    if flash_eligible(cfg, s, kind=kind, device=q.device):
        bq, bk = tuning.pick_blocks(kind, s, device=q.device)
        if torch.is_grad_enabled():
            return flash_attention(
                q, repeat_kv(k, heads), repeat_kv(v, heads),
                block_q=bq, block_k=bk, window=cfg.window,
            )
        return flash_attention_forward(
            q, k, v, block_q=bq, block_k=bk, window=cfg.window
        )
    return causal_attention(
        q, repeat_kv(k, heads), repeat_kv(v, heads),
        window=cfg.window,
    )


def hooked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     cfg: TransformerConfig) -> torch.Tensor:
    """``cfg.attention_fn`` on the rank's heads: k/v unrepeated when the
    hook is marked ``gqa_native`` (the ring rotates the small grouped
    k/v), else repeated to q's heads."""
    fn = cfg.attention_fn
    if getattr(fn, "gqa_native", False):
        return fn(q, k, v)
    heads = q.shape[2]
    return fn(q, repeat_kv(k, heads), repeat_kv(v, heads))


def seq_offset(cfg: TransformerConfig, s: int) -> int:
    """The global position of a sequence shard's first token: under an
    attention hook bound to a mesh's ``seq`` axis (``seq_mesh``), the
    rank's seq index times the local length s (RoPE runs at global
    positions); else 0."""
    mesh = getattr(cfg.attention_fn, "seq_mesh", None)
    if mesh is None:
        return 0
    return mesh.axis_index(getattr(cfg.attention_fn, "seq_axis", "seq")) * s


def _fsdp_gather(t: torch.Tensor, rule, mesh, stacked: bool = False):
    """FSDP: a data-sharded parameter gathered whole (its model-local
    block) at use; the gradient is reduce-scattered back. ``stacked``:
    ``t`` is one layer's slice of a stacked leaf (the rule's dim 0 is the
    layer axis)."""
    if "data" not in rule:
        return t
    from ..parallel.collectives import gather_from

    return gather_from(t, mesh, "data", rule.index("data") - int(stacked))


def _use_top(params: Params, key: str, cfg: TransformerConfig, mesh=None):
    """A top-level leaf in the compute dtype, gathered under FSDP."""
    if mesh is not None and mesh.fsdp is not None:
        return _fsdp_gather(params[key], mesh.fsdp[key], mesh).to(cfg.dtype)
    return maybe_dequant_top(params, key, cfg.dtype)


def _layer(
    x: torch.Tensor, lp: Dict[str, torch.Tensor], cfg: TransformerConfig,
    mesh=None,
):
    """One transformer block -> (x, aux_loss)."""
    lp = maybe_dequant_layer(lp, cfg.dtype)
    if mesh is not None and mesh.fsdp is not None:
        rules = mesh.fsdp["layers"]
        lp = {k: _fsdp_gather(v, rules[k], mesh, stacked=True)
              for k, v in lp.items()}
    q, k, v = _qkv(x, lp, cfg, offset=seq_offset(cfg, x.shape[1]), mesh=mesh)
    attn = _attention(q, k, v, cfg, kind="train")
    x = _attn_out(x, attn, lp, cfg, mesh)
    return _ffn(x, lp, cfg, mesh)


# the reference's dots_with_no_batch_dims_saveable: keep the outputs of
# plain 2-D matrix products (the projections), recompute the rest
_DOTS_SAVEABLE = (torch.ops.aten.mm.default, torch.ops.aten.mm.dtype)


def _dots_policy(ctx, op, *args, **kwargs):
    if op in _DOTS_SAVEABLE:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat_layer(cfg: TransformerConfig):
    """The per-layer wrapper ``cfg.remat`` asks for: None (save
    everything), full recompute, or "dots" (keep the projection outputs,
    recompute only the rest)."""
    if not cfg.remat or cfg.remat == "none":
        return None
    if cfg.remat == "dots":
        return functools.partial(
            checkpoint, use_reentrant=False,
            context_fn=functools.partial(
                create_selective_checkpoint_contexts, _dots_policy
            ),
        )
    return functools.partial(checkpoint, use_reentrant=False)


def embed(params: Params, tokens: torch.Tensor, cfg: TransformerConfig,
          mesh=None) -> torch.Tensor:
    """tokens [batch, seq] -> embeddings in the compute dtype. Under
    tensor parallelism each rank looks up the tokens of its vocab rows
    (zeros elsewhere; an int8 table dequantizes only the rows it
    gathers) and the parts are summed over ``model``."""
    if mesh is None or (mesh.fsdp is None and not _tp(mesh)):
        return embed_lookup(params, tokens, cfg.dtype)
    if mesh.fsdp is not None:
        table = _fsdp_gather(params["embed"], mesh.fsdp["embed"], mesh)
        if not _tp(mesh):
            return table[tokens].to(cfg.dtype)
        params = {"embed": table}
    from ..parallel.collectives import reduce_from

    rows = (params["embed"] if "embed" in params
            else params["embed_q"]).shape[0]
    local = tokens - mesh.axis_index("model") * rows
    inside = (local >= 0) & (local < rows)
    x = embed_lookup(params, local.clamp(0, rows - 1), cfg.dtype)
    return reduce_from(x * inside[..., None].to(x.dtype), mesh)


def forward_hidden(params: Params, tokens: torch.Tensor, cfg: TransformerConfig,
                   mesh=None):
    """tokens [batch, seq] -> (final normed hidden [batch, seq, d_model],
    aux_loss): everything up to the unembed, so a loss may stream the
    vocab projection in chunks. While autograd records, each layer runs
    under ``cfg.remat``'s checkpoint."""
    x = embed(params, tokens, cfg, mesh)
    x, aux = run_layers(params, x, cfg, mesh)
    norm_out = params["norm_out"]
    if mesh is not None and mesh.fsdp is not None:
        norm_out = _fsdp_gather(norm_out, mesh.fsdp["norm_out"], mesh)
    return _rms_norm(x, norm_out), aux


def run_layers(params: Params, x: torch.Tensor, cfg: TransformerConfig,
               mesh=None, n_layers=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The first ``n_layers`` (default ``cfg.n_layers``) stacked layers
    of ``params`` over x -> (x, summed aux_loss); a pipeline stage passes
    its own slice and count."""
    aux = torch.zeros((), device=x.device)
    remat = _remat_layer(cfg) if torch.is_grad_enabled() else None
    for i in range(cfg.n_layers if n_layers is None else n_layers):
        lp = layer_params(params, i)
        if remat is None:
            x, layer_aux = _layer(x, lp, cfg, mesh)
        else:
            x, layer_aux = remat(_layer, x, lp, cfg, mesh)
        aux = aux + layer_aux
    return x, aux


def _logits(x: torch.Tensor, params: Params, cfg: TransformerConfig,
            mesh=None) -> torch.Tensor:
    """Final hidden -> float32 logits; the rank's vocab shard under
    tensor parallelism."""
    if _tp(mesh):
        from ..parallel.collectives import copy_to

        x = copy_to(x, mesh)
    return _dot_f32(x, _use_top(params, "unembed", cfg, mesh))


def forward_with_aux(
    params: Params, tokens: torch.Tensor, cfg: TransformerConfig, mesh=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens [batch, seq] -> (logits [batch, seq, vocab] float32,
    aux_loss: MoE load balance, zero for dense models). Under tensor
    parallelism the vocab shards are gathered into the full logits."""
    x, aux = forward_hidden(params, tokens, cfg, mesh)
    logits = _logits(x, params, cfg, mesh)
    if _tp(mesh):
        logits = mesh.all_gather(logits.detach(), "model", -1)
    return logits, aux


def forward(params: Params, tokens: torch.Tensor, cfg: TransformerConfig) -> torch.Tensor:
    """tokens [batch, seq] -> logits [batch, seq, vocab] float32."""
    return forward_with_aux(params, tokens, cfg)[0]


def _ce_nll(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Per-position negative log-likelihood, log-softmax in float32: the
    one cross-entropy core of the whole-logits and chunked losses."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -torch.gather(logp, -1, targets.long()[..., None])[..., 0]


def _ce_nll_vocab_parallel(logits: torch.Tensor, targets: torch.Tensor,
                           mesh) -> torch.Tensor:
    """``_ce_nll`` over vocab shards [..., V/tp]: the log-sum-exp from a
    max and a sum all-reduced over ``model``, the target logit from the
    shard that owns it."""
    from ..parallel.collectives import max_over, reduce_from

    rows = logits.shape[-1]
    lf = logits.float()
    shift = max_over(lf.amax(dim=-1), mesh)
    sumexp = reduce_from(torch.exp(lf - shift[..., None]).sum(dim=-1), mesh)
    local = targets.long() - mesh.axis_index("model") * rows
    inside = (local >= 0) & (local < rows)
    picked = lf.gather(-1, local.clamp(0, rows - 1)[..., None])[..., 0]
    target = reduce_from(picked * inside.to(lf.dtype), mesh)
    return shift + torch.log(sumexp) - target


def _nll(logits: torch.Tensor, targets: torch.Tensor, mesh=None):
    if _tp(mesh):
        return _ce_nll_vocab_parallel(logits, targets, mesh)
    return _ce_nll(logits, targets)


def next_token_loss(
    logits: torch.Tensor, aux: torch.Tensor, tokens: torch.Tensor,
    cfg: TransformerConfig, mesh=None,
) -> torch.Tensor:
    """Next-token CE over logits for tokens[:, :-1], plus weighted MoE
    aux. Under tensor parallelism ``logits`` is the rank's vocab shard."""
    return _nll(logits, tokens[:, 1:], mesh).mean() + cfg.moe_aux_weight * aux


def _loss_piece(xc, tc, mc, unembed, mesh=None):
    return (_nll(_dot_f32(xc, unembed), tc, mesh) * mc).sum()


def _chunked_next_token_loss(
    params: Params, tokens: torch.Tensor, cfg: TransformerConfig, mesh=None,
) -> torch.Tensor:
    """CE without materializing the full [b, s, vocab] logits: the
    unembed + log-softmax + gather run over sequence chunks, each under
    a checkpoint, so the backward recomputes one chunk's logits at a
    time. The padded tail of the last chunk is masked out."""
    x, aux = forward_hidden(params, tokens[:, :-1], cfg, mesh)
    if _tp(mesh):
        from ..parallel.collectives import copy_to

        x = copy_to(x, mesh)
    targets = tokens[:, 1:]
    b, s, _d = x.shape
    chunk = min(cfg.loss_chunk, s)
    n = -(-s // chunk)
    pad = n * chunk - s
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, pad))
        targets = torch.nn.functional.pad(targets, (0, pad))
    mask = (torch.arange(n * chunk, device=x.device) < s).to(torch.float32)
    unembed = _use_top(params, "unembed", cfg, mesh)
    total = torch.zeros((), device=x.device)
    for i in range(n):
        sl = slice(i * chunk, (i + 1) * chunk)
        piece = (
            checkpoint(_loss_piece, x[:, sl], targets[:, sl], mask[sl],
                       unembed, mesh, use_reentrant=False)
            if torch.is_grad_enabled()
            else _loss_piece(x[:, sl], targets[:, sl], mask[sl], unembed,
                             mesh)
        )
        total = total + piece
    return total / (b * s) + cfg.moe_aux_weight * aux


def loss_fn(
    params: Params, tokens: torch.Tensor, cfg: TransformerConfig, mesh=None,
) -> torch.Tensor:
    """Next-token cross-entropy of tokens [batch, seq + 1] (+ weighted
    MoE aux loss). ``cfg.loss_chunk > 0`` streams the vocab projection in
    sequence chunks instead of materializing full logits. With a
    ``mesh``, ``params`` are this rank's blocks and ``tokens`` its rows;
    the value is this rank's local mean (the same on every rank of a
    ``model`` group)."""
    if cfg.loss_chunk > 0:
        return _chunked_next_token_loss(params, tokens, cfg, mesh)
    x, aux = forward_hidden(params, tokens[:, :-1], cfg, mesh)
    return next_token_loss(_logits(x, params, cfg, mesh), aux, tokens, cfg,
                           mesh)
