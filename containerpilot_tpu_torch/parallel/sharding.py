"""Sharding rules for the flagship transformer (counterpart of
``containerpilot_tpu/parallel/sharding.py``).

A rule is a per-leaf tuple of mesh axis names (or None), in the same
positions as the reference's ``PartitionSpec``: ``("model", None)`` for
the embed shards its vocab rows over ``model``. Megatron-style tensor
parallelism:

- attention: heads over ``model``; q/k/v projections column-wise by
  head, the output projection row-wise (one all-reduce per block);
- SwiGLU: gate/up column-wise on the hidden axis, down row-wise (one
  all-reduce per block);
- embed/unembed: vocab over ``model``;
- under MoE: the router replicated, the experts over ``model``.

The reference places each leaf with ``jax.device_put`` and lets XLA
insert the collectives; here ``shard_params`` cuts each rank's own
slice out of the full tensor, the layers call the collectives
themselves (``models/transformer.py``), and ``gather_params`` rebuilds
the full tree (for tests and evaluation).

A whole training state gathers and shards too (``gather_state``,
``shard_state``): the params under their rules, Adam's moments under the
layout's moment rules (ZeRO-1's slice over ``data`` added), the EMA
shadow under the params' rules, scalars whole. So a checkpoint holds
one full state whatever layout wrote it, and restores into any layout
(parallel/checkpoint.py).

A serving tree quantized by ``models.quantized.quantize_model_params``
(the reference quantizes after ``shard_params``; here the full masters
are quantized first, then cut) takes its float leaf's rule for both
``W_q`` and ``W_s`` (``quantized_rules``), except on a scale's reduced
axes, which have size 1 and stay whole: a column-parallel weight keeps
its own columns' scales, a row-parallel one (``wo``, ``w_down``) the
full per-column scales.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

Rule = Tuple[Optional[str], ...]


def param_sharding_rules(cfg: Any = None, mesh: Any = None) -> Dict[str, Any]:
    """Rule tree matching models.transformer.init_params. Under GQA, when
    ``mesh`` is given and kv_heads does not divide by its model axis,
    wk/wv replicate."""
    kv_spec: Rule = (None, None, "model", None)
    if cfg is not None and mesh is not None:
        kv_heads = getattr(cfg, "kv_heads", None)
        if kv_heads is not None and kv_heads % mesh.shape.get("model", 1):
            kv_spec = (None, None, None, None)
    layers: Dict[str, Rule] = {
        "wq": (None, None, "model", None),   # [L, d, heads, head_dim]
        "wk": kv_spec,
        "wv": kv_spec,
        "wo": (None, "model", None, None),   # [L, heads, head_dim, d]
        "norm_attn": (None, None),
        "norm_mlp": (None, None),
    }
    if cfg is not None and getattr(cfg, "moe_experts", 0) > 0:
        layers.update({
            "router": (None, None, None),
            "moe_w_in": (None, "model", None, None),   # [L, E, d, ff]
            "moe_w_out": (None, "model", None, None),  # [L, E, ff, d]
        })
    else:
        layers.update({
            "w_gate": (None, None, "model"),  # [L, d, ff]: column-parallel
            "w_up": (None, None, "model"),
            "w_down": (None, "model", None),  # [L, ff, d]: row-parallel
        })
    return {
        "embed": ("model", None),
        "layers": layers,
        "norm_out": (None,),
        "unembed": (None, "model"),
    }


def param_shapes(cfg: Any) -> Dict[str, Any]:
    """init_params' leaf shapes (a tree of torch.Size), no memory."""
    from ..models.transformer import init_params

    return _map(lambda t: t.shape, init_params(0, cfg, device="meta"))


def fsdp_sharding_rules(cfg: Any, mesh: Any, rules: Any = None
                        ) -> Dict[str, Any]:
    """FSDP (ZeRO-3): the tensor-parallel rules with every large leaf
    *additionally* sharded over ``data``, on the largest dimension that
    is not already sharded and divides by the data axis. The
    stacked-layer axis (dim 0 of ``layers`` leaves) never takes it."""
    if rules is None:
        rules = param_sharding_rules(cfg, mesh)
    data_size = mesh.shape.get("data", 1)
    if data_size <= 1:
        return rules

    def add_data(rule: Rule, shape, in_layers: bool) -> Rule:
        entries = list(rule) + [None] * (len(shape) - len(rule))
        if "data" in entries:
            return rule
        best = None
        for i in range(1 if in_layers else 0, len(shape)):
            if entries[i] is None and shape[i] % data_size == 0:
                if best is None or shape[i] > shape[best]:
                    best = i
        if best is None:
            return rule
        entries[best] = "data"
        return tuple(entries)

    shapes = param_shapes(cfg)
    return {
        k: ({n: add_data(r, shapes[k][n], True) for n, r in v.items()}
            if isinstance(v, dict) else add_data(v, shapes[k], False))
        for k, v in rules.items()
    }


def with_data_axis(rule: Rule, shape, data_size: int) -> Rule:
    """ZeRO-1's moment rule (reference ``train_state_shardings``): put
    ``data`` on the first unsharded dim that divides; keep the param rule
    when the data axis is already used or nothing divides."""
    entries = list(rule) + [None] * (len(shape) - len(rule))
    if "data" in entries:
        return rule
    for i, (entry, dim) in enumerate(zip(entries, shape)):
        if entry is None and dim % data_size == 0 and dim > 0:
            entries[i] = "data"
            return tuple(entries)
    return rule


def batch_spec() -> Rule:
    """Activations/tokens: batch over the data axis."""
    return ("data", None)


def quantized_rules(rules: Any, params: Any) -> Any:
    """The rule tree of ``params``: ``rules`` itself for a float tree;
    for a quantized one, each ``W_q``/``W_s`` leaf takes ``W``'s rule, a
    scale's size-1 (reduced) dims replicated."""
    def level(rule_level, param_level):
        out = {}
        for name, leaf in param_level.items():
            if isinstance(leaf, dict):
                out[name] = level(rule_level[name], leaf)
                continue
            base = name[:-2]
            if name in rule_level or base not in rule_level:
                out[name] = rule_level[name]
            elif name.endswith("_s"):
                out[name] = tuple(None if leaf.shape[i] == 1 else axis
                                  for i, axis in enumerate(rule_level[base]))
            else:
                out[name] = rule_level[base]
        return out

    return level(rules, params)


def _map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: _map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    return fn(tree, *rest)


def local_slice(t: torch.Tensor, rule: Rule, mesh: Any,
                coords: Optional[Dict[str, int]] = None) -> torch.Tensor:
    """This rank's block of the full tensor ``t`` under ``rule`` (the
    block of the rank at ``coords``, when given)."""
    coords = mesh.coords if coords is None else coords
    for dim, axis in enumerate(rule):
        if axis is None:
            continue
        n = mesh.shape.get(axis, 1)
        if t.shape[dim] % n:
            raise ValueError(
                f"dim {dim} of {tuple(t.shape)} does not divide by the "
                f"{axis!r} axis of {n}")
        t = t.chunk(n, dim=dim)[coords.get(axis, 0)]
    return t


def shard_params(params: Any, mesh: Any, cfg: Optional[Any] = None,
                 rules: Any = None) -> Any:
    """Each leaf's local block for this rank (a contiguous copy, so the
    full tensor can be freed)."""
    if rules is None:
        rules = param_sharding_rules(cfg, mesh)
    rules = quantized_rules(rules, params)
    return _map(lambda t, r: local_slice(t, r, mesh).contiguous()
                if sharded_by(r, mesh) else t,
                params, rules)


def gather_leaf(t: torch.Tensor, rule: Rule, mesh: Any) -> torch.Tensor:
    """The full tensor from each rank's block: an all-gather over every
    axis of the rule, innermost dim first."""
    for dim in reversed(range(len(rule))):
        axis = rule[dim]
        if axis is not None:
            t = mesh.all_gather(t, axis, dim)
    return t


def gather_params(params: Any, mesh: Any, cfg: Optional[Any] = None,
                  rules: Any = None) -> Any:
    """The full tree on every rank (collective: every rank calls it)."""
    if rules is None:
        rules = param_sharding_rules(cfg, mesh)
    rules = quantized_rules(rules, params)
    return _map(lambda t, r: gather_leaf(t.detach(), r, mesh), params, rules)


def leaf_rules(params: Any, mesh: Any, cfg: Optional[Any] = None
               ) -> Dict[str, Any]:
    """The rule tree of a serving tree (float or quantized) under the
    tensor-parallel rules; ``params`` may be whole or a rank's blocks,
    except that a quantized tree's scale rules read its shapes."""
    return quantized_rules(param_sharding_rules(cfg, mesh), params)


def sharded_by(rule: Rule, mesh: Any) -> bool:
    """Whether ``rule`` cuts a leaf on ``mesh`` (an axis of size > 1)."""
    return any(a is not None and mesh.shape.get(a, 1) > 1 for a in rule)


# -- a KV cache entry of a rank's kv heads --------------------------------
# A cache entry's k/v are [layers, batch, length, kv_heads, head_dim] (the
# int8 scales drop head_dim): a rank holds ``decode.cache_kv_heads`` of
# them. When tp divides the kv heads they are split over ``model`` in
# head order; otherwise each rank holds the kv of its query heads,
# repeated from the replicated weights, and the whole entry sends each kv
# head once. The seq axis holds replicas: nothing gathers over it.

KV_HEAD_DIM = 3


def _kv_group(cfg: Any, mesh: Any) -> int:
    """Query heads a kv head serves when a rank's cache repeats them
    (replicated GQA weights), 1 when the kv heads split over ``model``."""
    tp = mesh.axis_size("model")
    return 1 if cfg.kv_heads % tp == 0 else cfg.n_heads // cfg.kv_heads


def gather_kv_entry(entry: Dict[str, Any], cfg: Any, mesh: Any
                    ) -> Dict[str, Any]:
    """The whole entry (every kv head once) from each rank's: an
    all-gather of the head axis over ``model`` (collective: every rank
    of the mesh calls it). ``pos`` and anything without a head axis pass
    through."""
    group = _kv_group(cfg, mesh)
    out = {}
    for name, leaf in entry.items():
        if isinstance(leaf, torch.Tensor) and leaf.dim() > KV_HEAD_DIM:
            leaf = mesh.all_gather(leaf, "model", KV_HEAD_DIM)
            if group > 1:
                leaf = leaf[(slice(None),) * KV_HEAD_DIM
                            + (slice(None, None, group),)].contiguous()
        out[name] = leaf
    return out


def local_kv_entry(entry: Dict[str, Any], cfg: Any, mesh: Any
                   ) -> Dict[str, Any]:
    """This rank's part of a whole entry (``gather_kv_entry``'s
    inverse): its block of the kv heads, or the repeated kv of its query
    heads. A contiguous copy, so the whole entry can be freed."""
    group = _kv_group(cfg, mesh)
    out = {}
    for name, leaf in entry.items():
        if isinstance(leaf, torch.Tensor) and leaf.dim() > KV_HEAD_DIM:
            if group > 1:
                leaf = leaf.repeat_interleave(group, dim=KV_HEAD_DIM)
            leaf = leaf.chunk(mesh.axis_size("model"), dim=KV_HEAD_DIM)[
                mesh.axis_index("model")].contiguous()
        out[name] = leaf
    return out


def state_rules(params: Any, opt_state: Any, layout: Any):
    """(param rules, optimizer-state rules) of a sharded TrainState's
    leaves under ``layout`` (``parallel.train.Layout``; None: everything
    replicated, as LoRA adapters are): the moments take the layout's
    moment rules, computed from the rank's param blocks, the EMA shadow
    the params' rules, and anything else (the update count) ``()``."""
    if layout is None:
        prules = _map(lambda _t: (), params)
        mrules = prules
    else:
        prules = layout.rules
        mrules = layout.moment_rule_tree(params)

    def walk(node):
        out = {}
        for key, value in node.items():
            if key in ("mu", "nu"):
                out[key] = mrules
            elif key == "ema":
                out[key] = prules
            elif isinstance(value, dict):
                out[key] = walk(value)
            else:
                out[key] = ()
        return out

    return prules, walk(opt_state)


def gather_state(params: Any, opt_state: Any, mesh: Any, layout: Any,
                 keep: bool = True, host: bool = False):
    """The full (params, opt_state) trees from the rank's blocks, leaf by
    leaf (collective: every rank calls it). ``keep`` False drops each
    gathered leaf at once (ranks that do not write), so a rank holds at
    most one full leaf; ``host`` gathers through host buffers (a gloo
    world: no staging copy back to the card) and returns host tensors.
    Non-tensor leaves come back as they are."""
    prules, orules = state_rules(params, opt_state, layout)

    def leaf(t, rule):
        if not isinstance(t, torch.Tensor):
            return t
        src = t.detach()
        full = gather_leaf(src.to("cpu") if host else src, rule, mesh)
        if not keep:
            return None
        # an unsharded leaf comes back as the live tensor: copy it, so
        # the caller never holds a view the train loop updates in place
        return full.clone() if full is src else full

    return _map(leaf, params, prules), _map(leaf, opt_state, orules)


def shard_state(params: Any, opt_state: Any, mesh: Any, layout: Any,
                device: Any):
    """The rank's blocks of a full (params, opt_state) pair (a restored
    checkpoint) under ``layout`` on ``device``: each leaf cut with
    ``local_slice`` and copied (so the full tree can be freed), the
    moments' ZeRO-1 slices from the cut params' shapes."""
    if layout is None:
        prules = _map(lambda _t: (), params)
    else:
        prules = layout.rules

    def cut(t, rule):
        if not isinstance(t, torch.Tensor):
            return t
        return local_slice(t, rule, mesh).to(device, copy=True)

    local = _map(cut, params, prules)
    _prules, orules = state_rules(local, opt_state, layout)
    return local, _map(cut, opt_state, orules)
