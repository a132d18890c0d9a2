"""Carry a JAX params pytree and config into the port, leaf for leaf.

The bridge imports no jax: the caller turns each leaf into numpy first
(``jax.tree_util.tree_map(np.asarray, params)``) and hands over the
nested dict of numpy arrays. Leaf names and shapes are kept, dense and
quantized layouts alike (``*_q`` int8 leaves plus ``*_s`` float32
scales). bf16 arrives as ``ml_dtypes.bfloat16`` numpy, which torch
cannot read directly; it goes through its bit pattern
(``.view(np.uint16)`` -> ``torch.from_numpy`` -> ``.view(torch.bfloat16)``).
LoRA adapters bridge the same way (``lora_from_jax``), so an adapter
trained or merged in one package can be held against the other.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from . import resolve_device

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(dtype: Any) -> torch.dtype:
    """A dtype given by name ('bfloat16') or as a numpy-compatible type
    object (np.float32, jnp.bfloat16) -> the torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if isinstance(dtype, str) else np.dtype(dtype).name
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unsupported compute dtype {name!r}") from None


def _to_torch(arr: np.ndarray) -> torch.Tensor:
    arr = np.ascontiguousarray(arr)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(arr.copy())


def params_from_jax(
    numpy_tree: Dict[str, Any], device, dtype: Optional[Any] = None
) -> Dict[str, Any]:
    """The port's params dict from a JAX params pytree already turned
    into numpy. ``dtype`` (optional) casts the floating weights once to
    the compute dtype as ``quantized.cast_params`` does: the float32
    quantization scales (``*_s``), the MoE router and int8 leaves keep
    their type."""
    from .models.quantized import keeps_float32

    dev = resolve_device(device)
    cast = torch_dtype(dtype) if dtype is not None else None

    def convert(name: str, leaf: Any) -> Any:
        if isinstance(leaf, dict):
            return {k: convert(k, v) for k, v in leaf.items()}
        t = _to_torch(np.asarray(leaf))
        if cast is not None and t.is_floating_point() and not keeps_float32(name):
            t = t.to(cast)
        return t.to(dev)

    return {k: convert(k, v) for k, v in numpy_tree.items()}


def shard_from_jax(
    numpy_tree: Dict[str, Any], mesh, device, cfg: Any = None,
    rules: Any = None, dtype: Optional[Any] = None,
) -> Dict[str, Any]:
    """One rank's blocks of a JAX params pytree (numpy leaves) under a
    mesh: ``params_from_jax`` then ``parallel.sharding.shard_params``
    with ``rules`` (default the tensor-parallel rules of ``cfg``). A
    quantized serving tree (``*_q`` int8 leaves, ``*_s`` scales) is cut
    with its float leaves' rules (``sharding.quantized_rules``).
    ``mesh`` may be a layout-only mesh (``make_mesh(world_size=N,
    rank=r)``), so every rank's state can be built from the same seeded
    params without a process group."""
    from .parallel.sharding import shard_params

    return shard_params(params_from_jax(numpy_tree, device, dtype), mesh,
                        cfg, rules)


def lora_from_jax(numpy_tree: Dict[str, Any], device) -> Dict[str, Any]:
    """The port's LoRA adapter from a JAX adapter pytree already turned
    into numpy (``init_lora_params`` or a LoRA TrainState's params):
    ``{target}_a [L, d, r]`` and ``{target}_b [L, r, n]`` as float32
    tensors on ``device``, names and shapes kept."""
    dev = resolve_device(device)
    out = {}
    for name, leaf in numpy_tree.items():
        arr = np.asarray(leaf)
        if name.rpartition("_")[2] not in ("a", "b") or arr.ndim != 3:
            raise ValueError(
                f"not a LoRA adapter leaf: {name} {tuple(arr.shape)}"
            )
        out[name] = _to_torch(arr).float().to(dev)
    return out


def config_kwargs(cfg_dict: Dict[str, Any]) -> Dict[str, Any]:
    """TransformerConfig kwargs for the port from the one config dict
    both packages construct from: the same fields, with ``dtype`` (a
    name or a numpy-compatible type) turned into a torch dtype. The
    reference's ``attention_fn`` has no counterpart and is refused."""
    if "attention_fn" in cfg_dict:
        raise ValueError("attention_fn has no counterpart in the port")
    out = dict(cfg_dict)
    if "dtype" in out:
        out["dtype"] = torch_dtype(out["dtype"])
    return out
