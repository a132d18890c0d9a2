"""Context parallelism: bind ring attention into the model config, and
the context-parallel serving prefill (counterpart of
``containerpilot_tpu/parallel/context.py``).

Long sequences are sharded over the mesh's ``seq`` axis; attention runs
as a ring (ops/ring_attention.py) while every other op stays local to
the rank's shard, and RoPE runs at the shard's global positions
(``models.transformer.seq_offset``). Params shard over ``model`` and
replicate over ``seq``, so the same mesh serves the ring prefill and the
tensor-parallel decode.

Serving gets the long-context story through ``cp_generate``: the
PREFILL, the quadratic and activation-heavy part of a long-prompt
request, runs ring attention over the seq axis, then the KV cache
gathers off the ring once and the decode runs on the ordinary path with
the full sampling contract.

Training takes the same hook: the ring is differentiable
(ops/ring_attention.py), so ``make_train_step`` on a ``MeshPlan(data,
seq, model)`` mesh runs each rank's sequence shard forward and backward
with K/V and their gradients travelling around the ring
(parallel/train.py binds this config when the caller has not).

Every function here is collective: every rank of the mesh calls it
with the same arguments (the serving lockstep, parallel/serving.py,
makes sure of that). The reference's ``flash_parallel_config`` (the
flash kernel per shard under ``shard_map``) has no counterpart to port:
the port's tensor-parallel layers already run K1 on each rank's heads
(models/transformer.py).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..models import decode
from ..models.transformer import TransformerConfig
from ..ops.ring_attention import ring_attention_local


def context_parallel_config(cfg: TransformerConfig, mesh,
                            axis_name: str = "seq") -> TransformerConfig:
    """A config whose attention runs as a ring over ``axis_name``."""
    if axis_name not in mesh.axis_names:
        raise ValueError(
            f"mesh has no {axis_name!r} axis: {mesh.axis_names}"
        )
    if cfg.window > 0:
        raise ValueError(
            "sliding-window attention does not compose with ring "
            "attention yet: a window shorter than the shard makes "
            "most ring hops no-ops — use the flash window path on a "
            "(data, model) mesh instead"
        )

    def attn(q, k, v):
        return ring_attention_local(q, k, v, mesh, axis_name)

    # the ring handles grouped kv itself (rotates the SMALL K/V); the
    # layer passes unrepeated heads through, and RoPE offsets by the
    # shard's position on the axis
    attn.gqa_native = True
    attn.seq_mesh = mesh
    attn.seq_axis = axis_name
    return dataclasses.replace(cfg, attention_fn=attn)


def resolve_cp_min_len(cp_min_len: int, seq_axis: int, max_len: int,
                       flag: str = "cp") -> int:
    """The ONE copy of the cp threshold policy: derive an unset
    threshold to something that amortizes a ring (self-clamped so it
    always CAN engage), clamp an explicit value below the axis up to the
    floor (the prompt's head must cover the axis), and refuse
    configurations where cp could never engage. Raises ValueError."""
    if seq_axis >= max_len:
        raise ValueError(
            f"--{flag} never engages: the seq axis ({seq_axis}) is "
            f"not below max_len ({max_len})"
        )
    if cp_min_len == 0:
        return min(8 * seq_axis, max_len - 1)
    if cp_min_len < seq_axis:
        return seq_axis
    if cp_min_len >= max_len:
        raise ValueError(
            f"--{flag} never engages: cp_min_len {cp_min_len} >= "
            f"max_len {max_len} (lower the threshold or raise "
            "max_len)"
        )
    return cp_min_len


def cp_head_buckets(cp_min_len: int, max_len: int, axis: int):
    """The static set of ring-head lengths: the smallest axis-divisible
    length that can satisfy cp_min_len, then doubling below max_len (the
    reference's table for a multi-process server)."""
    if axis < 2:
        return []
    floor = max(cp_min_len - cp_min_len % axis, axis)
    out = []
    b = floor
    while b < max_len:
        out.append(b)
        b *= 2
    return out


def pick_cp_head(plen: int, buckets) -> int:
    """Largest bucketed ring head that fits the prompt (0 = none fits;
    take the plain path)."""
    head = 0
    for b in buckets:
        if b <= plen:
            head = b
    return head


@torch.inference_mode()
def _cp_prefill(params, head_tokens: np.ndarray, cfg: TransformerConfig,
                mesh, max_len: int, axis_name: str = "seq"):
    """Ring the head [1, head] through prefill: this rank prefills its
    contiguous shard of ``axis_name`` under the ring config, the shards'
    caches are gathered along positions once into a ``max_len`` cache,
    and the last position's logits (held by the last shard) are
    broadcast over the axis. Returns (logits [1, vocab], cache), the
    same on every rank."""
    axis = mesh.axis_size(axis_name)
    head = head_tokens.shape[1]
    local = head // axis
    start = mesh.axis_index(axis_name) * local
    device = params["norm_out"].device
    shard = torch.as_tensor(
        np.ascontiguousarray(head_tokens[:, start:start + local]),
        dtype=torch.int64, device=device)
    logits, part = decode.prefill(
        params, shard, context_parallel_config(cfg, mesh, axis_name),
        local, mesh)
    cache = decode.init_cache(cfg, 1, max_len, device=device, mesh=mesh)
    for name, leaf in part.items():
        if name != "pos":
            cache[name][:, :, :head] = mesh.all_gather(leaf, axis_name, 2)
    cache["pos"] = head
    logits = mesh.broadcast(logits, axis_name, axis - 1)
    return logits, cache


def cp_prefill_with_remainder(params, prompt_host, cfg: TransformerConfig,
                              mesh, max_len: int, axis_name: str = "seq",
                              head: int = 0, prefill_chunk: int = 0):
    """The ONE copy of the cp prefill recipe that ``cp_generate`` and the
    slot engine's admission run: a HEAD of the prompt rings through
    prefill sharded over ``axis_name``, and the remainder extends the
    gathered cache. Returns (last logits, cache), the same on every
    rank. ``head`` = 0 takes the largest axis-divisible head (maximal
    ring work). The remainder extends in power-of-two pieces down to a
    < axis tail, capped at ``max(axis, prefill_chunk)``, so no single
    local chunk-x-cache attention exceeds the ring's per-rank bound by
    much and the piece lengths stay a finite set."""
    plen = int(prompt_host.shape[1])
    axis = mesh.shape[axis_name]
    if head == 0:
        head = plen - plen % axis
    if head <= 0:
        raise ValueError(
            f"prompt len {plen} is shorter than the {axis_name} axis "
            f"({axis}): nothing to shard — use the plain path"
        )
    if head % axis or head > plen:
        raise ValueError(
            f"head {head} must be a multiple of the {axis_name} axis "
            f"({axis}) and <= prompt len {plen}"
        )
    prompt_host = np.asarray(prompt_host, np.int64)
    logits, cache = _cp_prefill(params, prompt_host[:, :head], cfg, mesh,
                                max_len, axis_name)
    if head < plen:
        device = cache["k"].device if "k" in cache else "cpu"
        cap = max(axis, prefill_chunk)
        pos = head
        while pos < plen:
            left = plen - pos
            step = left
            if left >= axis:
                step = 1
                while step * 2 <= min(left, cap):
                    step *= 2
            piece = torch.as_tensor(prompt_host[:, pos:pos + step],
                                    device=device)
            with torch.inference_mode():
                logits, cache = decode.extend(params, cache, piece, cfg,
                                              mesh)
            pos += step
    return logits, cache


def cp_generate(params, prompt, cfg: TransformerConfig, mesh,
                max_new_tokens: int, max_len: int, axis_name: str = "seq",
                **sampling):
    """Long-prompt generation with a context-parallel prefill: the
    prompt shards over ``axis_name`` (each rank rings seq/P tokens of
    the head), the cache gathers once, and the decode runs
    ``generate_from_cache`` on the mesh with the full sampling contract
    (temperature/top_k/top_p/eos/min_new/penalties/logit_bias). Any
    prompt length: the largest axis-divisible head rings, the rest (<
    axis tokens) extends the gathered cache. Greedy output matches the
    unsharded path away from argmax ties (online softmax is the same
    math up to reassociation)."""
    prompt_host = np.asarray(
        prompt.cpu() if isinstance(prompt, torch.Tensor) else prompt)
    plen = int(prompt_host.shape[1])
    if axis_name not in mesh.axis_names:
        raise ValueError(
            f"mesh has no {axis_name!r} axis: {mesh.axis_names} "
            "(build it with MeshPlan(seq=...))"
        )
    if plen + max_new_tokens > max_len:
        raise ValueError(
            f"prompt_len {plen} + max_new_tokens {max_new_tokens} "
            f"exceeds max_len {max_len}"
        )
    logits, cache = cp_prefill_with_remainder(params, prompt_host, cfg, mesh,
                                              max_len, axis_name)
    return decode.generate_from_cache(params, cache, logits, cfg,
                                      max_new_tokens, mesh=mesh, **sampling)
