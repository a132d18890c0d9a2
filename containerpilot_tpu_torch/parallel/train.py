"""The single-device training step (counterpart of
``containerpilot_tpu/parallel/train.py``'s one-device path).

Forward, backward and the optimizer update of one step, eagerly: autograd
differentiates ``models.transformer.loss_fn`` with respect to the float32
masters, and the optimizer updates them in place. The optimizer is the
reference's ``optax.chain(clip_by_global_norm, adamw)`` written out with
``torch._foreach_*`` ops:

- global-norm clip, ``g * min(1, max_norm / norm)`` (optax's formula;
  ``torch.nn.utils.clip_grad_norm_`` adds 1e-6 to the norm and differs);
- Adam moments ``mu = b1 mu + (1 - b1) g``, ``nu = b2 nu + (1 - b2) g^2``
  with bias correction by ``1 - b^count``, ``mu_hat / (sqrt(nu_hat) +
  eps)``;
- decoupled weight decay 0.1 on every leaf (optax's default mask);
- ``-lr(count)`` with the schedule's step count starting at 0, so the
  first update uses lr(0) (0 under warmup).

Unlike optax, the state is mutable: ``update`` rewrites the params, the
moments and the EMA shadow in place, which keeps one copy of each in
device memory. ``make_lora_train_step`` trains LoRA adapters over a
frozen base with the same optimizer. zero1, fsdp and pipeline steps are
not ported yet.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import torch

from ..models.transformer import TransformerConfig, init_params, loss_fn

Params = Dict[str, Any]


@dataclass
class TrainState:
    params: Params
    opt_state: Dict[str, Any]
    step: int


def tree_leaves(tree: Any) -> List[torch.Tensor]:
    """Tensor leaves of a nested dict in sorted-key order (jax's pytree
    order for dicts)."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in tree_leaves(tree[k])]
    return [tree]


def tree_map(fn: Callable, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def lr_schedule(
    learning_rate: float,
    warmup_steps: int = 0,
    decay_steps: int = 0,
    min_lr_ratio: float = 0.1,
) -> Union[float, Callable[[int], float]]:
    """The lr trajectory make_optimizer uses: a float when constant, else
    a function of the update count, mirroring
    ``optax.warmup_cosine_decay_schedule`` (decay) and
    ``optax.join_schedules`` of a linear warmup and a constant."""
    if decay_steps > 0:
        init = 0.0 if warmup_steps > 0 else learning_rate
        end = learning_rate * min_lr_ratio
        alpha = 0.0 if learning_rate == 0.0 else end / learning_rate

        def warmup_cosine(count: int) -> float:
            if count < warmup_steps:
                frac = 1.0 - min(max(count, 0), warmup_steps) / warmup_steps
                return (init - learning_rate) * frac + learning_rate
            t = min(float(count - warmup_steps), float(decay_steps))
            cosine = 0.5 * (1.0 + math.cos(math.pi * t / decay_steps))
            return learning_rate * ((1.0 - alpha) * cosine + alpha)

        return warmup_cosine
    if warmup_steps > 0:
        def warmup(count: int) -> float:
            if count < warmup_steps:
                frac = 1.0 - min(max(count, 0), warmup_steps) / warmup_steps
                return -learning_rate * frac + learning_rate
            return learning_rate

        return warmup
    return learning_rate


class AdamW:
    """Global-norm-clipped AdamW over a params tree, updating in place.

    ``init(params)`` -> ``{"count": 0, "mu": tree, "nu": tree}``;
    ``update(grads, state, params)`` clips ``grads`` (in place), advances
    the moments and applies the update to ``params``; returns the state.
    """

    def __init__(self, schedule, b1=0.9, b2=0.95, eps=1e-8,
                 weight_decay=0.1, clip_norm=1.0) -> None:
        self.schedule = schedule
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.clip_norm = clip_norm

    def lr(self, count: int) -> float:
        return float(self.schedule(count) if callable(self.schedule)
                     else self.schedule)

    def init(self, params: Params) -> Dict[str, Any]:
        return {"count": 0, "mu": tree_map(torch.zeros_like, params),
                "nu": tree_map(torch.zeros_like, params)}

    @torch.no_grad()
    def update(self, grads: List[torch.Tensor], state: Dict[str, Any],
               params: Params) -> Dict[str, Any]:
        ps = tree_leaves(params)
        mu, nu = tree_leaves(state["mu"]), tree_leaves(state["nu"])
        gs = list(grads)
        # clip_by_global_norm: g * min(1, max_norm / ||g||)
        norm = torch.linalg.vector_norm(
            torch.stack(torch._foreach_norm(gs))
        )
        torch._foreach_mul_(gs, torch.clamp(self.clip_norm / norm, max=1.0))
        # scale_by_adam
        count = state["count"] + 1
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, gs, alpha=1.0 - self.b1)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_addcmul_(nu, gs, gs, value=1.0 - self.b2)
        mu_hat = torch._foreach_div(mu, 1.0 - self.b1 ** count)
        denom = torch._foreach_div(nu, 1.0 - self.b2 ** count)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        updates = torch._foreach_div(mu_hat, denom)
        del mu_hat, denom
        # add_decayed_weights, then -lr(count before this update)
        torch._foreach_add_(updates, ps, alpha=self.weight_decay)
        torch._foreach_mul_(updates, -self.lr(state["count"]))
        torch._foreach_add_(ps, updates)
        state["count"] = count
        return state


def make_optimizer(
    learning_rate: float = 3e-4,
    *,
    warmup_steps: int = 0,
    decay_steps: int = 0,
    min_lr_ratio: float = 0.1,
    clip_norm: float = 1.0,
) -> AdamW:
    """Global-norm-clipped AdamW (b1 0.9, b2 0.95, eps 1e-8, weight decay
    0.1 on every leaf), optionally under a linear-warmup + cosine-decay
    schedule: the reference's make_optimizer."""
    return AdamW(
        lr_schedule(learning_rate, warmup_steps, decay_steps, min_lr_ratio),
        b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1, clip_norm=clip_norm,
    )


class _WithEma:
    """An optimizer whose state also carries an EMA of the updated params
    (``ema = decay * ema + (1 - decay) * params_next``)."""

    def __init__(self, inner, decay: float) -> None:
        self.inner = inner
        self.decay = decay

    def init(self, params: Params) -> Dict[str, Any]:
        return {"inner": self.inner.init(params),
                "ema": tree_map(lambda p: p.detach().clone(), params)}

    @torch.no_grad()
    def update(self, grads, state, params):
        state["inner"] = self.inner.update(grads, state["inner"], params)
        ema = tree_leaves(state["ema"])
        torch._foreach_mul_(ema, self.decay)
        torch._foreach_add_(ema, tree_leaves(params), alpha=1.0 - self.decay)
        return state


def with_ema(inner, decay: float) -> _WithEma:
    """Wrap an optimizer so its state also carries an EMA shadow of the
    params; extract it with ``ema_params(state)``."""
    if not 0.0 < decay < 1.0:
        raise ValueError(f"ema decay must be in (0, 1), got {decay}")
    return _WithEma(inner, decay)


def ema_params(state: TrainState) -> Optional[Params]:
    """The EMA shadow params of a with_ema state (None without EMA)."""
    return state.opt_state.get("ema")


def _master(params: Params) -> Params:
    return tree_map(lambda p: p.detach().requires_grad_(True), params)


def init_train_state(
    rng: Union[int, torch.Generator, Params],
    cfg: TransformerConfig,
    device="cuda",
    learning_rate: float = 3e-4,
    optimizer=None,
) -> TrainState:
    """Float32 masters (from a seed/generator, or a given params dict,
    e.g. bridged from JAX) that require grad, the optimizer's state, step
    0."""
    params = rng if isinstance(rng, dict) else init_params(rng, cfg, device)
    params = _master(params)
    optimizer = optimizer or make_optimizer(learning_rate)
    return TrainState(params=params, opt_state=optimizer.init(params), step=0)


def abstract_train_state(cfg: TransformerConfig, optimizer=None,
                         learning_rate: float = 3e-4) -> TrainState:
    """init_train_state's structure on the meta device (shapes and
    dtypes, no memory): the restore target for resuming from a
    checkpoint without a throwaway init."""
    params = init_params(0, cfg, device="meta")
    optimizer = optimizer or make_optimizer(learning_rate)
    return TrainState(params=params, opt_state=optimizer.init(params), step=0)


def make_train_step(
    cfg: TransformerConfig,
    optimizer=None,
    accum_steps: int = 1,
    learning_rate: float = 3e-4,
) -> Callable[[TrainState, torch.Tensor], Tuple[TrainState, torch.Tensor]]:
    """``step(state, tokens [batch, seq + 1]) -> (state, loss)``.

    ``accum_steps > 1`` splits the batch into that many sequential
    chunks, averages the chunks' losses and gradients (equal chunks: the
    mean of chunk means is the full-batch mean) and makes one update;
    activation memory drops to one chunk's worth. The state is updated in
    place and returned with ``step + 1``; the loss is a detached 0-d
    tensor on the params' device (no host sync)."""
    if accum_steps < 1:
        raise ValueError("accum_steps must be >= 1")
    optimizer = optimizer or make_optimizer(learning_rate)

    def grads_of(params, tokens):
        leaves = tree_leaves(params)
        if accum_steps == 1:
            loss = loss_fn(params, tokens, cfg)
            return loss.detach(), list(torch.autograd.grad(loss, leaves))
        loss_sum, grad_sum = None, None
        for chunk in tokens.chunk(accum_steps, dim=0):
            loss = loss_fn(params, chunk, cfg)
            grads = torch.autograd.grad(loss, leaves)
            if grad_sum is None:
                loss_sum, grad_sum = loss.detach(), list(grads)
            else:
                loss_sum = loss_sum + loss.detach()
                torch._foreach_add_(grad_sum, grads)
        torch._foreach_div_(grad_sum, float(accum_steps))
        return loss_sum / accum_steps, grad_sum

    def step(state: TrainState, tokens: torch.Tensor):
        if tokens.shape[0] % accum_steps:
            raise ValueError(
                f"batch {tokens.shape[0]} not divisible by "
                f"accum_steps {accum_steps}"
            )
        loss, grads = grads_of(state.params, tokens)
        opt_state = optimizer.update(grads, state.opt_state, state.params)
        return TrainState(state.params, opt_state, state.step + 1), loss

    return step


def lora_abstract_state(cfg: TransformerConfig, rank: int, optimizer=None,
                        learning_rate: float = 1e-4) -> TrainState:
    """A LoRA TrainState's structure on the meta device (the adapter
    pairs and the optimizer's state over them): the restore target of
    the trainer's resume and of serving's params-only adapter restore."""
    from ..models.lora import init_lora_params

    lora = init_lora_params(0, cfg, rank, device="meta")
    optimizer = optimizer or make_optimizer(learning_rate)
    return TrainState(params=lora, opt_state=optimizer.init(lora), step=0)


def make_lora_train_step(
    cfg: TransformerConfig,
    rank: int,
    learning_rate: float = 1e-4,
    optimizer=None,
    alpha: float = 2.0,
):
    """LoRA fine-tuning -> ``(init_fn, step_fn, abstract)``.

    ``init_fn(rng, device)`` makes the TrainState, whose params are the
    adapter pairs (float32, requiring grad). ``step_fn(state, base,
    tokens) -> (state, loss)`` differentiates ``loss_fn(apply_lora(base,
    lora), tokens)`` with respect to the adapters only and updates them
    and the optimizer's state (and EMA, where asked) in place; the base
    rides along detached, so it never requires grad and gets no gradient
    buffers. ``abstract`` is the checkpoint-restore target
    (``lora_abstract_state``)."""
    from ..models.lora import apply_lora, init_lora_params

    optimizer = optimizer or make_optimizer(learning_rate)
    abstract = lora_abstract_state(cfg, rank, optimizer, learning_rate)

    def init_fn(rng, device="cuda") -> TrainState:
        lora = _master(init_lora_params(rng, cfg, rank, device=device))
        return TrainState(params=lora, opt_state=optimizer.init(lora),
                          step=0)

    def step_fn(state: TrainState, base: Params, tokens: torch.Tensor):
        frozen = tree_map(torch.Tensor.detach, base)
        leaves = tree_leaves(state.params)
        loss = loss_fn(apply_lora(frozen, state.params, cfg, alpha),
                       tokens, cfg)
        grads = list(torch.autograd.grad(loss, leaves))
        opt_state = optimizer.update(grads, state.opt_state, state.params)
        state = TrainState(state.params, opt_state, state.step + 1)
        return state, loss.detach()

    return init_fn, step_fn, abstract
