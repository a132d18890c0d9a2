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
frozen base with the same optimizer.

Across ranks (``mesh=`` a ``parallel.mesh.Mesh`` of more than one rank)
the state holds each rank's blocks (``parallel/sharding.py``) and the
step writes out what the reference's XLA inserts:

- data parallelism: the gradients all-reduced (mean) over ``data`` in
  one flat buffer, the batch's rows split over ``data``;
- ZeRO-1 (``zero1``): Adam's moments live only on the rank's ``data``
  slice (the reference's ``with_data_axis`` rule); the update runs on
  that slice of the params and the new params are all-gathered over
  ``data``;
- FSDP (``fsdp``): params, gradients and moments are 1/dp a rank; each
  layer gathers its params at use and the gradients are
  reduce-scattered (``collectives.gather_from``);
- the global-norm clip over the whole model: each leaf's sum of squares
  divided by the number of ranks holding the same block, summed over
  the world;
- context parallelism (a ``seq`` axis): each rank takes its rows of
  ``data`` and its positions of ``seq`` (``local_rows``), attention is
  the differentiable ring (``parallel/context.py``, bound here when the
  config has no hook), and the gradients of params replicated over
  ``seq`` are averaged over ``data`` and ``seq``.

``make_pipeline_train_step`` runs the GPipe pipeline
(``parallel/pipeline.py``) with the same state and optimizer.
``make_lora_train_step(..., mesh=)`` trains replicated adapters over a
base held in the rank's blocks.
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


def tree_unflatten(like: Any, leaves) -> Any:
    """A nested dict shaped as ``like`` holding ``leaves`` (an iterable
    in ``tree_leaves`` order)."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        return next(it)

    return build(like)


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

    def init(self, params: Params, layout=None) -> Dict[str, Any]:
        """Zero moments shaped as the params (as their ZeRO-1 slices
        under a ``layout`` with zero1)."""
        zeros = layout.moment_zeros if layout is not None else (
            lambda tree: tree_map(torch.zeros_like, tree))
        return {"count": 0, "mu": zeros(params), "nu": zeros(params)}

    @torch.no_grad()
    def update(self, grads: List[torch.Tensor], state: Dict[str, Any],
               params: Params, layout=None) -> Dict[str, Any]:
        ps = tree_leaves(params)
        mu, nu = tree_leaves(state["mu"]), tree_leaves(state["nu"])
        gs = list(grads)
        # clip_by_global_norm: g * min(1, max_norm / ||g||)
        if layout is None:
            norm = torch.linalg.vector_norm(
                torch.stack(torch._foreach_norm(gs))
            )
        else:
            norm = layout.global_norm(gs)
        torch._foreach_mul_(gs, torch.clamp(self.clip_norm / norm, max=1.0))
        if layout is not None:  # ZeRO-1: this rank's data slices
            gs, ps = layout.moment_slices(gs), layout.moment_slices(ps)
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
        if layout is not None:
            layout.gather_updated(tree_leaves(params))
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

    def init(self, params: Params, layout=None) -> Dict[str, Any]:
        return {"inner": self.inner.init(params, layout),
                "ema": tree_map(lambda p: p.detach().clone(), params)}

    @torch.no_grad()
    def update(self, grads, state, params, layout=None):
        state["inner"] = self.inner.update(grads, state["inner"], params,
                                           layout)
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
    *,
    mesh=None,
    zero1: bool = False,
    rules: Any = None,
) -> TrainState:
    """Float32 masters (from a seed/generator, or a given params dict,
    e.g. bridged from JAX) that require grad, the optimizer's state, step
    0. With a ``mesh`` of several ranks the state is this rank's blocks
    under ``rules`` (default: the tensor-parallel rules; pass
    ``fsdp_sharding_rules`` or ``pipeline_sharding_rules`` for those
    layouts): a given params dict must already be them
    (``bridge.shard_from_jax`` or ``sharding.shard_params``), a seed's
    full init (the same on every rank) is cut here; ``zero1`` keeps
    Adam's moments on the rank's data slice."""
    params = rng if isinstance(rng, dict) else init_params(rng, cfg, device)
    optimizer = optimizer or make_optimizer(learning_rate)
    layout = None
    if _multi(mesh):
        from .sharding import param_sharding_rules, shard_params

        rules = rules or param_sharding_rules(cfg, mesh)
        if not isinstance(rng, dict):
            params = shard_params(params, mesh, rules=rules)
        layout = Layout(mesh, rules, zero1)
    params = _master(params)
    return TrainState(params=params, opt_state=optimizer.init(params, layout),
                      step=0)


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
    *,
    mesh=None,
    zero1: bool = False,
    fsdp: bool = False,
    rules: Any = None,
) -> Callable[[TrainState, torch.Tensor], Tuple[TrainState, torch.Tensor]]:
    """``step(state, tokens [batch, seq + 1]) -> (state, loss)``.

    With a ``mesh`` of more than one rank every rank calls the step with
    the same global batch; it takes its own rows, and the state is the
    rank's blocks from ``init_train_state(..., mesh=mesh, zero1=zero1,
    rules=...)``. ``zero1`` keeps Adam's moments on the rank's data
    slice; ``fsdp`` shards params, gradients and moments over ``data``
    (``fsdp_sharding_rules`` of ``rules``); a ``seq`` axis (``MeshPlan(
    data, seq, model)``) trains each rank's positions with the ring; the
    loss returned is the global batch's.

    ``accum_steps > 1`` splits the batch into that many sequential
    chunks, averages the chunks' losses and gradients (equal chunks: the
    mean of chunk means is the full-batch mean) and makes one update;
    activation memory drops to one chunk's worth. The state is updated in
    place and returned with ``step + 1``; the loss is a detached 0-d
    tensor on the params' device (no host sync)."""
    if accum_steps < 1:
        raise ValueError("accum_steps must be >= 1")
    optimizer = optimizer or make_optimizer(learning_rate)
    if _multi(mesh):
        return _sharded_step(cfg, optimizer, accum_steps, mesh, zero1, fsdp,
                             rules)

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
    *,
    mesh=None,
):
    """LoRA fine-tuning -> ``(init_fn, step_fn, abstract)``.

    ``init_fn(rng, device)`` makes the TrainState, whose params are the
    adapter pairs (float32, requiring grad). ``step_fn(state, base,
    tokens) -> (state, loss)`` differentiates ``loss_fn(apply_lora(base,
    lora), tokens)`` with respect to the adapters only and updates them
    and the optimizer's state (and EMA, where asked) in place; the base
    rides along detached, so it never requires grad and gets no gradient
    buffers. ``abstract`` is the checkpoint-restore target
    (``lora_abstract_state``).

    With a ``mesh`` of several ranks the base is the rank's blocks
    (``shard_params``, the tensor-parallel rules), the adapters are
    replicated (the same on every rank), every rank passes the global
    batch and trains on its rows, and the adapters' gradients are summed
    over ``model`` where the target's base is sharded there (each rank's
    merge uses its own columns of B, so each holds a partial sum), then
    averaged over ``data`` and ``seq``: every rank makes the same
    update."""
    from ..models.lora import apply_lora, init_lora_params

    optimizer = optimizer or make_optimizer(learning_rate)
    abstract = lora_abstract_state(cfg, rank, optimizer, learning_rate)
    multi = _multi(mesh)
    step_cfg = seq_train_config(cfg, mesh) if multi else cfg

    def init_fn(rng, device="cuda") -> TrainState:
        lora = _master(init_lora_params(rng, cfg, rank, device=device))
        return TrainState(params=lora, opt_state=optimizer.init(lora),
                          step=0)

    def step_fn(state: TrainState, base: Params, tokens: torch.Tensor):
        frozen = tree_map(torch.Tensor.detach, base)
        leaves = tree_leaves(state.params)
        if multi:
            tokens = local_rows(tokens, mesh)
        merged = apply_lora(frozen, state.params, cfg, alpha, mesh=mesh)
        loss = loss_fn(merged, tokens, step_cfg, mesh if multi else None)
        grads = list(torch.autograd.grad(loss, leaves))
        if multi:
            grads = _sync_lora_grads(grads, state.params, frozen, mesh)
            loss = batch_mean(loss.detach(), mesh)
        opt_state = optimizer.update(grads, state.opt_state, state.params)
        state = TrainState(state.params, opt_state, state.step + 1)
        return state, loss.detach()

    return init_fn, step_fn, abstract


def _sync_lora_grads(grads, lora: Params, base: Params, mesh):
    """Adapter gradients made whole and averaged: summed over ``model``
    for targets whose base leaf the rank holds a block of, then one flat
    mean over ``data`` and ``seq``."""
    from ..models.lora import holds_block

    # tree_leaves' order of a flat dict: each leaf's target
    targets = [name.rsplit("_", 1)[0] for name in sorted(lora)]
    out = list(grads)
    partial = [i for i, t in enumerate(targets)
               if holds_block(base["layers"][t], lora[f"{t}_b"])]
    _flat_reduce(out, partial, mesh, ("model",), "sum")
    _flat_reduce(out, range(len(out)), mesh, ("data", "seq"), "mean")
    return out


def _flat_reduce(tensors: List[torch.Tensor], which, mesh, axes,
                 op: str) -> None:
    """Reduce ``tensors[i]`` for i in ``which`` over ``axes`` in place of
    the list, as one flat buffer (one all-reduce an axis); nothing when
    no axis is live."""
    from .collectives import all_reduce_axes

    which = list(which)
    if not which or all(mesh.axis_size(a) == 1 for a in axes):
        return
    buf = torch.cat([tensors[i].reshape(-1) for i in which])
    buf = all_reduce_axes(buf, mesh, axes, op)
    for i, part in zip(which, buf.split([tensors[i].numel() for i in which])):
        tensors[i] = part.view_as(tensors[i])


# ---------------------------------------------------------------------------
# across ranks
# ---------------------------------------------------------------------------

def _multi(mesh) -> bool:
    return mesh is not None and mesh.size > 1


class Layout:
    """A sharded state's layout: each leaf's rule, and what the step and
    the optimizer do with it (the clip's global norm, ZeRO-1's moment
    slices and the gather of the updated params)."""

    def __init__(self, mesh, rules, zero1: bool = False) -> None:
        from .sharding import with_data_axis

        self.mesh = mesh
        self.rules = rules
        self.leaf_rules = tree_leaves(rules)
        self.zero1 = zero1 and mesh.axis_size("data") > 1
        self._with_data_axis = with_data_axis
        # ranks holding the same block of each leaf: the axes its rule
        # does not shard
        self.replicas = [
            mesh.size // math.prod(mesh.axis_size(a) for a in r if a)
            for r in self.leaf_rules]

    def moment_rule(self, rule, shape):
        """The rule of a leaf's moments (the param's, plus ``data`` under
        ZeRO-1); ``shape`` is the local block's."""
        if not self.zero1:
            return rule
        return self._with_data_axis(rule, shape,
                                    self.mesh.axis_size("data"))

    def _slice_dim(self, i: int, shape):
        """The dim ZeRO-1 cuts leaf i's moments along (None: whole)."""
        if not self.zero1:
            return None
        rule = self.leaf_rules[i]
        moment = self.moment_rule(rule, shape)
        if moment is rule or "data" in rule:
            return None
        return moment.index("data")

    def moment_slices(self, leaves: List[torch.Tensor]):
        """Views of this rank's ZeRO-1 slice of each leaf."""
        if not self.zero1:
            return leaves
        n, me = self.mesh.axis_size("data"), self.mesh.axis_index("data")
        out = []
        for i, t in enumerate(leaves):
            dim = self._slice_dim(i, t.shape)
            out.append(t if dim is None else t.chunk(n, dim=dim)[me])
        return out

    def moment_zeros(self, params: Params) -> Params:
        return tree_unflatten(params, [
            torch.zeros_like(t)
            for t in self.moment_slices(tree_leaves(params))])

    @torch.no_grad()
    def gather_updated(self, leaves: List[torch.Tensor]) -> None:
        """ZeRO-1: every rank updated its slice in place; gather the
        slices over ``data`` into the whole (model-local) params."""
        if not self.zero1:
            return
        n, me = self.mesh.axis_size("data"), self.mesh.axis_index("data")
        for i, p in enumerate(leaves):
            dim = self._slice_dim(i, p.shape)
            if dim is not None:
                mine = p.chunk(n, dim=dim)[me]
                p.copy_(self.mesh.all_gather(mine, "data", dim))

    def global_norm(self, grads: List[torch.Tensor]) -> torch.Tensor:
        """The whole model's gradient norm: every block counted once."""
        squares = torch.stack([
            g.float().square().sum() / r
            for g, r in zip(grads, self.replicas)])
        return torch.sqrt(self.mesh.all_reduce_world(squares.sum()))

    def sync_grads(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """Average the gradients over ``data`` and ``seq`` (one flat
        all-reduce an axis for the leaves without a data axis; FSDP's
        data-sharded leaves were reduce-scattered at use and only need
        the mean's division and the mean over ``seq``)."""
        dp = self.mesh.axis_size("data")
        out = list(grads)
        flat = [i for i, r in enumerate(self.leaf_rules) if "data" not in r]
        sharded = [i for i, r in enumerate(self.leaf_rules) if "data" in r]
        _flat_reduce(out, flat, self.mesh, ("data", "seq"), "mean")
        for i in sharded:
            out[i] = grads[i] / dp
        _flat_reduce(out, sharded, self.mesh, ("seq",), "mean")
        return out

    def moment_rule_tree(self, params: Params) -> Params:
        """The rule of each moment leaf (ZeRO-1's data slice added), from
        the rank's param blocks: what ``sharding.gather_state`` gathers
        and ``sharding.shard_state`` cuts."""
        return tree_unflatten(params, [
            self.moment_rule(r, t.shape)
            for r, t in zip(self.leaf_rules, tree_leaves(params))])


def train_state_shardings(cfg: TransformerConfig, mesh, zero1: bool = False,
                          rules: Any = None) -> TrainState:
    """A TrainState-shaped tree of rule tuples: the params' rules and the
    moments' (``data`` added under ZeRO-1, the reference's
    ``with_data_axis`` on the full shapes); scalars replicate (``()``)."""
    from .sharding import param_sharding_rules, param_shapes, with_data_axis

    rules = rules or param_sharding_rules(cfg, mesh)
    dp = mesh.shape.get("data", 1)
    shapes = param_shapes(cfg)

    def moments(rule, shape):
        return with_data_axis(rule, shape, dp) if zero1 and dp > 1 else rule

    def walk(r, shp):
        if isinstance(r, dict):
            return {k: walk(r[k], shp[k]) for k in r}
        return moments(r, shp)

    mu = walk(rules, shapes)
    return TrainState(params=rules,
                      opt_state={"count": (), "mu": mu, "nu": mu}, step=())


def local_rows(tokens: torch.Tensor, mesh, accum_steps: int = 1
               ) -> torch.Tensor:
    """This rank's rows of the global batch [b, s + 1]: each of the
    ``accum_steps`` consecutive chunks split over ``data`` (contiguous
    rows when 1), so chunk c of every rank together is chunk c of the
    batch, as the reference's accumulation scan shards it. Under a
    ``seq`` axis of P, the rank at seq position i takes the window
    ``[i * s/P, (i + 1) * s/P + 1)``: its inputs are positions i * s/P
    onwards and its targets the next tokens, cut from the whole window
    before the split, so no halo crosses a shard boundary."""
    dp = mesh.axis_size("data")
    b = tokens.shape[0]
    if b % (accum_steps * dp):
        raise ValueError(
            f"batch {b} not divisible by accum_steps {accum_steps} x data "
            f"axis {dp}")
    chunks = tokens.reshape(accum_steps, b // accum_steps, *tokens.shape[1:])
    mine = chunks.chunk(dp, dim=1)[mesh.axis_index("data")]
    mine = mine.reshape(-1, *tokens.shape[1:])
    sp = mesh.axis_size("seq")
    if sp > 1:
        s = tokens.shape[1] - 1
        if s % sp:
            raise ValueError(
                f"seq len {s} not divisible by the seq axis {sp}")
        first = mesh.axis_index("seq") * (s // sp)
        mine = mine[:, first:first + s // sp + 1]
    return mine


def seq_train_config(cfg: TransformerConfig, mesh) -> TransformerConfig:
    """``cfg`` with the ring bound over a live ``seq`` axis (as the
    caller's ``context_parallel_config`` would bind it); a config already
    bound is kept, any other attention hook refused (it would see only
    the rank's shard)."""
    if mesh.axis_size("seq") == 1:
        return cfg
    if cfg.moe_train_capacity > 0:
        raise ValueError(
            "moe_train_capacity bounds each expert per whole row; a seq "
            "axis splits rows (use drop-free routing under seq)")
    if getattr(cfg.attention_fn, "seq_mesh", None) is not None:
        return cfg
    if cfg.attention_fn is not None:
        raise ValueError(
            "a seq axis needs the ring as its attention hook "
            "(context_parallel_config); this config binds another")
    from .context import context_parallel_config

    return context_parallel_config(cfg, mesh)


def batch_mean(t: torch.Tensor, mesh) -> torch.Tensor:
    """A per-rank mean made the global batch's: averaged over ``data``
    and ``seq`` (every rank's rows and positions count the same)."""
    from .collectives import all_reduce_axes

    return all_reduce_axes(t, mesh, ("data", "seq"), "mean")


def sharded_value_and_grad(params: Params, tokens: torch.Tensor,
                           cfg: TransformerConfig, mesh, accum_steps: int = 1,
                           fsdp_rules: Any = None, layout: Layout = None):
    """The global batch's loss and this rank's gradients (averaged over
    ``data``) for a sharded state: ``tokens`` is the global batch, and
    the gradients are those ``make_train_step`` feeds the optimizer."""
    from .sharding import param_sharding_rules

    if layout is None:
        layout = Layout(mesh, fsdp_rules or param_sharding_rules(cfg, mesh))
    cfg = seq_train_config(cfg, mesh)
    view = mesh.with_options(fsdp=fsdp_rules)
    leaves = tree_leaves(params)
    rows = local_rows(tokens, mesh, accum_steps)
    loss_sum, grad_sum = None, None
    for chunk in rows.chunk(accum_steps, dim=0):
        loss = loss_fn(params, chunk, cfg, view)
        grads = list(torch.autograd.grad(loss, leaves))
        if grad_sum is None:
            loss_sum, grad_sum = loss.detach(), grads
        else:
            loss_sum = loss_sum + loss.detach()
            torch._foreach_add_(grad_sum, grads)
    if accum_steps > 1:
        torch._foreach_div_(grad_sum, float(accum_steps))
        loss_sum = loss_sum / accum_steps
    grads = layout.sync_grads(grad_sum)
    return batch_mean(loss_sum, mesh), grads


def _sharded_step(cfg, optimizer, accum_steps, mesh, zero1, fsdp, rules):
    from .sharding import fsdp_sharding_rules, param_sharding_rules

    rules = rules or param_sharding_rules(cfg, mesh)
    fsdp_rules = None
    if fsdp and mesh.axis_size("data") > 1:
        fsdp_rules = rules = fsdp_sharding_rules(cfg, mesh, rules)
    layout = Layout(mesh, rules, zero1)

    def step(state: TrainState, tokens: torch.Tensor):
        if tokens.shape[0] % accum_steps:
            raise ValueError(
                f"batch {tokens.shape[0]} not divisible by "
                f"accum_steps {accum_steps}"
            )
        loss, grads = sharded_value_and_grad(
            state.params, tokens, cfg, mesh, accum_steps, fsdp_rules, layout)
        opt_state = optimizer.update(grads, state.opt_state, state.params,
                                     layout=layout)
        return TrainState(state.params, opt_state, state.step + 1), loss

    step.layout = layout
    return step


def make_pipeline_train_step(
    cfg: TransformerConfig,
    mesh,
    learning_rate: float = 3e-4,
    n_microbatches: int = 4,
    optimizer=None,
) -> Callable[[TrainState, torch.Tensor], Tuple[TrainState, torch.Tensor]]:
    """The pipelined (GPipe) train step over a ("data", "pipe", "model")
    mesh: each stage holds L/S layers, microbatches stream between the
    stages, tensor parallelism stays live inside each stage and data
    parallelism outside (parallel/pipeline.py). Same TrainState and
    optimizer contract as make_train_step; the state comes from
    ``init_train_state(..., mesh=mesh, rules=pipeline_sharding_rules(cfg,
    mesh))`` and every rank passes the same global batch."""
    from .pipeline import pipeline_sharding_rules, pipeline_value_and_grad

    if "pipe" not in mesh.axis_names:
        raise ValueError(f"mesh has no 'pipe' axis: {mesh.axis_names}")
    optimizer = optimizer or make_optimizer(learning_rate)
    layout = Layout(mesh, pipeline_sharding_rules(cfg, mesh))

    def step(state: TrainState, tokens: torch.Tensor):
        loss, grads = pipeline_value_and_grad(
            state.params, tokens, cfg, mesh, n_microbatches, layout)
        opt_state = optimizer.update(grads, state.opt_state, state.params,
                                     layout=layout)
        return TrainState(state.params, opt_state, state.step + 1), loss

    step.layout = layout
    return step
