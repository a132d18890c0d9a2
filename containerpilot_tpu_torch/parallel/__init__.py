"""Training state, optimizer, train steps, checkpoints, and training
across ranks: the mesh as a torch.distributed world, sharding rules,
tensor/expert/data parallelism, ZeRO-1, FSDP and the GPipe pipeline;
context-parallel serving (``context_parallel_config``, ``cp_generate``)
and the serving lockstep of ranks (parallel/serving.py) (counterpart of
``containerpilot_tpu/parallel``; the context-parallel training step is
not ported yet).
"""
from .checkpoint import (
    latest_step,
    restore_checkpoint,
    restore_params,
    save_checkpoint,
    wait_for_checkpoints,
)
from .context import (
    context_parallel_config,
    cp_generate,
    cp_prefill_with_remainder,
    resolve_cp_min_len,
)
from .distributed import initialize_from_catalog, initialize_from_env
from .mesh import Mesh, MeshPlan, make_mesh
from .pipeline import (
    pipeline_forward_with_aux,
    pipeline_loss_fn,
    pipeline_sharding_rules,
)
from .sharding import (
    fsdp_sharding_rules,
    gather_params,
    param_sharding_rules,
    shard_params,
)
from .train import (
    TrainState,
    abstract_train_state,
    ema_params,
    init_train_state,
    lora_abstract_state,
    lr_schedule,
    make_lora_train_step,
    make_optimizer,
    make_pipeline_train_step,
    make_train_step,
    train_state_shardings,
    with_ema,
)
from .watchdog import StepWatchdog

__all__ = [
    "Mesh",
    "MeshPlan",
    "StepWatchdog",
    "TrainState",
    "abstract_train_state",
    "context_parallel_config",
    "cp_generate",
    "cp_prefill_with_remainder",
    "ema_params",
    "fsdp_sharding_rules",
    "gather_params",
    "init_train_state",
    "initialize_from_catalog",
    "initialize_from_env",
    "latest_step",
    "lora_abstract_state",
    "lr_schedule",
    "make_lora_train_step",
    "make_mesh",
    "make_optimizer",
    "make_pipeline_train_step",
    "make_train_step",
    "param_sharding_rules",
    "pipeline_forward_with_aux",
    "pipeline_loss_fn",
    "pipeline_sharding_rules",
    "resolve_cp_min_len",
    "restore_checkpoint",
    "restore_params",
    "save_checkpoint",
    "shard_params",
    "train_state_shardings",
    "wait_for_checkpoints",
    "with_ema",
]
