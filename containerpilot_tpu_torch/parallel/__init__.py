"""Training state, optimizer, train and LoRA steps and checkpoints on one
device (counterpart of ``containerpilot_tpu/parallel``; meshes, sharding,
context and pipeline parallelism are not ported yet)."""
from .checkpoint import (
    latest_step,
    restore_checkpoint,
    restore_params,
    save_checkpoint,
    wait_for_checkpoints,
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
    make_train_step,
    with_ema,
)

__all__ = [
    "TrainState",
    "abstract_train_state",
    "ema_params",
    "init_train_state",
    "latest_step",
    "lora_abstract_state",
    "lr_schedule",
    "make_lora_train_step",
    "make_optimizer",
    "make_train_step",
    "restore_checkpoint",
    "restore_params",
    "save_checkpoint",
    "wait_for_checkpoints",
    "with_ema",
]
