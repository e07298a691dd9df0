"""Training substrate: optimizer, train step, data pipeline, checkpointing
(the port of the JAX package's ``training/``), on one device or a mesh."""

from .checkpoint import (CheckpointManager, latest_step, load_checkpoint,
                         save_checkpoint)
from .data import DataConfig, SyntheticStream
from .optimizer import AdamWConfig, adamw_init, adamw_update, lr_schedule
from .train_loop import (batch_shardings, init_train_state, make_train_step,
                         train_state_defs, train_state_shardings)

__all__ = [
    "AdamWConfig", "CheckpointManager", "DataConfig", "SyntheticStream",
    "adamw_init", "adamw_update", "batch_shardings", "init_train_state",
    "latest_step", "load_checkpoint", "lr_schedule", "make_train_step",
    "save_checkpoint", "train_state_defs", "train_state_shardings",
]
