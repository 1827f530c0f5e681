"""Aquifer-backed checkpointing: state trees ⇄ paged snapshots in the pool."""
from .ckpt import (
    default_train_hotness,
    flatten_state,
    reshard,
    restore_checkpoint,
    save_checkpoint,
    unflatten_state,
)

__all__ = ["default_train_hotness", "flatten_state", "reshard", "restore_checkpoint",
           "save_checkpoint", "unflatten_state"]
