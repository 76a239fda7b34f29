"""Checkpointing: atomic tree save / restore in the reference's on-disk
layout, and a manager with cadence, retention, async writes and the
preemption flag."""

from repro_torch.checkpoint.manager import CheckpointConfig, CheckpointManager
from repro_torch.checkpoint.store import (list_steps, restore_pytree,
                                          save_pytree)

__all__ = [
    "save_pytree",
    "restore_pytree",
    "list_steps",
    "CheckpointManager",
    "CheckpointConfig",
]
