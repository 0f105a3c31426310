"""Checkpointing of the train state (port of `repro.ckpt`)."""
from .checkpoint import (
    CheckpointManager,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)

__all__ = [
    "CheckpointManager", "save_checkpoint", "restore_checkpoint", "latest_step",
]
