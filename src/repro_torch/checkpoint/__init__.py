"""Checkpoints in ``repro``'s on-disk format (``repro.checkpoint``'s port)."""
from .store import (CheckpointManager, committed_steps, latest_step,
                    restore_pytree, save_pytree)

__all__ = ["CheckpointManager", "committed_steps", "latest_step",
           "restore_pytree", "save_pytree"]
