"""Atomic, rotated, resumable checkpoints (counterpart of ``repro.checkpoint``)."""
from repro_torch.checkpoint.checkpointer import (
    AsyncCheckpointer, all_steps, latest_step, restore, save,
)

__all__ = ["AsyncCheckpointer", "all_steps", "latest_step", "restore", "save"]
