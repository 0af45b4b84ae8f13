"""Optimizers, schedules, clipping and gradient compression (counterpart of
``repro.optim``): functions of trees of tensors, the arithmetic in float32
as the reference's, each state leaf in its own dtype."""
from repro_torch.optim import adafactor, adamw, clip, compression, schedule

__all__ = ["adamw", "adafactor", "schedule", "clip", "compression"]
