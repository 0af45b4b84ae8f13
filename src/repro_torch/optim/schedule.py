"""LR schedules (pure functions of the step counter).

Counterpart of ``repro.optim.schedule``. ``step`` is the optimizer's int32
step tensor (the count of updates before this one, so the rate at step 0 is
0); the arithmetic is float32 on its device, as the reference's
``step.astype(f32)``. Each divisor is a tensor: CUDA divides by a Python
number as a multiplication by its reciprocal, which rounds otherwise.
"""
from __future__ import annotations

import math

import torch


def warmup_cosine(step: torch.Tensor, *, peak_lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1) -> torch.Tensor:
    s = step.float()
    warm = peak_lr * s / s.new_full((), max(1.0, warmup_steps))
    prog = torch.clamp((s - warmup_steps) / s.new_full((), max(1.0, total_steps - warmup_steps)),
                       0.0, 1.0)
    cos = peak_lr * (final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * prog)))
    return torch.where(s < warmup_steps, warm, cos)


def constant(step: torch.Tensor, *, peak_lr: float) -> torch.Tensor:
    return torch.full_like(step.float(), peak_lr)
