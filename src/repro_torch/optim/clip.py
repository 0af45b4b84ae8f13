"""Global-norm gradient clipping.

Counterpart of ``repro.optim.clip``. Each leaf's sum of squares is taken in
float32, and the sums are added in ``jax.tree.leaves``' order (a dict's
children by sorted key, :mod:`repro_torch.util.tree`), as the reference's
Python ``sum`` does. A leaf keeps its dtype: a bf16 gradient is scaled in
float32 and rounded back.
"""
from __future__ import annotations

import torch

from repro_torch.util import tree
from repro_torch.util.numerics import sqrt_rn


def global_norm(grads) -> torch.Tensor:
    return sqrt_rn(sum(torch.sum(x.float() ** 2) for x in tree.leaves(grads)))


def clip_by_global_norm(grads, max_norm: float):
    """Returns (clipped grads, the norm before clipping)."""
    norm = global_norm(grads)
    scale = torch.clamp(norm.new_full((), max_norm) / torch.clamp(norm, min=1e-9), max=1.0)
    return tree.map(lambda g: (g.float() * scale).to(g.dtype), grads), norm
