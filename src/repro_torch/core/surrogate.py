"""Surrogate-gradient spike function.

Counterpart of ``repro.core.surrogate``. The hardware is inference-only;
the classifier's weights are prepared on the host, and surrogate-gradient
BPTT through the plain tick loop (the ``jnp`` backend) trains a spiking
network offline.

Forward: Heaviside step. Backward: fast-sigmoid surrogate (SuperSpike,
Zenke & Ganguli 2018): ``d/dx H(x) ~= 1 / (beta*|x| + 1)^2``.
"""
from __future__ import annotations

import torch

DEFAULT_BETA = 10.0


class _SpikeSurrogate(torch.autograd.Function):
    """Heaviside forward, fast-sigmoid backward (the reference's custom_vjp)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, beta: float) -> torch.Tensor:
        ctx.save_for_backward(x)
        ctx.beta = beta
        return (x >= 0).to(x.dtype)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        (x,) = ctx.saved_tensors
        surr = 1.0 / (ctx.beta * torch.abs(x) + 1.0) ** 2
        return g * surr.to(g.dtype), None


def spike_surrogate(x: torch.Tensor, beta: float = DEFAULT_BETA) -> torch.Tensor:
    """Heaviside forward / fast-sigmoid backward."""
    return _SpikeSurrogate.apply(x, beta)


def spike_hard(x: torch.Tensor) -> torch.Tensor:
    """Non-differentiable Heaviside (inference datapath)."""
    return (x >= 0).to(x.dtype)
