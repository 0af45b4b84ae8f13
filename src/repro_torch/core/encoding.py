"""Spike encoders / decoders (the paper's host-side preprocessing, §IV).

Counterpart of ``repro.core.encoding``. Every encoder is deterministic
(threshold, level, Bresenham rate code, latency code), so the port's
outputs equal the reference's bit for bit. The decoders break ties
towards the lower index, as ``jnp.argmax`` / ``argmin`` do; they return
int64 indices where the reference returns int32.
"""
from __future__ import annotations

from typing import Optional

import torch


def binarize(x: torch.Tensor, threshold: float = 0.5) -> torch.Tensor:
    """Pixels above threshold spike ('1'), the rest stay silent ('0')."""
    return (x > threshold).to(torch.float32)


def level_encode(x: torch.Tensor, levels: int = 4, x_max: float = 1.0) -> torch.Tensor:
    """Quantize a feature in [0, x_max] to an integer impulse magnitude."""
    q = torch.round(torch.clamp(x / x_max, 0.0, 1.0) * levels)
    return q.to(torch.float32)


def rate_encode(x: torch.Tensor, n_ticks: int, x_max: float = 1.0) -> torch.Tensor:
    """Deterministic rate code: ``(n_ticks, *x.shape)`` of {0,1} spikes,
    evenly spaced (spike at tick t iff floor(frac*(t+1)) > floor(frac*t))."""
    frac = torch.clamp(x / x_max, 0.0, 1.0)
    t = torch.arange(1, n_ticks + 1, dtype=torch.float32, device=x.device)
    t = t.reshape((n_ticks,) + (1,) * x.dim())
    shaped = frac[None, ...] * t
    prev = frac[None, ...] * (t - 1.0)
    return (torch.floor(shaped + 1e-6) > torch.floor(prev + 1e-6)).to(torch.float32)


def latency_encode(x: torch.Tensor, n_ticks: int, x_max: float = 1.0) -> torch.Tensor:
    """Stronger inputs spike earlier; zero input never spikes."""
    frac = torch.clamp(x / x_max, 0.0, 1.0)
    fire_at = torch.where(frac > 0, torch.round((1.0 - frac) * (n_ticks - 1)),
                          torch.full_like(frac, float(n_ticks)))
    t = torch.arange(n_ticks, device=x.device).reshape((n_ticks,) + (1,) * x.dim())
    return (t == fire_at[None, ...]).to(torch.float32)


def decode_spike_count(spikes: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Class = output neuron with the highest accumulated activation."""
    return torch.argmax(spikes.sum(dim=axis), dim=-1)


def decode_first_spike(spikes: torch.Tensor, v: Optional[torch.Tensor] = None, *,
                       silent: int = -1) -> torch.Tensor:
    """Class = first output neuron to spike (ties -> lower index).

    ``spikes`` has shape ``(T, ..., n_out)``. All-silent rows fall back to
    :func:`decode_potential` when the final potentials ``v`` are given,
    and otherwise return the ``silent`` sentinel (never a valid class).
    """
    n_ticks = spikes.shape[0]
    ticks = torch.arange(n_ticks, dtype=torch.float32, device=spikes.device).reshape(
        (n_ticks,) + (1,) * (spikes.dim() - 1))
    first = torch.where(spikes > 0, ticks,
                        torch.tensor(float(n_ticks), device=spikes.device))
    first = first.min(dim=0).values
    pred = torch.argmin(first, dim=-1)
    all_silent = first.min(dim=-1).values >= n_ticks
    if v is not None:
        fallback = decode_potential(v)
    else:
        fallback = torch.full_like(pred, silent)
    return torch.where(all_silent, fallback, pred)


def decode_potential(v: torch.Tensor) -> torch.Tensor:
    """Class = output neuron with the highest final membrane potential."""
    return torch.argmax(v, dim=-1)
