"""Exponential spike traces -- the plasticity subsystem's state variables.

Counterpart of ``repro.plasticity.traces``. A trace ``x`` low-pass filters a
spike train: every tick it decays by a constant factor and increments by
the tick's spikes,

    x[k+1] = decay * x[k] + s[k+1],        decay = exp(-1 / tau).

Traces are carried per neuron: pair-based STDP needs the presynaptic trace
``x_pre`` (potentiation) and the postsynaptic trace ``x_post``
(depression). The per-synapse eligibility of R-STDP lives in
:class:`repro_torch.plasticity.stdp.PlasticityState`.
"""
from __future__ import annotations

import math

import torch


def decay_from_tau(tau: float) -> float:
    """Per-tick decay factor ``exp(-1/tau)`` for a time constant in ticks."""
    if tau <= 0:
        raise ValueError(f"tau must be positive, got {tau}")
    return math.exp(-1.0 / tau)


def trace_step(x: torch.Tensor, spikes: torch.Tensor, decay: float) -> torch.Tensor:
    """One tick of the trace filter (decay *then* accumulate): the result
    includes this tick's spikes, so a pre and a post spike in the same tick
    see each other."""
    return decay * x + spikes.to(x.dtype)


def trace_steady_state(rate: float, decay: float) -> float:
    """Fixed point of the filter under a constant spike rate."""
    return rate / (1.0 - decay)
