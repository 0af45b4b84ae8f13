"""Discrete-time leaky integrate-and-fire (LIF) neuron dynamics.

Counterpart of ``repro.core.lif``: the paper's Euler model (Eq. 1-4), the
fixed-leak hardware model (Eq. 5) and the integer datapath, as plain
functions on tensors with arbitrary leading (batch) dimensions.
``surrogate=True`` spikes through :func:`~repro_torch.core.surrogate.spike_surrogate`
(Heaviside forward, fast-sigmoid backward), for BPTT.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import device as _device
from repro_torch.core.surrogate import spike_surrogate


@dataclasses.dataclass(frozen=True)
class LIFParams:
    """Neuron parameters, one entry per neuron (shape ``(n,)``).

    Attributes:
      v_th: firing threshold ``V_th``.
      leak: Euler mode: ``dt/tau_m``. Fixed-leak mode: the decrement ``lambda``.
      r_ref: refractory length in ticks (int32).
      gain: Euler mode input gain ``dt/C_m``.
      i_bias: tonic bias current.
      v_reset: reset potential.
    """

    v_th: torch.Tensor
    leak: torch.Tensor
    r_ref: torch.Tensor
    gain: torch.Tensor
    i_bias: torch.Tensor
    v_reset: torch.Tensor

    @staticmethod
    def make(
        n: int,
        *,
        v_th: float = 1.0,
        leak: float = 0.0,
        r_ref: int = 0,
        gain: float = 1.0,
        i_bias: float = 0.0,
        v_reset: float = 0.0,
        dtype=torch.float32,
        device=None,
    ) -> "LIFParams":
        dev = _device.resolve(device)
        full = lambda v: torch.full((n,), v, dtype=dtype, device=dev)
        return LIFParams(
            v_th=full(v_th),
            leak=full(leak),
            r_ref=torch.full((n,), r_ref, dtype=torch.int32, device=dev),
            gain=full(gain),
            i_bias=full(i_bias),
            v_reset=full(v_reset),
        )


@dataclasses.dataclass(frozen=True)
class LIFState:
    """Dynamic neuron state, shape ``(..., n)`` each.

    Attributes:
      v: membrane potential.
      r: refractory counter (ticks remaining), int32.
      y: output spikes of the previous tick.
    """

    v: torch.Tensor
    r: torch.Tensor
    y: torch.Tensor

    @staticmethod
    def zeros(batch_shape, n: int, dtype=torch.float32, device=None) -> "LIFState":
        dev = _device.resolve(device)
        shape = tuple(batch_shape) + (n,)
        return LIFState(
            v=torch.zeros(shape, dtype=dtype, device=dev),
            r=torch.zeros(shape, dtype=torch.int32, device=dev),
            y=torch.zeros(shape, dtype=dtype, device=dev),
        )


def _threshold_reset_refractory(v_tilde, state: LIFState, params: LIFParams,
                                *, surrogate: bool = False, reset: str = "zero") -> LIFState:
    """Paper Eq. 2-4: spike, reset, refractory-counter update."""
    not_refractory = state.r == 0
    if surrogate:
        y = spike_surrogate(v_tilde - params.v_th) * not_refractory.to(v_tilde.dtype)
    else:
        y = ((v_tilde >= params.v_th) & not_refractory).to(v_tilde.dtype)
    spiked = y > 0
    v_reset = params.v_reset.to(v_tilde.dtype)
    if reset == "subtract":
        v_new = torch.where(spiked, v_tilde - params.v_th.to(v_tilde.dtype), v_tilde)
        v_new = torch.where(state.r > 0, v_reset, v_new)
    else:
        # Eq. 3: v resets if the neuron spiked OR it is still refractory.
        v_new = torch.where(spiked | (state.r > 0), v_reset, v_tilde)
    # Eq. 4: reload the counter on spike, else count down to zero.
    r_new = torch.where(spiked, params.r_ref, torch.clamp_min(state.r - 1, 0))
    return LIFState(v=v_new, r=r_new.to(state.r.dtype), y=y)


def lif_step_euler(state: LIFState, syn_input: torch.Tensor, params: LIFParams,
                   *, surrogate: bool = False, reset: str = "zero") -> LIFState:
    """One tick of the Euler LIF model (paper Eq. 1-4)."""
    decay = (1.0 - params.leak).to(state.v.dtype)
    v_tilde = decay * state.v + params.gain * (syn_input + params.i_bias)
    return _threshold_reset_refractory(v_tilde, state, params, surrogate=surrogate,
                                       reset=reset)


def lif_step_fixed_leak(state: LIFState, syn_input: torch.Tensor, params: LIFParams,
                        *, surrogate: bool = False, reset: str = "zero") -> LIFState:
    """One tick of the fixed-leak hardware model (paper Eq. 5).

    ``v' = v + sum_j w_j s_j - lambda * 1{v != 0}``, with the leak
    contribution clamped so that the leak alone never crosses rest.
    """
    active = (state.v != 0).to(state.v.dtype)
    leak_step = torch.minimum(params.leak * active, torch.abs(state.v))
    v_tilde = state.v + syn_input + params.i_bias - torch.sign(state.v) * leak_step
    return _threshold_reset_refractory(v_tilde, state, params, surrogate=surrogate,
                                       reset=reset)


def lif_step_int(state: LIFState, syn_input: torch.Tensor, params: LIFParams,
                 *, reset: str = "zero") -> LIFState:
    """Bit-faithful integer datapath (u8 weights, i32 accumulate)."""
    i32 = torch.int32
    v = state.v.to(i32)
    syn = syn_input.to(i32) + params.i_bias.to(i32)
    leak_step = torch.minimum(params.leak.to(i32) * (v != 0).to(i32), torch.abs(v))
    v_tilde = v + syn - torch.sign(v) * leak_step
    th = params.v_th.to(i32)
    spiked = (v_tilde >= th) & (state.r == 0)
    v_reset = params.v_reset.to(i32)
    if reset == "subtract":
        v_new = torch.where(spiked, v_tilde - th, v_tilde)
        v_new = torch.where(state.r > 0, v_reset, v_new)
    else:
        v_new = torch.where(spiked | (state.r > 0), v_reset, v_tilde)
    r_new = torch.where(spiked, params.r_ref, torch.clamp_min(state.r - 1, 0))
    return LIFState(v=v_new, r=r_new.to(state.r.dtype), y=spiked.to(i32))


def lif_step(state: LIFState, syn_input: torch.Tensor, params: LIFParams, *,
             mode: str = "fixed_leak", surrogate: bool = False,
             reset: str = "zero") -> LIFState:
    """Dispatch on the paper's two formulations (+ integer datapath)."""
    if mode == "euler":
        return lif_step_euler(state, syn_input, params, surrogate=surrogate, reset=reset)
    if mode == "fixed_leak":
        return lif_step_fixed_leak(state, syn_input, params, surrogate=surrogate,
                                   reset=reset)
    if mode == "int":
        return lif_step_int(state, syn_input, params, reset=reset)
    raise ValueError(f"unknown LIF mode: {mode!r}")
