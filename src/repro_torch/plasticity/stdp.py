"""Pair-based STDP / R-STDP: parameters, state and the reference update.

Counterpart of ``repro.plasticity.stdp``. Semantics of one network tick:

    x_pre'  = decay_pre  * x_pre  + s_pre          (trace incl. this tick)
    x_post' = decay_post * x_post + s_post
    dw[i,j] = a_plus  * sum_b x_pre'[b,i] * s_post[b,j]      (LTP)
            - a_minus * sum_b s_pre[b,i]  * x_post'[b,j]     (LTD)

``s_pre`` are the spikes arriving this tick, ``s_post`` the spikes the
updated neurons emit. Batch rows sum into the one shared weight matrix.
Updates are gated by the plastic mask ``c`` and clipped to the register
bank's u8 domain ``[w_min, w_max]``, so a learned matrix rounds onto the
wire format losslessly (:func:`weights_to_bank` / :func:`weights_from_bank`).

Rules: ``"stdp"`` applies ``dw`` at once; ``"rstdp"`` accumulates it into a
per-synapse eligibility ``elig' = decay_elig * elig + dw`` and applies
``w' = w + (lr_reward * reward) * elig'``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.plasticity import traces

RULES = ("stdp", "rstdp")


@dataclasses.dataclass(frozen=True)
class PlasticityParams:
    """Learning hyper-parameters (the reference's fields and defaults).

    Frozen and hashable like the LIF ``mode``; the values reach the STDP
    kernel as runtime launch arguments, so changing them rebuilds nothing.

    Attributes:
      rule: ``"stdp"`` or ``"rstdp"``.
      a_plus: LTP amplitude per (pre-trace, post-spike) pairing.
      a_minus: LTD amplitude per (pre-spike, post-trace) pairing.
      decay_pre, decay_post: per-tick trace decays ``exp(-1/tau)``.
      decay_elig: per-tick eligibility decay (R-STDP only).
      lr_reward: reward learning rate (R-STDP only).
      w_min, w_max: hard weight bounds inside the u8 domain.
    """

    rule: str = "stdp"
    a_plus: float = 1.0
    a_minus: float = 1.0
    decay_pre: float = 0.7165313106
    decay_post: float = 0.7165313106
    decay_elig: float = 0.9048374180
    lr_reward: float = 1.0
    w_min: float = 0.0
    w_max: float = 255.0

    def __post_init__(self):
        if self.rule not in RULES:
            raise ValueError(f"unknown plasticity rule {self.rule!r}; have {RULES}")
        if not (0.0 <= self.w_min < self.w_max <= 255.0):
            raise ValueError(
                f"[w_min, w_max]=[{self.w_min}, {self.w_max}] must lie in the "
                "u8 register domain [0, 255]")

    @staticmethod
    def make(rule: str = "stdp", *, tau_pre: float = 3.0, tau_post: float = 3.0,
             tau_elig: float = 10.0, a_plus: float = 1.0, a_minus: float = 1.0,
             lr_reward: float = 1.0, w_min: float = 0.0,
             w_max: float = 255.0) -> "PlasticityParams":
        """Construct from time constants in ticks."""
        return PlasticityParams(
            rule=rule, a_plus=a_plus, a_minus=a_minus,
            decay_pre=traces.decay_from_tau(tau_pre),
            decay_post=traces.decay_from_tau(tau_post),
            decay_elig=traces.decay_from_tau(tau_elig),
            lr_reward=lr_reward, w_min=w_min, w_max=w_max)


@dataclasses.dataclass(frozen=True)
class PlasticityState:
    """Learning state carried through the tick loop.

    Attributes:
      x_pre: presynaptic traces ``(..., n_pre)`` (batch dims match the state).
      x_post: postsynaptic traces ``(..., n_post)``.
      elig: per-synapse eligibility ``(n_pre, n_post)``, or ``(S, n_pre,
        n_post)`` with a slot axis -- shared across the batch like the
        weights it gates (zeros and untouched for ``rule="stdp"``).
    """

    x_pre: torch.Tensor
    x_post: torch.Tensor
    elig: torch.Tensor

    @staticmethod
    def zeros(batch_shape, n_pre: int, n_post: Optional[int] = None,
              dtype=torch.float32, device=None,
              slots: Optional[int] = None) -> "PlasticityState":
        """Zero traces and eligibility; ``slots=S`` prefixes a slot axis to
        every leaf (the multi-tenant server's resident networks)."""
        dev = _device.resolve(device)
        n_post = n_pre if n_post is None else n_post
        lead = () if slots is None else (int(slots),)
        shape = lead + tuple(batch_shape)
        return PlasticityState(
            x_pre=torch.zeros(shape + (n_pre,), dtype=dtype, device=dev),
            x_post=torch.zeros(shape + (n_post,), dtype=dtype, device=dev),
            elig=torch.zeros(lead + (n_pre, n_post), dtype=dtype, device=dev))


def stdp_step_ref(state: PlasticityState, s_pre: torch.Tensor, s_post: torch.Tensor,
                  w: torch.Tensor, c: torch.Tensor, params: PlasticityParams,
                  reward: Optional[torch.Tensor] = None
                  ) -> Tuple[PlasticityState, torch.Tensor]:
    """One learning tick with the plain PyTorch twin; returns
    ``(new_state, new_weights)``. Synapses with ``c == 0`` come back
    bit-identical (not even clipped)."""
    from repro_torch.plasticity.rules import plasticity_step

    return plasticity_step(state, s_pre, s_post, w, c, params, reward, backend="jnp")


def apply_reward(w: torch.Tensor, elig: torch.Tensor, reward, params: PlasticityParams,
                 c: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Episode-level R-STDP: ``w' = clip(w + lr * r * elig)`` where ``c > 0``
    (everywhere when ``c`` is None)."""
    wf = w.to(torch.float32)
    r = torch.as_tensor(reward, dtype=torch.float32, device=w.device)
    w_new = torch.clamp(wf + params.lr_reward * r * elig.to(torch.float32),
                        params.w_min, params.w_max)
    if c is not None:
        w_new = torch.where(c.to(torch.float32) > 0, w_new, wf)
    return w_new.to(w.dtype)


# ---------------------------------------------------------------------------
# register-bank readback: the reconfiguration story in reverse


def quantize_weights(w) -> np.ndarray:
    """Round learned weights (already clipped to [0, 255]) onto the u8 grid."""
    if isinstance(w, torch.Tensor):
        w = w.detach().cpu().numpy()
    wq = np.rint(np.asarray(w, np.float64))
    if wq.min() < 0 or wq.max() > 255:
        raise ValueError(
            f"weights [{wq.min()}, {wq.max()}] outside the u8 register domain "
            "-- was the rollout run with w_min/w_max inside [0, 255]?")
    return wq.astype(np.uint8)


def weights_to_bank(bank, w) -> np.ndarray:
    """Write a learned ``(n, n)`` weight matrix into a PER_SYNAPSE bank;
    returns the u8 matrix actually stored."""
    from repro_torch.core.registers import WeightLayout

    if bank.weight_layout != WeightLayout.PER_SYNAPSE:
        raise ValueError("learned weights need WeightLayout.PER_SYNAPSE")
    wq = quantize_weights(w)
    bank.set_weights(wq)
    return wq


def weights_from_bank(bank, dtype=torch.float32, device=None) -> torch.Tensor:
    """Read the bank's u8 weights back to the learning (float) domain."""
    return torch.as_tensor(np.asarray(bank.weights), dtype=dtype,
                           device=_device.resolve(device))
