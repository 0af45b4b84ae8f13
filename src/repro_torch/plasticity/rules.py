"""Rule dispatch: one entry point for a learning tick, on either backend.

Counterpart of ``repro.plasticity.rules``. :func:`plasticity_step` is what
the tick engine calls. It owns the single state<->array bridge (flatten the
batch dimensions, default the reward to 0, expand the hyper-parameters,
rebuild :class:`PlasticityState`) and routes the array-level work to the
plain twin (:func:`repro_torch.kernels.ref.fused_stdp_step_ref`, backend
``"jnp"``) or to kernel B5
(:func:`repro_torch.kernels.stdp_update.fused_stdp_step`, backend
``"pallas"``; its twin on CPU tensors). The reference routes the kernel
through ``repro.kernels.ops``, which pads every operand to block multiples;
kernel B5 bounds-checks its ragged edges, so the port has no such bridge.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.plasticity.stdp import PlasticityParams, PlasticityState

BACKENDS = ("jnp", "pallas")


def hyper_kwargs(params: PlasticityParams) -> dict:
    """The array-level hyper-parameter expansion both backends share."""
    return dict(
        rule=params.rule, a_plus=params.a_plus, a_minus=params.a_minus,
        decay_pre=params.decay_pre, decay_post=params.decay_post,
        decay_elig=params.decay_elig, lr_reward=params.lr_reward,
        w_min=params.w_min, w_max=params.w_max)


def plasticity_step(state: PlasticityState, s_pre: torch.Tensor, s_post: torch.Tensor,
                    w: torch.Tensor, c: torch.Tensor, params: PlasticityParams,
                    reward=None, *, backend: str = "jnp", tick=None, learn_until=None,
                    in_place: bool = False, dw_stats: bool = False) -> Tuple:
    """One learning tick: update traces, eligibility and weights.

    Args:
      s_pre, s_post: spikes ``(..., n_pre)`` / ``(..., n_post)``; with
        ``(S, n, n)`` weights the leading axis is the slot axis.
      w: weights ``(n_pre, n_post)`` or ``(S, n_pre, n_post)``.
      c: plastic mask, ``w``'s shape or shared ``(n_pre, n_post)``.
      reward: scalar (or per-slot ``(S,)``) dopamine; None means 0.
      backend: ``"jnp"`` (the plain twin) or ``"pallas"`` (kernel B5).
      tick, learn_until: optional gate, as device int32 tensors (0-d, and
        0-d or ``(S,)``); where ``tick >= learn_until`` nothing changes.
      in_place: the caller owns ``w`` and ``state.elig`` and lets the
        kernel update them in their buffers (ignored by ``"jnp"``).
      dw_stats: also return the ``(G, P, 2)`` partial sums of ``|dw|`` and
        ``dw^2`` of the committed update, per weight matrix (the tick
        telemetry's): kernel B5's per-block partials, or on ``"jnp"`` the
        reference's ``w' - w`` summed in PyTorch.

    Returns ``(new_state, new_weights)``, and the statistics third with
    ``dw_stats``.
    """
    if backend not in BACKENDS:
        raise ValueError(f"unknown plasticity backend {backend!r}")
    S = w.shape[0] if w.dim() == 3 else None
    lead = () if S is None else (S,)
    flat = lambda a: a.reshape(lead + (-1, a.shape[-1]))
    dev = w.device
    r = (torch.zeros((), dtype=torch.float32, device=dev) if reward is None
         else torch.as_tensor(reward, dtype=torch.float32, device=dev))
    args = (flat(s_pre), flat(state.x_pre), flat(s_post), flat(state.x_post),
            w, c, state.elig, r)
    if backend == "jnp":
        from repro_torch.kernels.ref import fused_stdp_step_ref

        got = fused_stdp_step_ref(*args, tick=tick, learn_until=learn_until,
                                  dw_stats=dw_stats, **hyper_kwargs(params))
    else:
        from repro_torch.kernels import stdp_update

        got = stdp_update.fused_stdp_step(*args, tick=tick, learn_until=learn_until,
                                          in_place=in_place, dw_stats=dw_stats,
                                          **hyper_kwargs(params))
    out, stats = got if dw_stats else (got, None)
    pst = PlasticityState(x_pre=out.x_pre.reshape(s_pre.shape),
                          x_post=out.x_post.reshape(s_post.shape), elig=out.elig)
    return (pst, out.w, stats) if dw_stats else (pst, out.w)
