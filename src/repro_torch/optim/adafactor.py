"""Adafactor (Shazeer & Stern 2018): factored second moment.

Counterpart of ``repro.optim.adafactor``: a leaf of rank >= 2 keeps row
factors ``vr`` (its shape without the last axis) and column factors ``vc``
(without the second to last), a vector keeps its full ``vr`` and a 0-d
placeholder ``vc``; every state leaf is float32. The update is clipped by
its RMS, and the parameter is updated in its own dtype.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch

from repro_torch.util import tree
from repro_torch.util.numerics import sqrt_rn


class AdafactorState(NamedTuple):
    step: torch.Tensor   # () int32
    vr: Any              # row factors (or the full v for leaves of rank < 2)
    vc: Any              # column factors (a 0-d placeholder for leaves of rank < 2)


def _factored(p) -> bool:
    return p.ndim >= 2


def init(params) -> AdafactorState:
    f32 = dict(dtype=torch.float32)

    def vr_init(p):
        return torch.zeros(p.shape[:-1] if _factored(p) else p.shape, device=p.device, **f32)

    def vc_init(p):
        shape = p.shape[:-2] + p.shape[-1:] if _factored(p) else ()
        return torch.zeros(shape, device=p.device, **f32)

    dev = tree.leaves(params)[0].device
    return AdafactorState(step=torch.zeros((), dtype=torch.int32, device=dev),
                          vr=tree.map(vr_init, params), vc=tree.map(vc_init, params))


def update(grads, state: AdafactorState, params, *, lr, decay: float = 0.99,
           eps: float = 1e-30, clip_threshold: float = 1.0,
           weight_decay: float = 0.0) -> Tuple[Any, AdafactorState]:
    step = state.step + 1

    def upd(p, g, vr, vc):
        gf = g.float()
        g2 = gf * gf + eps
        if _factored(p):
            new_vr = decay * vr + (1 - decay) * g2.mean(dim=-1)
            new_vc = decay * vc + (1 - decay) * g2.mean(dim=-2)
            denom_r = new_vr / torch.clamp(new_vr.mean(dim=-1, keepdim=True), min=eps)
            u = gf / (sqrt_rn(denom_r)[..., None] * sqrt_rn(new_vc)[..., None, :] + eps)
        else:
            new_vr = decay * vr + (1 - decay) * g2
            new_vc = vc
            u = gf / (sqrt_rn(new_vr) + eps)
        # update clipping by RMS
        rms = sqrt_rn(torch.mean(u * u) + eps)
        u = u / torch.clamp(rms / rms.new_full((), clip_threshold), min=1.0)
        newp = p.float() - lr * (u + weight_decay * p.float())
        return newp.to(p.dtype), new_vr, new_vc

    out = [upd(*t) for t in zip(*(tree.leaves(x) for x in (params, grads, state.vr, state.vc)))]
    return (tree.unflatten(params, [o[0] for o in out]),
            AdafactorState(step=step, vr=tree.unflatten(state.vr, [o[1] for o in out]),
                           vc=tree.unflatten(state.vc, [o[2] for o in out])))
