"""AdamW from scratch, with a dtype-configurable state.

Counterpart of ``repro.optim.adamw``. The math is float32: the bias
corrections ``1 - b ** step`` with the power taken on float32 tensors, the
moments in float32 and stored in ``m`` / ``v``'s own dtype
(``state_dtype=torch.bfloat16`` halves them, jamba's setting), and the
parameter updated as ``(p.f32 - lr * delta)`` rounded to its own dtype:
there is no float32 master copy, as in the reference. ``update`` returns
new tensors and writes none of its inputs.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch

from repro_torch.util import tree
from repro_torch.util.numerics import sqrt_rn


class AdamWState(NamedTuple):
    step: torch.Tensor   # () int32: the updates taken
    m: Any
    v: Any


def init(params, state_dtype=torch.float32) -> AdamWState:
    """Zero moments in ``state_dtype`` beside each parameter; step 0 on the
    parameters' device."""
    z = lambda p: torch.zeros(p.shape, dtype=state_dtype, device=p.device)
    dev = tree.leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      m=tree.map(z, params), v=tree.map(z, params))


def update(grads, state: AdamWState, params, *, lr, b1: float = 0.9, b2: float = 0.95,
           eps: float = 1e-8, weight_decay: float = 0.1) -> Tuple[Any, AdamWState]:
    """Returns (new_params, new_state). ``lr`` is a float or a 0-d float32
    tensor (the schedule's)."""
    step = state.step + 1
    sf = step.float()
    bc1 = 1.0 - sf.new_full((), b1) ** sf
    bc2 = 1.0 - sf.new_full((), b2) ** sf

    def upd(p, g, m, v):
        gf = g.float()
        mf = b1 * m.float() + (1 - b1) * gf
        vf = b2 * v.float() + (1 - b2) * gf * gf
        mhat = mf / bc1
        vhat = vf / bc2
        delta = mhat / (sqrt_rn(vhat) + eps) + weight_decay * p.float()
        newp = (p.float() - lr * delta).to(p.dtype)
        return newp, mf.to(m.dtype), vf.to(v.dtype)

    out = [upd(*t) for t in zip(*(tree.leaves(x) for x in (params, grads, state.m, state.v)))]
    return (tree.unflatten(params, [o[0] for o in out]),
            AdamWState(step=step, m=tree.unflatten(state.m, [o[1] for o in out]),
                       v=tree.unflatten(state.v, [o[2] for o in out])))
