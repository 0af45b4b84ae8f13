"""AdamW from scratch, with a dtype-configurable state.

Counterpart of ``repro.optim.adamw``. The math is float32: the bias
corrections ``1 - b ** step`` with the power taken on float32 tensors, the
moments in float32 and stored in ``m`` / ``v``'s own dtype
(``state_dtype=torch.bfloat16`` halves them, jamba's setting), and the
parameter updated as ``(p.f32 - lr * delta)`` rounded to its own dtype:
there is no float32 master copy, as in the reference. ``update`` returns
new tensors and writes none of its inputs; each leaf is computed into its
new tensors by operations in place (:func:`_leaf`), and a DTensor leaf on
its local shards.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch

from repro_torch.parallel.sharding import is_dtensor
from repro_torch.util import tree
from repro_torch.util.numerics import sqrt_rn_


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
    bc1 = _local(1.0 - sf.new_full((), b1) ** sf)
    bc2 = _local(1.0 - sf.new_full((), b2) ** sf)
    lr = _local(lr)

    def upd(p, g, m, v):
        if not is_dtensor(p):
            return _leaf(p, g, m, v, lr, bc1, bc2, b1, b2, eps, weight_decay)
        from torch.distributed.tensor import DTensor

        # shard by shard: the gradient and the moments lie as the parameter
        out = _leaf(*(x.to_local() for x in (p, g, m, v)), lr, bc1, bc2, b1, b2, eps,
                    weight_decay)
        return tuple(DTensor.from_local(o, p.device_mesh, p.placements, run_check=False,
                                        shape=p.shape, stride=p.stride()) for o in out)

    out = [upd(*t) for t in zip(*(tree.leaves(x) for x in (params, grads, state.m, state.v)))]
    return (tree.unflatten(params, [o[0] for o in out]),
            AdamWState(step=step, m=tree.unflatten(state.m, [o[1] for o in out]),
                       v=tree.unflatten(state.v, [o[2] for o in out])))


def _local(x):
    return x.to_local() if is_dtensor(x) else x


def _leaf(p, g, m, v, lr, bc1, bc2, b1, b2, eps, weight_decay):
    """One leaf's ``(p, m, v)``, computed into the new tensors in place: the
    reference's float32 expression, operation for operation and in its
    order, with one float32 temporary of the leaf's size (``t``) beside the
    new tensors; ``u`` becomes the new parameter where it is float32 and is
    a second temporary where it is rounded to bfloat16::

        m' = b1 * m + (1 - b1) * g
        v' = b2 * v + (1 - b2) * g * g
        p' = p - lr * ((m' / bc1) / (sqrt(v' / bc2) + eps) + weight_decay * p)
    """
    f32 = torch.float32
    mf = m.to(f32, copy=True).mul_(b1)
    t = g.to(f32, copy=True).mul_(1 - b1)
    mf.add_(t)
    vf = v.to(f32, copy=True).mul_(b2)
    vf.add_(t.copy_(g).mul_(1 - b2).mul_(g))
    sqrt_rn_(torch.div(vf, bc2, out=t)).add_(eps)
    u = torch.div(mf, bc1).div_(t)
    u.add_(t.copy_(p).mul_(weight_decay))
    del t
    torch.sub(p, u.mul_(lr), out=u)
    return u.to(p.dtype), mf.to(m.dtype), vf.to(v.dtype)
