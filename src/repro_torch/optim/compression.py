"""int8 error-feedback gradient compression (the pod-axis all-reduce trick).

Counterpart of ``repro.optim.compression``: each leaf is quantised to int8
with one float32 scale (its largest magnitude over 127, at least 1e-12 /
127), rounding half to even as ``jnp.round``; the quantisation error is
carried in a float32 residual and added back at the next step (error
feedback, Seide et al. 2014), which preserves convergence to first order.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.util import tree


class CompressionState(NamedTuple):
    residual: Any  # the grads' tree, float32 error carry


def init(params) -> CompressionState:
    return CompressionState(residual=tree.map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params))


def compress(grads, state: CompressionState):
    """Returns ((q int8, scales), new_state), ``q = round((g + r) / scale)``."""
    def one(g, r):
        gf = g.float() + r
        scale = torch.clamp(torch.max(torch.abs(gf)), min=1e-12) / gf.new_full((), 127.0)
        q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
        return q, scale, gf - q.float() * scale

    out = [one(g, r) for g, r in zip(tree.leaves(grads), tree.leaves(state.residual))]
    return ((tree.unflatten(grads, [o[0] for o in out]),
             tree.unflatten(grads, [o[1] for o in out])),
            CompressionState(residual=tree.unflatten(grads, [o[2] for o in out])))


def decompress(q_and_scales) -> Any:
    q, scales = q_and_scales
    return tree.map(lambda qq, s: qq.float() * s, q, scales)
