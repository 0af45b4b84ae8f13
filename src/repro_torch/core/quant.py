"""u8 weight quantization -- the FPGA's integer datapath.

Counterpart of ``repro.core.quant``. The hardware stores synaptic weights
as integers in [0, 255] (paper §II.A) and thresholds as 8-bit registers;
this module maps trained float weights onto that grid so the register bank
holds exactly what the FPGA would.

Scheme: symmetric-positive affine, a shared f32 ``scale`` with
``w ~= q * scale``. ``torch.round`` rounds half to even, as ``jnp.round``
does, and every division is by the f32 ``scale``, so ``q`` is bitwise the
reference's on either device.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

WEIGHT_MAX = 255
THRESH_MAX = 255


class QuantizedWeights(NamedTuple):
    q: torch.Tensor       # uint8 weights
    scale: torch.Tensor   # 0-d float32: w ~= q * scale


def quantize_u8(w: torch.Tensor, w_max=None) -> QuantizedWeights:
    """Quantize non-negative float weights to u8 with a shared scale.

    ``w_max`` (a Python float or a 0-d tensor) fixes the grid; None takes
    ``max(w)``, floored at 1e-8."""
    w = torch.clamp_min(w, 0.0)
    if w_max is None:
        w_max = torch.clamp_min(w.max(), 1e-8)
    scale = torch.as_tensor(w_max / WEIGHT_MAX, dtype=torch.float32, device=w.device)
    q = torch.clamp(torch.round(w / scale), 0, WEIGHT_MAX).to(torch.uint8)
    return QuantizedWeights(q=q, scale=scale)


def dequantize_u8(qw: QuantizedWeights) -> torch.Tensor:
    return qw.q.to(torch.float32) * qw.scale


def quantize_signed(w: torch.Tensor) -> Tuple[QuantizedWeights, QuantizedWeights]:
    """Split a signed weight matrix into excitatory / inhibitory u8 banks
    with a shared scale, so the integer difference reproduces the signed sum."""
    w_max = torch.clamp_min(torch.abs(w).max(), 1e-8)
    pos = quantize_u8(torch.clamp_min(w, 0.0), w_max)
    neg = quantize_u8(torch.clamp_min(-w, 0.0), w_max)
    return pos, neg


def quantize_threshold(v_th: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Thresholds live on the same integer grid as the weights."""
    return torch.clamp(torch.round(v_th / scale), 1, THRESH_MAX).to(torch.uint8)


def integer_network(w: torch.Tensor, v_th: torch.Tensor):
    """Signed float net -> ``(w_int i32, th_int i32, scale)``: ``w_int =
    q_pos - q_neg``, the two-bank hardware sum, and thresholds on the shared
    scale."""
    pos, neg = quantize_signed(w)
    w_int = pos.q.to(torch.int32) - neg.q.to(torch.int32)
    th_int = quantize_threshold(v_th, pos.scale).to(torch.int32)
    return w_int, th_int, pos.scale
