"""Correctly rounded float32 arithmetic that ``torch`` does not promise.

``torch.sqrt`` on a float32 CPU tensor is not correctly rounded on every
host: its vectorised kernels (AVX2 and AVX512 alike, and ``torch.pow(x,
0.5)`` with them) miss the nearest float32 root on some inputs, one ulp off
(about 17 % of draws at scale 1e-6 on one AVX512 host, 10 in 2^20 at scale
1), where ``numpy.sqrt`` and XLA's are IEEE. The optimizers' bitwise parity
with the reference rests on it, so they take the root here.
"""
from __future__ import annotations

import torch


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded square root of a float32 tensor (IEEE
    round-to-nearest-even), on any device.

    On the CPU the root is taken in float64 and rounded once to float32:
    a float64 root of a float32 input rounds to the float32 root exactly,
    since 53 >= 2 * 24 + 2 (no double rounding). On CUDA ``torch.sqrt`` is
    already IEEE (``sqrt.rn``; the port builds without fast math). Other
    dtypes go to ``torch.sqrt`` unchanged."""
    if x.dtype == torch.float32 and x.device.type == "cpu":
        return torch.sqrt(x.double()).float()
    return torch.sqrt(x)


def sqrt_rn_(x: torch.Tensor) -> torch.Tensor:
    """:func:`sqrt_rn` written into ``x`` (on the CPU through one float64
    copy of it); returns ``x``."""
    if x.dtype == torch.float32 and x.device.type == "cpu":
        return x.copy_(x.double().sqrt_())
    return x.sqrt_()
