"""Device resolution for the port's entry points.

``device=None`` means the CUDA card. Without a card the entry point
raises; it never falls back to the CPU silently. Only an explicit
``"cpu"`` runs on the host, which is how the parity tests run.

Resolving a CUDA device also pins every float32 matrix product to full
float32: TF32 keeps about three decimal digits, and the port's bitwise
parity on the u8 weight grid rests on exact f32 sums.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def pin_full_f32() -> None:
    """Turn TF32 off for cuBLAS and cuDNN float32 products."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``; raise when a CUDA device is asked for and no
    NVIDIA GPU is visible."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no NVIDIA GPU is visible (torch.cuda.is_available() is "
                "False): pass device='cpu' to run on the host explicitly")
        pin_full_f32()
    return dev
