"""Kernel B6: the masked spike product ``s @ (w * c)`` on Hopper.

Counterpart of ``repro.kernels.spike_matmul`` (``_kernel`` /
``spike_matmul``). The CUDA source is ``csrc/spike_matmul.cu``; its plain
twin is :func:`repro_torch.kernels.ref.spike_matmul_ref`. The wrapper runs
the twin for tensors on the CPU and launches the kernel for tensors on the
card; anything else raises. ``launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import spike_matmul_ref

DTYPES = (torch.float32, torch.bfloat16)

launches = 0


def _check(s, w, c) -> None:
    """The operands the kernel takes: ``s`` (B, K), ``w`` and ``c`` (K, N),
    ``s`` f32 or bf16, ``w`` and ``c`` both f32 or both bf16, on one device."""
    if c is None:
        raise ValueError("spike_matmul needs the connection mask c")
    if s.dtype not in DTYPES or w.dtype not in DTYPES:
        raise TypeError(f"spike_matmul takes float32 or bfloat16 operands, got s {s.dtype}, "
                        f"w {w.dtype}")
    if c.dtype != w.dtype:
        raise TypeError(f"c must have w's dtype {w.dtype}, got {c.dtype}")
    if s.dim() != 2 or w.dim() != 2 or s.shape[1] != w.shape[0] or c.shape != w.shape:
        raise ValueError(f"shape mismatch: s{tuple(s.shape)} w{tuple(w.shape)} "
                         f"c{tuple(c.shape)}")
    if not (s.device == w.device == c.device):
        raise ValueError(f"s, w and c must share a device, got {s.device}, {w.device}, "
                         f"{c.device}")


def spike_matmul(s: torch.Tensor, w: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``(B, K) @ ((K, N) * (K, N)) -> (B, N)`` float32: the mask applied
    per element in the operand dtype, the product accumulated in f32."""
    _check(s, w, c)
    if s.device.type == "cpu":
        return spike_matmul_ref(s, w, c)
    if s.device.type != "cuda":
        raise ValueError(f"spike_matmul runs on cuda or cpu tensors, got {s.device}")
    return _launch(s, w, c)


def _launch(s, w, c) -> torch.Tensor:
    global launches
    B, K = s.shape
    N = w.shape[1]
    dev = s.device
    _build.expect(s, "s", s.dtype, (B, K), dev)
    _build.expect(w, "w", w.dtype, (K, N), dev)
    _build.expect(c, "c", w.dtype, (K, N), dev)
    out = torch.empty((B, N), dtype=torch.float32, device=dev)
    bf16 = torch.bfloat16
    err = _build.library().repro_spike_matmul(
        _build.ptr(s), _build.ptr(w), _build.ptr(c), _build.ptr(out), B, K, N,
        int(s.dtype == bf16), int(w.dtype == bf16), torch.cuda.current_stream(dev).cuda_stream)
    _build.check("spike_matmul", err)
    launches += 1
    return out
