"""Kernel B6: the masked spike product ``s @ (w * c)`` on Hopper.

Counterpart of ``repro.kernels.spike_matmul`` (``_kernel`` /
``spike_matmul``). The CUDA source is ``csrc/spike_matmul.cu``; its plain
twin is :func:`repro_torch.kernels.ref.spike_matmul_ref`. The wrapper runs
the twin for tensors on the CPU and launches the kernel for tensors on the
card; anything else raises. ``launches`` counts kernel launches;
``last_plan`` is the :class:`repro_torch.kernels._stream.MatmulPlan` of the
last launch (stream-K split or tile path, fill, workspace).

The stream-K split's arrival counters live here, one int32 buffer per
device and stream, zeroed once when it is made or grown: every launch
leaves them at 0 again, so no launch needs a memset. Launches that share a
stream run in order and so never share the counters at once.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, _stream
from repro_torch.kernels.ref import spike_matmul_ref

DTYPES = (torch.float32, torch.bfloat16)

launches = 0
last_plan = None
_counters = {}


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


def _counter_buffer(dev, stream: int, n: int) -> torch.Tensor:
    """At least ``n`` zeroed int32 counters for launches on this stream."""
    key = (dev, stream)
    buf = _counters.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=dev)
        _counters[key] = buf
    return buf


def _launch(s, w, c) -> torch.Tensor:
    global launches, last_plan
    B, K = s.shape
    N = w.shape[1]
    dev = s.device
    _build.expect(s, "s", s.dtype, (B, K), dev)
    _build.expect(w, "w", w.dtype, (K, N), dev)
    _build.expect(c, "c", w.dtype, (K, N), dev)
    P = _build.ptr
    plan = _stream.spike_matmul_plan(B, K, N, s_bytes=s.element_size(),
                                     w_bytes=w.element_size(),
                                     is_aligned=_stream.aligned16((P(s), P(w), P(c))),
                                     sms=_build.sm_count(dev))
    stream = torch.cuda.current_stream(dev).cuda_stream
    out = torch.empty((B, N), dtype=torch.float32, device=dev)
    ws = counters = None
    if plan.path == "stream-k":
        ws = torch.empty(plan.ws_floats, dtype=torch.float32, device=dev)
        counters = _counter_buffer(dev, stream, plan.counters)
    bf16 = torch.bfloat16
    err = _build.library().repro_spike_matmul(
        P(s), P(w), P(c), P(out), P(ws), P(counters), B, K, N,
        int(s.dtype == bf16), int(w.dtype == bf16), *plan.args(), stream)
    _build.check("spike_matmul", err)
    launches += 1
    last_plan = plan
    return out
