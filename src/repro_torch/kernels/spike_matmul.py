"""Kernel B6: the masked spike product ``s @ (w * c)`` on Hopper.

Counterpart of ``repro.kernels.spike_matmul`` (``_kernel`` /
``spike_matmul``). The CUDA source is ``csrc/spike_matmul.cu``; its plain
twin is :func:`repro_torch.kernels.ref.spike_matmul_ref`. The wrapper runs
the twin for tensors on the CPU and launches the kernel for tensors on the
card; anything else raises. ``launches`` counts kernel launches;
``last_plan`` is the :class:`repro_torch.kernels._stream.MatmulPlan` of the
last launch (stream-K split or tile path, fill, workspace) and
``last_launch`` its :class:`~repro_torch.kernels.launch_spec.KernelLaunch`
(:func:`matmul_launch`), from which the C entry takes its plan.

The stream-K split's arrival counters live here, one int32 buffer per
device and stream, zeroed once when it is made or grown: every launch
leaves them at 0 again, so no launch needs a memset. Launches that share a
stream run in order and so never share the counters at once.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import _build, _stream
from repro_torch.kernels.launch_spec import (IN, OUT, SCRATCH, KernelLaunch, Operand,
                                             flat_boxes, ring_schedule)
from repro_torch.kernels.ref import spike_matmul_ref

DTYPES = (torch.float32, torch.bfloat16)

launches = 0
last_plan = None
last_launch = None
_counters = {}
# csrc/spike_matmul.cu's small path stages w * c and its spike rows in static
# shared memory: float wc[kSmallWeights], rows[kSmallSpikes].
SMALL_SMEM = 4 * (_stream.B6_SMALL + _stream.B6_SMALL_SPIKES)


@functools.lru_cache(maxsize=512)
def matmul_launch(p: _stream.MatmulPlan) -> KernelLaunch:
    """The descriptor of one B6 launch (``csrc/spike_matmul.cu`` ``launch``):
    on the small path ``ceil(B * N / 256)`` blocks of 256 threads, one
    output each, with w * c and the spike rows in static shared memory;
    otherwise ``MatmulPlan.blocks`` blocks of 256 threads with
    ``MatmulPlan.smem`` bytes of dynamic shared memory, each taking its run
    of units (:meth:`MatmulPlan.segments`). A tile that one block covers
    whole it writes itself; a tile two or more blocks share is written once,
    by the last of them to arrive on the tile's counter: the lint charges
    that write to the block holding the tile's last K tile. Tensor-map tiles
    past the matrix arrive as zeros, so the tiles' rows and columns are
    bounds-checked."""
    B, K, N, kt, rows, bn = p.B, p.K, p.N, p.kt, _stream.ROWS, _stream.BLOCK_N
    sdt = "bfloat16" if p.s_bytes == 2 else "float32"
    wdt = "bfloat16" if p.w_bytes == 2 else "float32"
    threads = _stream.THREADS
    if p.path == "small":
        def outputs(block):
            lo = block[0] * threads
            return lo, min(B * N, lo + threads)

        def spikes(block, rank, ex):
            lo, hi = outputs(block)
            return [((lo // N, (hi - 1) // N + 1), (0, K))]

        def out(block, rank, ex):
            return flat_boxes(*outputs(block), N)

        def sums(block, rank, ex):
            return [(box, (0, K)) for box in out(block, rank, ex)]

        whole = lambda block, rank, ex: [((0, K), (0, N))]
        ops = (Operand("s", (B, K), sdt, IN, spikes), Operand("w", (K, N), wdt, IN, whole),
               Operand("c", (K, N), wdt, IN, whole), Operand("out", (B, N), "float32", OUT, out))
        return KernelLaunch(
            name="spike_matmul", symbol="spike_matmul_small_kernel", grid=(p.blocks, 1, 1),
            block=(threads, 1, 1), smem_static=SMALL_SMEM, operands=ops, sums=sums,
            sums_of="out", sums_extent=K, plan_args=p.args(), plan=p)

    def segs(block):
        for tile, k0, k1 in p.segments(block[0]):
            g, j = divmod(tile, p.col_tiles)
            yield tile, g * rows, j * bn, k0 * kt, min(K, k1 * kt), k1 == p.k_tiles

    def spikes(block, rank, ex):
        return [((b0, b0 + rows), (k0, k1)) for _, b0, _, k0, k1, _ in segs(block)]

    def weights(block, rank, ex):
        return [((k0, k1), (n0, n0 + bn)) for _, _, n0, k0, k1, _ in segs(block)]

    def out(block, rank, ex):
        return [((b0, b0 + rows), (n0, n0 + bn)) for _, b0, n0, _, _, last in segs(block)
                if last]

    def sums(block, rank, ex):
        return [(((b0, b0 + rows), (n0, n0 + bn)), (k0, k1))
                for _, b0, n0, k0, k1, _ in segs(block)]

    ops = [Operand("s", (B, K), sdt, IN, spikes, (0, 1)),
           Operand("w", (K, N), wdt, IN, weights, (0, 1)),
           Operand("c", (K, N), wdt, IN, weights, (0, 1)),
           Operand("out", (B, N), "float32", OUT, out, (0, 1))]
    if p.path == "stream-k":
        tile = rows * bn

        def workspace(block, rank, ex):
            # a shared tile's partial: slot 0 for the block's first tile, 1 for its last
            q = block[0]
            slots = [2 * q + (0 if p.begin(q) >= t * p.k_tiles else 1)
                     for t, _, _ in p.segments(q) if len(p.contributors(t)) > 1]
            return [((s * tile, (s + 1) * tile),) for s in slots]

        ops += [Operand("ws", (p.ws_floats,), "float32", SCRATCH, workspace),
                Operand("counters", (p.counters,), "int32", SCRATCH,
                        lambda block, rank, ex: [((t, t + 1),) for t, _, _ in
                                                 p.segments(block[0])
                                                 if len(p.contributors(t)) > 1])]
    tma = p.fill == "tma"
    n_units = lambda block: p.begin(block[0] + 1) - p.begin(block[0])
    per_sm = max(1, min(_stream.MAX_BLOCKS_PER_SM,
                        _stream.SM_SMEM // (p.smem + _stream.BLOCK_RESERVE)))
    return KernelLaunch(
        name="spike_matmul", symbol="spike_matmul_kernel", grid=(p.blocks, 1, 1),
        block=(threads, 1, 1), smem_dynamic=p.smem, blocks_per_sm=per_sm,
        operands=tuple(ops), sums=sums, sums_of="out", sums_extent=K,
        stage_schedule=((lambda block, rank, ex: (ring_schedule(n_units(block), p.stages),
                                                  n_units(block))) if tma else None),
        quiet_schedule=(lambda: ring_schedule(0, p.stages)) if tma else None,
        plan_args=p.args(), plan=p)


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
        with _build.twin("spike_matmul"):
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
    global launches, last_plan, last_launch
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
    desc = matmul_launch(plan)
    stream = torch.cuda.current_stream(dev).cuda_stream
    out = torch.empty((B, N), dtype=torch.float32, device=dev)
    ws = counters = None
    if plan.path == "stream-k":
        ws = torch.empty(plan.ws_floats, dtype=torch.float32, device=dev)
        counters = _counter_buffer(dev, stream, plan.counters)
    bf16 = torch.bfloat16
    err = _build.library().repro_spike_matmul(
        P(s), P(w), P(c), P(out), P(ws), P(counters), B, K, N,
        int(s.dtype == bf16), int(w.dtype == bf16), *desc.plan_args, stream)
    _build.check("spike_matmul", err)
    launches += 1
    last_plan, last_launch = plan, desc
    return out
