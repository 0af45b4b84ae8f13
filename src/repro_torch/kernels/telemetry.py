"""The telemetry kernel: one tick folded into :class:`TickTelemetry`.

The port's own kernel (``csrc/telemetry.cu``): the reference folds a tick in
with one XLA reduce in ``repro.obs.telemetry.TickTelemetry.accumulate``, not
a Pallas kernel. Its plain twin is that method's counterpart,
:meth:`repro_torch.obs.telemetry.TickTelemetry.accumulate`. The wrapper runs
the twin for tensors on the CPU and launches the kernel for tensors on the
card; anything else raises. Either way the accumulators are updated in
their buffers; the kernel takes them as the one buffer that
:meth:`TickTelemetry.zeros` and ``clone`` make. ``launches`` counts kernel
launches; ``last_launch`` is the
:class:`~repro_torch.kernels.launch_spec.KernelLaunch` of the last one
(:func:`telemetry_launch`).
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from repro_torch.core.lif import LIFState
from repro_torch.kernels import _build
from repro_torch.kernels.launch_spec import IN, OUT, Alias, KernelLaunch, Operand
from repro_torch.obs.telemetry import FIELDS, TickTelemetry

launches = 0
last_launch = None
THREADS = 1024      # csrc/telemetry.cu kThreads: a block per row of the state
# its static shared memory: float red[5][kWarps] and int cnt[kWarps]
STATIC_SMEM = 6 * (THREADS // 32) * 4


@functools.lru_cache(maxsize=512)
def telemetry_launch(rows: int, n: int, *, y_int: bool = False, v_int: bool = False,
                     over: int = 0, dense: int = 0, dw: int = 0,
                     parts: int = 0) -> KernelLaunch:
    """The descriptor of one telemetry launch (``csrc/telemetry.cu``
    ``repro_telemetry``): ``rows`` blocks of 1024 threads, each folding one
    row of the ``(rows, n)`` state into its column of the ``(9, rows)``
    accumulators in place. ``over``, ``dense``, ``dw``: the networks the
    flags and the dw partials are given for (0: absent); ``parts``: the dw
    partials per network."""
    def row(block, rank, ex):
        return [((block[0], block[0] + 1), (0, n))]

    def flag(groups):
        return lambda block, rank, ex: [((block[0] // (rows // groups),
                                          block[0] // (rows // groups) + 1),)]

    def acc(block, rank, ex):
        return [((0, len(FIELDS)), (block[0], block[0] + 1))]

    ins = [Operand("y", (rows, n), "int32" if y_int else "float32", IN, row),
           Operand("v", (rows, n), "int32" if v_int else "float32", IN, row),
           Operand("r", (rows, n), "int32", IN, row),
           Operand("acc", (len(FIELDS), rows), "int32", IN, acc)]
    if over:
        ins.append(Operand("over", (over,), "bool", IN, flag(over)))
    if dense:
        ins.append(Operand("take_dense", (dense,), "bool", IN, flag(dense)))
    if dw:
        g = flag(dw)
        ins.append(Operand("dw_stats", (dw, parts, 2), "float32", IN,
                           lambda block, rank, ex: [g(block, rank, ex)[0] + ((0, parts),
                                                                            (0, 2))]))
    return KernelLaunch(
        name="telemetry", symbol="telemetry_kernel", grid=(rows, 1, 1), block=(THREADS, 1, 1),
        smem_static=STATIC_SMEM,
        operands=tuple(ins) + (Operand("acc_out", (len(FIELDS), rows), "int32", OUT, acc),),
        aliases=(Alias("acc", "acc_out", shared=True),))


def tick_telemetry(telem: TickTelemetry, y: torch.Tensor, v: torch.Tensor, r: torch.Tensor, *,
                   over: Optional[torch.Tensor] = None,
                   take_dense: Optional[torch.Tensor] = None,
                   dw_stats: Optional[torch.Tensor] = None) -> TickTelemetry:
    """Fold one tick's post-tick state into ``telem``, in place; returns it.

    Args:
      y, v, r: the post-tick spikes, potentials and refractory counters,
        ``(*batch, n)`` with ``telem``'s batch shape (f32, or int32 ``y`` and
        ``v`` on the int datapath; int32 ``r``).
      over: the event backend's overflow flag per network, a device bool,
        0-d or ``(G,)`` over the leading rows (the slot axis): 1 more
        ``overflow`` tick where set. None on every other path.
      take_dense: the adaptive knee's gate per network (same shapes): 1 more
        ``policy_dense`` tick where it is set and ``over`` is not.
      dw_stats: ``(G, P, 2)`` partial sums of ``|dw|`` and ``dw^2`` of the
        committed weight update per weight group (kernel B5's per-block
        partials, or one per group from the plain pass); each group's total
        is added to its rows' ``dw_l1`` and ``dw_sq``.
    """
    if y.device.type == "cpu":
        with _build.twin("telemetry"):
            over_inc = None if over is None else over.to(torch.int32)
            policy_inc = None
            if take_dense is not None:
                gate = take_dense if over is None else take_dense & ~over
                policy_inc = gate.to(torch.int32)
            new = telem.accumulate(LIFState(v=v, r=r, y=y), overflow_inc=over_inc,
                                   policy_inc=policy_inc, dw_stats=dw_stats)
            return telem.copy_(new)
    if y.device.type != "cuda":
        raise ValueError(f"tick_telemetry runs on cuda or cpu tensors, got {y.device}")
    return _launch(telem, y, v, r, over, take_dense, dw_stats)


_STATE = (torch.float32, torch.int32)


def _rows_per(operand: Optional[torch.Tensor], rows: int, name: str, dev) -> int:
    """Rows that share one entry of a per-network operand (0 when absent)."""
    if operand is None:
        return 0
    groups = operand.shape[0] if operand.dim() else 1
    if rows % groups or operand.device != dev or not operand.is_contiguous():
        raise ValueError(f"{name}: {groups} networks on {operand.device} must divide the "
                         f"{rows} rows on {dev}, contiguous")
    return rows // groups


def _launch(telem, y, v, r, over, take_dense, dw_stats) -> TickTelemetry:
    # This runs every tick on the host, where eager rollouts spend their time,
    # so the checks are one expression over the state and one over the
    # accumulators' buffer.
    global launches, last_launch
    n = y.shape[-1]
    rows = y.numel() // n
    dev = y.device
    if not (y.shape == v.shape == r.shape and y.dtype in _STATE and v.dtype in _STATE
            and r.dtype == torch.int32 and v.device == dev and r.device == dev
            and y.is_contiguous() and v.is_contiguous() and r.is_contiguous()):
        raise ValueError(f"y, v, r: expected contiguous tensors of one shape on {dev}, y and "
                         f"v in {_STATE} and r int32; got {y.dtype}{tuple(y.shape)}, "
                         f"{v.dtype}{tuple(v.shape)}, {r.dtype}{tuple(r.shape)}")
    buf = telem.buf
    if (buf is None or buf.dtype != torch.int32 or buf.shape[1:] != y.shape[:-1]
            or buf.shape[0] != len(FIELDS) or buf.device != dev or not buf.is_contiguous()):
        raise ValueError("the kernel folds into accumulators in one buffer "
                         "(TickTelemetry.zeros or clone) of the state's batch shape on "
                         f"{dev}")
    if (over is not None and over.dtype != torch.bool) or (
            take_dense is not None and take_dense.dtype != torch.bool):
        raise TypeError("over, take_dense: expected torch.bool flags")
    parts = 0
    if dw_stats is not None:
        if dw_stats.dim() != 3 or dw_stats.shape[-1] != 2 or dw_stats.dtype != torch.float32:
            raise ValueError(f"dw_stats: expected (G, P, 2) float32, got {dw_stats.dtype} "
                             f"{tuple(dw_stats.shape)}")
        parts = dw_stats.shape[1]
    P = _build.ptr
    groups = lambda t: 0 if t is None else (t.shape[0] if t.dim() else 1)
    desc = telemetry_launch(rows, n, y_int=y.dtype == torch.int32,
                            v_int=v.dtype == torch.int32, over=groups(over),
                            dense=groups(take_dense), dw=groups(dw_stats), parts=parts)
    err = _build.library().repro_telemetry(
        y.data_ptr(), y.dtype == torch.int32, v.data_ptr(), v.dtype == torch.int32,
        r.data_ptr(), rows, n,
        P(over), 0 if over is None else _rows_per(over, rows, "over", dev),
        P(take_dense), 0 if take_dense is None else _rows_per(take_dense, rows, "take_dense",
                                                             dev),
        P(dw_stats), 0 if dw_stats is None else _rows_per(dw_stats, rows, "dw_stats", dev),
        parts, buf.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _build.check("telemetry", err)
    launches += 1
    last_launch = desc
    return telem
