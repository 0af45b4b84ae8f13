"""Kernels B3 and B4: the event tick (spike-list gather + LIF step) on Hopper.

Counterpart of ``repro.kernels.event_dispatch``: :func:`event_lif_dispatch_db`
is kernel B3 (``_event_db_kernel``, the default), which walks only the live
prefix of each row's spike list, one block per batch row; :func:`event_lif_dispatch`
is kernel B4 (``_event_kernel``), which walks every slot, the empty ones on
the all-zero sentinel row, and reads each distinct listed row once for a
group of up to 16 batch rows (its plan: :mod:`repro_torch.kernels._event_plan`).
Both are ``csrc/event_dispatch.cu``; their plain twin is
:func:`repro_torch.kernels.ref.event_lif_dispatch_ref`, which both equal
bitwise on any weights. A wrapper runs the twin for tensors on the CPU and
launches the kernel for tensors on the card; anything else raises.
``launches_db`` (B3) and ``launches`` (B4) count kernel launches;
``last_plan`` is the :class:`~repro_torch.kernels._event_plan.EventPlan` of
B4's last launch.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, _event_plan, _stream
from repro_torch.kernels.ref import MODES, LIFStepOut, event_lif_dispatch_ref, write_gated

launches = 0      # kernel B4 (walk every slot)
launches_db = 0   # kernel B3 (walk the live slots)
last_plan = None  # B4's


def event_lif_dispatch_db(idx, w, v, r, drive, v_th, leak, r_ref, gain, i_bias, v_reset,
                          *, counts, mode: str = "fixed_leak", skip=None,
                          out=None) -> LIFStepOut:
    """Kernel B3: ``(v', r', y')`` from the sum of rows ``idx[b, :counts[b]]``
    of ``w`` (+ drive), in ascending slot order, then the LIF epilogue.

    Shapes: ``idx`` (B, k) int32 spike ids (ascending, then the sentinel),
    ``counts`` (B,) int32 live slots, ``v``, ``r``, ``drive`` (B, N) -- or
    each with a leading slot axis S; ``w`` the premasked ``W*C`` (K, N) or
    (S, K, N), which may also carry the sentinel row (never read here); the
    six per-neuron rows (N,) or (S, N). ``drive`` may be None.

    ``skip``, a bool tensor on the device, 0-d or one per slot ``(S,)``,
    gates the launch: where a slot's flag is True the kernel writes nothing
    of that slot and ``out`` (which must then be given) keeps what it held --
    the event tick's half of the device-side choice between this kernel and
    the dense kernel B1 (``run_if`` on the same flags).
    """
    return _dispatch(idx, counts, w, v, r, drive, (v_th, leak, r_ref, gain, i_bias, v_reset),
                     mode, skip, out, "live")


def event_lif_dispatch(idx, w, v, r, drive, v_th, leak, r_ref, gain, i_bias, v_reset, *,
                       mode: str = "fixed_leak", skip=None, out=None) -> LIFStepOut:
    """Kernel B4: as :func:`event_lif_dispatch_db`, but every one of the ``k``
    slots is added, so ``w`` must be ``(K+1, N)`` (or per slot) with the
    all-zero sentinel row at ``K``, where the empty slots point.

    The lists need not ascend nor be distinct: a row whose ids ascend is
    served from the rows its group shares, one that does not adds its slots
    one by one, both in slot order."""
    return _dispatch(idx, None, w, v, r, drive, (v_th, leak, r_ref, gain, i_bias, v_reset),
                     mode, skip, out, "all")


def _dispatch(idx, counts, w, v, r, drive, rows, mode, skip, out, walk) -> LIFStepOut:
    if mode not in MODES:
        raise ValueError(f"the event dispatch kernels support {MODES}, got {mode!r}")
    if skip is not None and out is None:
        raise ValueError("skip needs out: a skipped launch leaves the outputs as they were")
    if v.device.type == "cpu":
        if counts is None:
            counts = torch.full(idx.shape[:-1], idx.shape[-1], dtype=torch.int32)
        got = event_lif_dispatch_ref(idx, counts, w, v, r, drive, *rows, mode=mode,
                                     walk=walk)
        return write_gated(got, out, None if skip is None else ~skip)
    if v.device.type != "cuda":
        raise ValueError(f"event dispatch runs on cuda or cpu tensors, got {v.device}")
    return _launch(idx, counts, w, v, r, drive, rows, mode, skip, out)


def _launch(idx, counts, w, v, r, drive, rows, mode, skip, out) -> LIFStepOut:
    global launches, launches_db, last_plan
    slotted = v.dim() == 3
    if not slotted:
        idx, v, r = idx.unsqueeze(0), v.unsqueeze(0), r.unsqueeze(0)
        counts = None if counts is None else counts.unsqueeze(0)
        drive = None if drive is None else drive.unsqueeze(0)
    S, B, N = v.shape
    k = idx.shape[-1]
    Kw = w.shape[-2]
    dev, f32, i32 = v.device, torch.float32, torch.int32
    _build.expect(idx, "idx", i32, (S, B, k), dev)
    if counts is not None:
        _build.expect(counts, "counts", i32, (S, B), dev)
    _build.expect(v, "v", f32, (S, B, N), dev)
    _build.expect(r, "r", i32, (S, B, N), dev)
    if drive is not None:
        _build.expect(drive, "drive", f32, (S, B, N), dev)
    w_slot = _build.expect_slotted(w, "w", f32, (Kw, N), S, dev)
    row_slot = _build.expect_rows(rows, N, S, dev)
    gate_slot = 0
    if skip is not None:
        gate_slot = _build.expect_slotted(skip, "skip", torch.bool, (), S, dev)
    v_out, r_out, y_out = _build.outputs(out, v, r, slotted)
    P = _build.ptr
    plan = None
    if counts is None:
        plan = _event_plan.event_plan(S, B, k, N, Kw, w_slot=w_slot,
                                      is_aligned=_stream.aligned16([P(w)]))
    err = _build.library().repro_event_dispatch(
        P(idx), P(counts), k, P(w), w_slot, Kw, P(v), P(r), P(drive),
        *(P(p) for p in rows), row_slot, P(v_out), P(r_out), P(y_out), P(skip), gate_slot,
        S, B, N, MODES.index(mode), *(plan.args() if plan else (0,) * 6),
        torch.cuda.current_stream(dev).cuda_stream)
    name = "event_dispatch" if counts is None else "event_dispatch_db"
    _build.check(name, err)
    if counts is None:
        launches += 1
        last_plan = plan
    else:
        launches_db += 1
    if out is not None:
        return out
    if not slotted:
        v_out, r_out, y_out = v_out[0], r_out[0], y_out[0]
    return LIFStepOut(v=v_out, r=r_out, y=y_out)
