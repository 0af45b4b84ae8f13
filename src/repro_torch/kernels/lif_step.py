"""Kernel B1: masked synaptic product + LIF step on Hopper.

Counterpart of ``repro.kernels.lif_step`` (``_fused_kernel`` /
``fused_lif_step``). The CUDA source is ``csrc/lif_step.cu``; its plain
twin is :func:`repro_torch.kernels.ref.fused_lif_step_ref`. The wrapper
runs the twin for tensors on the CPU and launches the kernel for tensors on
the card; anything else raises. ``launches`` counts kernel launches;
``last_plan`` is the :class:`repro_torch.kernels._plan.Plan` of the last
launch (which path filled the stages, the split, the tile).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, _plan
from repro_torch.kernels.ref import MODES, LIFStepOut, fused_lif_step_ref, write_gated

launches = 0
last_plan = None


def fused_lif_step(s, w, c, v, r, drive, v_th, leak, r_ref, gain, i_bias, v_reset,
                   *, mode: str = "fixed_leak", run_if=None, out=None) -> LIFStepOut:
    """One fused tick: ``(v', r', y')`` from ``s @ (w*c)`` (+ drive).

    Shapes: ``s`` (B, K) and ``v``, ``r``, ``drive`` (B, N) for one network,
    or each with a leading slot axis S; ``w``, ``c`` (K, N), or (S, K, N)
    per slot; the six per-neuron rows (N,) or (S, N). ``drive`` may be None,
    and so may ``c`` when ``w`` is the premasked ``W*C``. f32 everywhere
    except int32 ``r`` and ``r_ref``. No padding: the kernel bounds-checks
    its ragged edges.

    ``s`` holds spikes, 0 or 1: the kernel adds each term as one fused
    multiply-add, which rounds as ``acc + s * (w*c)`` only for such ``s``
    (for any other value it rounds once where the twin rounds twice).

    ``out`` (a :class:`LIFStepOut` of buffers shaped like ``v``, ``r``,
    ``v``) receives the result instead of fresh tensors. ``run_if``, a bool
    tensor on the device, 0-d or one per slot ``(S,)``, gates the launch:
    where a slot's flag is False the kernel writes nothing of that slot and
    ``out`` (which must then be given) keeps what it held -- the event
    backend's dense arm, paired with the event kernel's ``skip`` gate on the
    same flags.
    """
    if mode not in MODES:
        raise ValueError(f"the lif_step kernel supports {MODES}, got {mode!r}")
    if run_if is not None and out is None:
        raise ValueError("run_if needs out: a closed gate leaves the outputs as they were")
    if v.device.type == "cpu":
        got = fused_lif_step_ref(s, w, c, v, r, drive, v_th, leak, r_ref, gain,
                                 i_bias, v_reset, mode=mode)
        return write_gated(got, out, run_if)
    if v.device.type != "cuda":
        raise ValueError(f"fused_lif_step runs on cuda or cpu tensors, got {v.device}")
    return _launch(s, w, c, v, r, drive, (v_th, leak, r_ref, gain, i_bias, v_reset),
                   mode, run_if, out)


def _launch(s, w, c, v, r, drive, rows, mode, run_if, out) -> LIFStepOut:
    global launches, last_plan
    slotted = v.dim() == 3
    if not slotted:
        s, v, r = s.unsqueeze(0), v.unsqueeze(0), r.unsqueeze(0)
        drive = None if drive is None else drive.unsqueeze(0)
    S, B, K = s.shape
    N = v.shape[-1]
    dev, f32, i32 = v.device, torch.float32, torch.int32
    _build.expect(s, "s", f32, (S, B, K), dev)
    _build.expect(v, "v", f32, (S, B, N), dev)
    _build.expect(r, "r", i32, (S, B, N), dev)
    if drive is not None:
        _build.expect(drive, "drive", f32, (S, B, N), dev)
    w_slot = _build.expect_slotted(w, "w", f32, (K, N), S, dev)
    c_slot = 0 if c is None else _build.expect_slotted(c, "c", f32, (K, N), S, dev)
    row_slot = _build.expect_rows(rows, N, S, dev)
    gate_slot = 0
    if run_if is not None:
        gate_slot = _build.expect_slotted(run_if, "run_if", torch.bool, (), S, dev)
    v_out, r_out, y_out = _build.outputs(out, v, r, slotted)
    P = _build.ptr
    plan = _plan.plan(S, B, K, N, has_c=c is not None, sms=_build.sm_count(dev),
                      is_aligned=_plan.aligned((P(s), P(w), P(c) or 0),
                                               (s.stride(0), K, w_slot, c_slot)))
    err = _build.library().repro_lif_step(
        P(s), s.stride(0), P(w), w_slot, P(c), c_slot, P(v), P(r), P(drive),
        *(P(p) for p in rows), row_slot, P(v_out), P(r_out), P(y_out), P(run_if), gate_slot,
        S, B, K, N, MODES.index(mode), *plan.args(),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check("lif_step", err)
    launches += 1
    last_plan = plan
    if out is not None:
        return out
    if not slotted:
        v_out, r_out, y_out = v_out[0], r_out[0], y_out[0]
    return LIFStepOut(v=v_out, r=r_out, y=y_out)
