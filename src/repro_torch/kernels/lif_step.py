"""Kernel B1: masked synaptic product + LIF step on Hopper.

Counterpart of ``repro.kernels.lif_step`` (``_fused_kernel`` /
``fused_lif_step``). The CUDA source is ``csrc/lif_step.cu``; its plain
twin is :func:`repro_torch.kernels.ref.fused_lif_step_ref`. The wrapper
runs the twin for tensors on the CPU and launches the kernel for tensors on
the card; anything else raises. ``launches`` counts kernel launches;
``last_plan`` is the :class:`repro_torch.kernels._plan.Plan` of the last
launch (which path filled the stages, the split, the tile) and
``last_launch`` its :class:`~repro_torch.kernels.launch_spec.KernelLaunch`
(:func:`lif_launch`), from which the C entry takes its plan.
"""
from __future__ import annotations

import functools
import math

import torch

from repro_torch.kernels import _build, _plan
from repro_torch.kernels.launch_spec import (IN, OUT, Alias, KernelLaunch, Operand,
                                             ring_schedule, slot_dim)
from repro_torch.kernels.ref import MODES, LIFStepOut, fused_lif_step_ref, write_gated

launches = 0
last_plan = None
last_launch = None
ROW_NAMES = ("v_th", "leak", "r_ref", "gain", "i_bias", "v_reset")


def product_operands(p: _plan.Plan, *, slotted_w: bool, drive: bool, slotted_rows: bool):
    """The operands B1 and B2 share: the weight planes of the masked product
    (``w``, and ``c`` when streamed) and the LIF epilogue's state and
    per-neuron rows, which only the cluster's rank-0 block reads
    (``csrc/masked_product.cuh``, ``lif_step.cu``, ``tick_fused.cu``)."""
    S, B, K, N = p.S, p.B, p.K, p.N
    bn = _plan.BLOCK_N

    def weights(block, rank, ex):
        z, _, n0, k0, k1, _ = _plan.block_tile(p, block)
        return [slot_dim(slotted_w, z) + ((k0, k1), (n0, n0 + bn))]

    def state(block, rank, ex):
        z, b0, n0, _, _, _ = _plan.block_tile(p, block)
        return [] if rank else [((z, z + 1), (b0, b0 + p.bb), (n0, n0 + bn))]

    def row(block, rank, ex):
        z, _, n0, _, _, _ = _plan.block_tile(p, block)
        return [] if rank else [slot_dim(slotted_rows, z) + ((n0, n0 + bn),)]

    wshape = ((S,) if slotted_w else ()) + (K, N)
    last = len(wshape) - 1
    ops = [Operand("w", wshape, "float32", IN, weights, (last,))]
    if p.has_c:
        ops.append(Operand("c", wshape, "float32", IN, weights, (last,)))
    ops += [Operand("v", (S, B, N), "float32", IN, state, (1, 2)),
            Operand("r", (S, B, N), "int32", IN, state, (1, 2))]
    if drive:
        ops.append(Operand("drive", (S, B, N), "float32", IN, state, (1, 2)))
    rshape = ((S,) if slotted_rows else ()) + (N,)
    ops += [Operand(name, rshape, "int32" if name == "r_ref" else "float32", IN, row,
                    (len(rshape) - 1,)) for name in ROW_NAMES]
    outs = [Operand(name, (S, B, N), dt, OUT, state, (1, 2))
            for name, dt in (("v_out", "float32"), ("r_out", "int32"), ("y_out", "float32"))]
    return ops, outs


def product_sums(p: _plan.Plan):
    """Each block's ``(output box, K range)``: its rank's range of K, added
    into the block's rows and columns of ``v_out``."""
    def sums(block, rank, ex):
        z, b0, n0, k0, k1, _ = _plan.block_tile(p, block)
        return [(((z, z + 1), (b0, b0 + p.bb), (n0, n0 + _plan.BLOCK_N)), (k0, k1))]
    return sums


def product_stages(p: _plan.Plan):
    """The copy ring's twin on the ``cp.async`` fill (none on the element
    fill, which loads each stage synchronously): :func:`ring_schedule` over
    the block's tiles of ``kt`` rows."""
    if p.path != "cp.async":
        return None, None

    def stages(block, rank, ex):
        _, _, _, k0, k1, _ = _plan.block_tile(p, block)
        n = math.ceil((k1 - k0) / p.kt) if k1 > k0 else 0
        return ring_schedule(n, p.stages), n
    return stages, lambda: ring_schedule(0, p.stages)


@functools.lru_cache(maxsize=512)
def lif_launch(p: _plan.Plan, *, slotted_w: bool = False, drive: bool = True,
               slotted_rows: bool = False, gate: str = "", out: bool = False) -> KernelLaunch:
    """The descriptor of one B1 launch (``csrc/lif_step.cu`` ``launch``): grid
    ``Plan.grid`` of 128 threads in clusters of ``ks`` along x, ``Plan.smem``
    bytes of dynamic shared memory. ``gate``: ``""`` (no ``run_if``),
    ``"shared"`` (0-d) or ``"slot"`` (``(S,)``); ``out``: the caller's
    buffers receive the result."""
    ins, outs = product_operands(p, slotted_w=slotted_w, drive=drive,
                                 slotted_rows=slotted_rows)
    ins.insert(0, Operand("s", (p.S, p.B, p.K), "float32", IN,
                          lambda block, rank, ex: [_s_box(p, block)], (1,)))
    if gate:
        shape = (p.S,) if gate == "slot" else ()
        ins.append(Operand("run_if", shape, "bool", IN,
                           lambda block, rank, ex: [((block[2], block[2] + 1),) if shape
                                                    else ()]))
    aliases = ()
    if out:
        aliases = (Alias("v", "v_out"), Alias("r", "r_out"), Alias("v", "y_out"))
    stages, quiet = product_stages(p)
    return KernelLaunch(
        name="lif_step", symbol="lif_step_kernel", grid=p.grid, block=(_plan.WARPS * 32, 1, 1),
        cluster=(p.ks, 1, 1), smem_dynamic=p.smem, operands=tuple(ins + outs),
        aliases=aliases, sums=product_sums(p), sums_of="v_out", sums_extent=p.K,
        stage_schedule=stages, quiet_schedule=quiet, plan_args=p.args(), plan=p)


def _s_box(p: _plan.Plan, block) -> tuple:
    z, b0, _, k0, k1, _ = _plan.block_tile(p, block)
    return ((z, z + 1), (b0, b0 + p.bb), (k0, k1))


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
        with _build.twin("lif_step"):
            got = fused_lif_step_ref(s, w, c, v, r, drive, v_th, leak, r_ref, gain,
                                     i_bias, v_reset, mode=mode)
            return write_gated(got, out, run_if)
    if v.device.type != "cuda":
        raise ValueError(f"fused_lif_step runs on cuda or cpu tensors, got {v.device}")
    return _launch(s, w, c, v, r, drive, (v_th, leak, r_ref, gain, i_bias, v_reset),
                   mode, run_if, out)


def _launch(s, w, c, v, r, drive, rows, mode, run_if, out) -> LIFStepOut:
    global launches, last_plan, last_launch
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
    desc = lif_launch(plan, slotted_w=w_slot != 0, drive=drive is not None,
                      slotted_rows=row_slot != 0,
                      gate="" if run_if is None else "slot" if gate_slot else "shared",
                      out=out is not None)
    err = _build.library().repro_lif_step(
        P(s), s.stride(0), P(w), w_slot, P(c), c_slot, P(v), P(r), P(drive),
        *(P(p) for p in rows), row_slot, P(v_out), P(r_out), P(y_out), P(run_if), gate_slot,
        S, B, K, N, MODES.index(mode), *desc.plan_args,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check("lif_step", err)
    launches += 1
    last_plan, last_launch = plan, desc
    if out is not None:
        return out
    if not slotted:
        v_out, r_out, y_out = v_out[0], r_out[0], y_out[0]
    return LIFStepOut(v=v_out, r=r_out, y=y_out)
