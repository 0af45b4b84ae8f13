"""Kernel B2: the whole network tick in one launch on Hopper.

Counterpart of ``repro.kernels.tick_fused`` (``_tick_kernel`` /
``fused_tick``). The CUDA source is ``csrc/tick_fused.cu``; its plain twin
is :func:`repro_torch.kernels.ref.fused_tick_ref`, with the same signature.
The wrapper runs the twin for tensors on the CPU and launches the kernel for
tensors on the card; anything else raises. ``launches`` counts kernel
launches; ``last_plan`` is the :class:`repro_torch.kernels._plan.Plan` of the
last launch (which path filled the stages, the split, the tile) and
``last_launch`` its :class:`~repro_torch.kernels.launch_spec.KernelLaunch`
(:func:`tick_launch`), from which the C entry takes its plan.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import _build, _plan
from repro_torch.kernels.launch_spec import IN, OUT, Alias, KernelLaunch, Operand
from repro_torch.kernels.lif_step import product_operands, product_stages, product_sums
from repro_torch.kernels.ref import MODES, check_ring, fused_tick_ref

launches = 0
last_plan = None
last_launch = None
RINGS = ("", "in_place", "separate")


def ring_slots(n_ring: int) -> tuple:
    """Every ``(read plane, write plane)`` pair a tick gives the kernel:
    ``[tick % D, (tick + 1) % D]`` (``ops.fused_tick``), one per tick of the
    ring's period."""
    D = max(1, n_ring)
    return tuple((t % D, (t + 1) % D) for t in range(D))


@functools.lru_cache(maxsize=512)
def tick_launch(p: _plan.Plan, *, n_read: int = 1, delays: bool = False, ring: str = "",
                n_ring: int = 0, slotted_w: bool = False, drive: bool = True,
                slotted_rows: bool = False, examples=None) -> KernelLaunch:
    """The descriptor of one B2 launch (``csrc/tick_fused.cu`` ``launch``): the
    grid, block, cluster and shared memory of B1's product, plus the spike
    history and the ring. ``ring``: ``""`` (no ring write), ``"in_place"``
    (the ring is the history read, its write plane written in it) or
    ``"separate"`` (the ring read in full and written whole to another
    buffer). ``examples``: the ``(read plane, write plane)`` pairs to lint at
    (default: every pair of the ring's period, :func:`ring_slots`)."""
    if ring not in RINGS:
        raise ValueError(f"ring must be one of {RINGS}, got {ring!r}")
    S, B, K, N, bb, bn = p.S, p.B, p.K, p.N, p.bb, _plan.BLOCK_N
    ins, outs = product_operands(p, slotted_w=slotted_w, drive=drive,
                                 slotted_rows=slotted_rows)

    def history(block, rank, ex):
        z, b0, _, k0, k1, _ = _plan.block_tile(p, block)
        planes = (0, n_read) if delays else (ex[0], ex[0] + 1)
        return [((z, z + 1), (b0, b0 + bb), planes, (k0, k1))]

    def planes(block, rank, ex, keep):
        z, b0, n0, _, _, _ = _plan.block_tile(p, block)
        if rank:
            return []
        return [((z, z + 1), (b0, b0 + bb), (j, j + 1), (n0, n0 + bn))
                for j in range(n_ring) if keep(j, ex[1])]

    wshape = ((S,) if slotted_w else ()) + (K, N)
    ins = [Operand("slots", (2,), "int32", IN, lambda block, rank, ex: [((0, 2),)]),
           Operand("dly_read", (S, B, n_read, K), "float32", IN, history, (1,))] + ins
    if delays:
        ins.insert(4 if p.has_c else 3, Operand(
            "delays", wshape, "int32", IN, ins[2].footprint, (len(wshape) - 1,)))
    aliases = ()
    if ring:
        shape = (S, B, n_ring, N)
        outs.append(Operand("ring_out", shape, "float32", OUT,
                            lambda block, rank, ex: planes(
                                block, rank, ex, (lambda j, ws: j == ws) if ring == "in_place"
                                else (lambda j, ws: True)), (1, 3)))
        if ring == "in_place":
            aliases = (Alias("dly_read", "ring_out", shared=True),)
        else:
            ins.append(Operand("ring_in", shape, "float32", IN,
                               lambda block, rank, ex: planes(block, rank, ex,
                                                              lambda j, ws: j != ws), (1, 3)))
            aliases = (Alias("ring_in", "ring_out"),)
    stages, quiet = product_stages(p)
    return KernelLaunch(
        name="tick_fused", symbol="tick_fused_kernel", grid=p.grid,
        block=(_plan.WARPS * 32, 1, 1), cluster=(p.ks, 1, 1), smem_dynamic=p.smem,
        operands=tuple(ins + outs), aliases=aliases,
        examples=tuple(examples) if examples else ring_slots(n_ring), sums=product_sums(p),
        sums_of="v_out", sums_extent=K, stage_schedule=stages, quiet_schedule=quiet,
        plan_args=p.args(), plan=p)


def fused_tick(slots, dly_read, w, c, delays, v, r, drive, dly_full,
               v_th, leak, r_ref, gain, i_bias, v_reset, *,
               mode: str = "fixed_leak", dly_out=None):
    """One whole tick: ring read, masked product, LIF epilogue, ring write.

    Shapes, for one network (a leading slot axis S on every state operand,
    and optionally on ``w``/``c``/``delays``/rows, serves S networks):

    * ``slots``: (2,) int32 on the device, ``[tick % D, (tick+1) % D]``.
    * ``dly_read``: (B, Dr, K) spike history; the previous ``y`` viewed as
      (B, 1, K) when ``D == 1``. Uniform delays read slot ``slots[0]``;
      per-synapse delays read all ``Dr`` slots.
    * ``w``: (K, N) f32, premasked ``W*C`` when ``c`` is None.
    * ``delays``: (K, N) int32 in ``[1, Dr]``, or None.
    * ``v``, ``drive``: (B, N) f32 (``drive`` may be None); ``r`` (B, N) int32.
    * ``dly_full``: (B, D, N) ring to write, or None; ``dly_out``: see
      :func:`repro_torch.kernels.ref.check_ring` -- in place only without
      per-synapse delays, otherwise a separate buffer (fresh when None).
    * six per-neuron rows (N,), ``r_ref`` int32.

    The history holds spikes, 0 or 1: the kernel adds each term as one fused
    multiply-add, which rounds as ``acc + s * (w*c)`` only for such values.

    Returns ``(v', r', y', dly')``; ``y'`` is always a fresh buffer.
    """
    if mode not in MODES:
        raise ValueError(f"fused tick supports {MODES}, got {mode!r}")
    check_ring(delays, dly_full, dly_out)
    if v.device.type == "cpu":
        with _build.twin("tick_fused"):
            return fused_tick_ref(slots, dly_read, w, c, delays, v, r, drive, dly_full,
                                  v_th, leak, r_ref, gain, i_bias, v_reset,
                                  mode=mode, dly_out=dly_out)
    if v.device.type != "cuda":
        raise ValueError(f"fused_tick runs on cuda or cpu tensors, got {v.device}")
    return _launch(slots, dly_read, w, c, delays, v, r, drive, dly_full,
                   (v_th, leak, r_ref, gain, i_bias, v_reset), mode, dly_out)


def _launch(slots, dly_read, w, c, delays, v, r, drive, dly_full, rows, mode, dly_out):
    global launches, last_plan, last_launch
    slotted = v.dim() == 3
    if not slotted:
        dly_read, v, r = dly_read.unsqueeze(0), v.unsqueeze(0), r.unsqueeze(0)
        drive = None if drive is None else drive.unsqueeze(0)
        in_place = dly_out is not None and dly_out is dly_full
        dly_full = None if dly_full is None else dly_full.unsqueeze(0)
        if dly_out is not None:
            dly_out = dly_full if in_place else dly_out.unsqueeze(0)
    S, B, n_read, K = dly_read.shape
    N = v.shape[-1]
    dev, f32, i32 = v.device, torch.float32, torch.int32
    _build.expect(slots, "slots", i32, (2,), dev)
    _build.expect(dly_read, "dly_read", f32, (S, B, n_read, K), dev)
    _build.expect(v, "v", f32, (S, B, N), dev)
    _build.expect(r, "r", i32, (S, B, N), dev)
    if drive is not None:
        _build.expect(drive, "drive", f32, (S, B, N), dev)
    w_slot = _build.expect_slotted(w, "w", f32, (K, N), S, dev)
    c_slot = 0 if c is None else _build.expect_slotted(c, "c", f32, (K, N), S, dev)
    d_slot = 0 if delays is None else _build.expect_slotted(
        delays, "delays", i32, (K, N), S, dev)
    row_slot = _build.expect_rows(rows, N, S, dev)
    ring_in = ring_out = None
    n_ring = 0
    if dly_full is not None:
        n_ring = dly_full.shape[-2]
        _build.expect(dly_full, "dly_full", f32, (S, B, n_ring, N), dev)
        if dly_out is dly_full:
            ring_out = dly_full          # uniform delays: read and write slots differ
        else:
            ring_in = dly_full
            ring_out = torch.empty_like(dly_full) if dly_out is None else dly_out
            _build.expect(ring_out, "dly_out", f32, (S, B, n_ring, N), dev)
            if ring_out.data_ptr() in (dly_full.data_ptr(), dly_read.data_ptr()):
                raise ValueError("dly_out must not alias the ring it is read from")
    v_out, r_out, y_out = torch.empty_like(v), torch.empty_like(r), torch.empty_like(v)
    P = _build.ptr
    plan = _plan.plan(
        S, B, K, N, has_c=c is not None, delays=delays is not None, n_read=n_read,
        sms=_build.sm_count(dev),
        is_aligned=_plan.aligned((P(dly_read), P(w), P(c) or 0, P(delays) or 0),
                                 (dly_read.stride(0), dly_read.stride(1), K, w_slot, c_slot,
                                  d_slot)))
    desc = tick_launch(plan, n_read=n_read, delays=delays is not None,
                       ring="" if ring_out is None else "separate" if ring_in is not None
                       else "in_place", n_ring=n_ring, slotted_w=w_slot != 0,
                       drive=drive is not None, slotted_rows=row_slot != 0)
    err = _build.library().repro_tick_fused(
        P(slots), P(dly_read), dly_read.stride(0), dly_read.stride(1), n_read,
        P(w), w_slot, P(c), c_slot, P(delays), d_slot, P(v), P(r), P(drive),
        *(P(p) for p in rows), row_slot, P(v_out), P(r_out), P(y_out),
        P(ring_in), P(ring_out), 0 if ring_out is None else ring_out.stride(0), n_ring,
        S, B, K, N, MODES.index(mode), *desc.plan_args,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check("tick_fused", err)
    launches += 1
    last_plan, last_launch = plan, desc
    if not slotted:
        v_out, r_out, y_out = v_out[0], r_out[0], y_out[0]
        ring_out = None if ring_out is None else ring_out[0]
    return v_out, r_out, y_out, ring_out
