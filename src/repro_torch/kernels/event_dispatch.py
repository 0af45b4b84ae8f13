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
B4's last launch; ``last_launch`` the
:class:`~repro_torch.kernels.launch_spec.KernelLaunch` of the last launch of
either kernel (:func:`event_launch`, :func:`event_db_launch`).
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from repro_torch.kernels import _build, _event_plan, _stream
from repro_torch.kernels.launch_spec import IN, OUT, Alias, KernelLaunch, Operand, slot_dim
from repro_torch.kernels.lif_step import ROW_NAMES
from repro_torch.kernels.ref import MODES, LIFStepOut, event_lif_dispatch_ref, write_gated

launches = 0      # kernel B4 (walk every slot)
launches_db = 0   # kernel B3 (walk the live slots)
last_plan = None  # B4's
last_launch = None
B3_BLOCK_N = 128  # csrc/event_dispatch.cu kBlockN: B3's columns per block, one per thread
B3_CHUNK = 512    # kChunk: the ids B3 stages in (static) shared memory per pass


def _gather_operands(S, B, k, N, Kw, *, rows_of, cols_of, slotted_w, drive, slotted_rows,
                     gate, out, counts):
    """The operands B3 and B4 share. ``rows_of(block)`` and ``cols_of(block)``
    give the batch rows and columns a block owns; the kernels bounds-check
    both, and every id against ``w``'s rows."""
    def lists(block, rank, ex):
        return [((block[2], block[2] + 1), rows_of(block), (0, k))]

    def weights(block, rank, ex):
        return [slot_dim(slotted_w, block[2]) + ((0, Kw), cols_of(block))]

    def state(block, rank, ex):
        return [((block[2], block[2] + 1), rows_of(block), cols_of(block))]

    def row(block, rank, ex):
        return [slot_dim(slotted_rows, block[2]) + (cols_of(block),)]

    wshape = ((S,) if slotted_w else ()) + (Kw, N)
    rshape = ((S,) if slotted_rows else ()) + (N,)
    ins = [Operand("idx", (S, B, k), "int32", IN, lists, (1,))]
    if counts:
        ins.append(Operand("counts", (S, B), "int32", IN,
                           lambda block, rank, ex: [((block[2], block[2] + 1),
                                                     rows_of(block))], (1,)))
    ins += [Operand("w", wshape, "float32", IN, weights, (len(wshape) - 2, len(wshape) - 1)),
            Operand("v", (S, B, N), "float32", IN, state, (1, 2)),
            Operand("r", (S, B, N), "int32", IN, state, (1, 2))]
    if drive:
        ins.append(Operand("drive", (S, B, N), "float32", IN, state, (1, 2)))
    ins += [Operand(name, rshape, "int32" if name == "r_ref" else "float32", IN, row,
                    (len(rshape) - 1,)) for name in ROW_NAMES]
    if gate:
        shape = (S,) if gate == "slot" else ()
        ins.append(Operand("skip", shape, "bool", IN,
                           lambda block, rank, ex: [((block[2], block[2] + 1),) if shape
                                                    else ()]))
    outs = [Operand(name, (S, B, N), dt, OUT, state, (1, 2))
            for name, dt in (("v_out", "float32"), ("r_out", "int32"), ("y_out", "float32"))]
    aliases = ((Alias("v", "v_out"), Alias("r", "r_out"), Alias("v", "y_out"))
               if out else ())
    return tuple(ins + outs), aliases


@functools.lru_cache(maxsize=512)
def event_db_launch(S: int, B: int, k: int, N: int, Kw: int, *, slotted_w: bool = False,
                    drive: bool = True, slotted_rows: bool = False, gate: str = "",
                    out: bool = False) -> KernelLaunch:
    """The descriptor of one B3 launch (``csrc/event_dispatch.cu``
    ``repro_event_dispatch``, ``counts`` given): grid ``(ceil(N / 128), B, S)``
    of 128 threads, one batch row and 128 columns a block, no dynamic shared
    memory (its ids are staged in a static ``int[512]``) and no plan. It reads
    with plain loads: there is no copy ring."""
    ops, aliases = _gather_operands(
        S, B, k, N, Kw, rows_of=lambda block: (block[1], block[1] + 1),
        cols_of=lambda block: (block[0] * B3_BLOCK_N, (block[0] + 1) * B3_BLOCK_N),
        slotted_w=slotted_w, drive=drive, slotted_rows=slotted_rows, gate=gate, out=out,
        counts=True)
    return KernelLaunch(
        name="event_dispatch_db", symbol="event_dispatch_db_kernel",
        grid=(math.ceil(N / B3_BLOCK_N), B, S), block=(B3_BLOCK_N, 1, 1),
        smem_static=4 * B3_CHUNK, operands=ops, aliases=aliases, plan_args=(0,) * 6)


def spike_lists(S: int, B: int, k: int, n: int, rate: float, seed: int = 0) -> tuple:
    """Example spike lists for the lint, ``(S, B, k)`` nested tuples: each
    row's ascending ids of a ``rate`` raster over ``n`` neurons (at most
    ``k``), then the sentinel ``n``. ``rate=0`` is a silent tick: every slot
    the sentinel."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(S):
        rows = []
        for _ in range(B):
            m = min(k, int(rng.binomial(n, rate)))
            ids = np.sort(rng.choice(n, m, replace=False)).tolist()
            rows.append(tuple(ids + [n] * (k - m)))
        out.append(tuple(rows))
    return tuple(out)


def b4_schedule(p: _event_plan.EventPlan, lists, block) -> tuple:
    """Twin of B4's copy ring for one block at example ``lists``: per pass of
    ``chunk`` slots and per window of ``window`` ids, the ascending union of
    the ids its group's rows list there streams through the two stages of
    ``stage_rows`` rows: stage ``s + 1`` is issued after stage ``s`` is waited
    for and stage ``s - 1`` released, and stage ``s`` is then added. Each
    issue carries the row ids it copies. Returns ``(ops, stages)``."""
    _, g, z = block
    rows = range(g * p.rows, min(p.B, (g + 1) * p.rows))
    ops, tile = [], 0
    for j0, j1 in p.passes():
        ids = {i for b in rows for i in lists[z][b][j0:j1]}
        for lo, hi in p.windows():
            union = sorted(i for i in ids if lo <= i < hi)
            bounds = p.stage_bounds(len(union))
            for s in range(-1, len(bounds)):
                if s >= 0:
                    ops.append(("wait", s & 1, tile + s, None))
                    if s > 0:
                        ops.append(("release", (s - 1) & 1, tile + s - 1, None))
                t = s + 1
                if t < len(bounds):
                    r0, r1 = bounds[t]
                    ops.append(("issue", t & 1, tile + t, tuple(union[r0:r1])))
                if s >= 0:
                    ops.append(("consume", s & 1, tile + s, None))
            if bounds:
                ops.append(("release", (len(bounds) - 1) & 1, tile + len(bounds) - 1, None))
            tile += len(bounds)
    return ops, tile


@functools.lru_cache(maxsize=512)
def event_launch(p: _event_plan.EventPlan, *, slotted_w: bool = False, drive: bool = True,
                 slotted_rows: bool = False, gate: str = "", out: bool = False,
                 lists=None) -> KernelLaunch:
    """The descriptor of one B4 launch (``csrc/event_dispatch.cu``
    ``launch_gather``): grid ``(ceil(N / 32), ceil(B / rows), S)`` of
    ``rows * 32`` threads, ``EventPlan.smem`` bytes of dynamic shared memory,
    one block an SM. ``lists``: the example spike lists of its ring's twin
    (:func:`b4_schedule`; default :func:`spike_lists` at a 5 % rate). A silent tick
    (``counts == 0``: every slot the sentinel) stages only the sentinel row."""
    S, B, k, N, Kw = p.S, p.B, p.k, p.N, p.Kw
    tn = _event_plan.TILE_N
    ops, aliases = _gather_operands(
        S, B, k, N, Kw, rows_of=lambda block: (block[1] * p.rows, (block[1] + 1) * p.rows),
        cols_of=lambda block: (block[0] * tn, (block[0] + 1) * tn), slotted_w=slotted_w,
        drive=drive, slotted_rows=slotted_rows, gate=gate, out=out, counts=False)
    @functools.lru_cache(maxsize=None)
    def ring(g, z):
        # a block's ring depends on its group and slot only, not on its columns
        example = lists if lists is not None else spike_lists(S, B, k, Kw - 1, 0.05)
        return b4_schedule(p, example, (0, g, z))
    return KernelLaunch(
        name="event_dispatch", symbol="event_dispatch_kernel", grid=p.grid,
        block=(p.threads, 1, 1), smem_dynamic=p.smem, operands=ops, aliases=aliases,
        stage_schedule=lambda block, rank, ex: ring(block[1], block[2]),
        quiet_schedule=lambda: b4_schedule(p, spike_lists(S, B, k, Kw - 1, 0.0), (0, 0, 0))[0],
        quiet_allows=frozenset({Kw - 1}), plan_args=p.args(), plan=p)


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
        with _build.twin("event_dispatch_db" if walk == "live" else "event_dispatch"):
            if counts is None:
                counts = torch.full(idx.shape[:-1], idx.shape[-1], dtype=torch.int32)
            got = event_lif_dispatch_ref(idx, counts, w, v, r, drive, *rows, mode=mode,
                                         walk=walk)
            return write_gated(got, out, None if skip is None else ~skip)
    if v.device.type != "cuda":
        raise ValueError(f"event dispatch runs on cuda or cpu tensors, got {v.device}")
    return _launch(idx, counts, w, v, r, drive, rows, mode, skip, out)


def _launch(idx, counts, w, v, r, drive, rows, mode, skip, out) -> LIFStepOut:
    global launches, launches_db, last_plan, last_launch
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
    kw = dict(slotted_w=w_slot != 0, drive=drive is not None, slotted_rows=row_slot != 0,
              gate="" if skip is None else "slot" if gate_slot else "shared",
              out=out is not None)
    if counts is None:
        plan = _event_plan.event_plan(S, B, k, N, Kw, w_slot=w_slot,
                                      is_aligned=_stream.aligned16([P(w)]))
        desc = event_launch(plan, **kw)
    else:
        desc = event_db_launch(S, B, k, N, Kw, **kw)
    err = _build.library().repro_event_dispatch(
        P(idx), P(counts), k, P(w), w_slot, Kw, P(v), P(r), P(drive),
        *(P(p) for p in rows), row_slot, P(v_out), P(r_out), P(y_out), P(skip), gate_slot,
        S, B, N, MODES.index(mode), *desc.plan_args,
        torch.cuda.current_stream(dev).cuda_stream)
    name = "event_dispatch" if counts is None else "event_dispatch_db"
    _build.check(name, err)
    if counts is None:
        launches += 1
        last_plan = plan
    else:
        launches_db += 1
    last_launch = desc
    if out is not None:
        return out
    if not slotted:
        v_out, r_out, y_out = v_out[0], r_out[0], y_out[0]
    return LIFStepOut(v=v_out, r=r_out, y=y_out)
