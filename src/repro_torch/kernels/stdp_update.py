"""Kernel B5: one fused STDP / R-STDP learning tick on Hopper.

Counterpart of ``repro.kernels.stdp_update`` (``_stdp_kernel`` /
``fused_stdp_step``). The CUDA source is ``csrc/stdp_update.cu``; its plain
twin is :func:`repro_torch.kernels.ref.fused_stdp_step_ref`, with the same
arguments. The wrapper runs the twin for tensors on the CPU and launches the
kernel for tensors on the card; anything else raises. ``launches`` counts
kernel launches; ``last_plan`` is the
:class:`repro_torch.kernels._stream.StdpPlan` of the last launch and
``last_launch`` its :class:`~repro_torch.kernels.launch_spec.KernelLaunch`
(:func:`stdp_launch`), from which the C entry takes its plan. With
``dw_stats=True`` the kernel also writes its per-block partial sums of
``|dw|`` and ``dw^2`` for the tick telemetry (a separate instantiation:
without it the kernel runs exactly as before).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.kernels import _build, _stream
from repro_torch.kernels.launch_spec import (IN, OUT, Alias, KernelLaunch, Operand,
                                             flat_boxes)
from repro_torch.kernels.ref import STDPStepOut, fused_stdp_step_ref

RULES = ("stdp", "rstdp")
launches = 0
last_plan = None
last_launch = None
# csrc/stdp_update.cu's static shared memory: the staged traces (Traces), and
# with the dw statistics the flush's float red[2][kWarps].
STATS_SMEM = 2 * _stream.WARPS * 4


@functools.lru_cache(maxsize=256)
def stdp_schedule(n: int, stages: int) -> tuple:
    """Twin of B5's ring for a block walking ``n`` units: each thread copies
    its chunks of ``c`` (and ``elig``) ``stages - 1`` units ahead; at unit
    ``i`` it issues unit ``i + stages - 1`` into the stage unit ``i - 1``
    left, then waits until unit ``i + 1`` has landed (``wait_group``; unit 0
    too at the first), adds unit ``i`` and leaves its stage. A thread reads
    only the chunks it copied itself, so no barrier orders the ring."""
    ahead = stages - 1
    ops = [("issue", i % stages, i, i) for i in range(min(ahead, n))]
    for i in range(n):
        if i + ahead < n:
            ops.append(("issue", (i + ahead) % stages, i + ahead, i + ahead))
        for j in ((0, 1) if i == 0 else (i + 1,)):
            if j < n:
                ops.append(("wait", j % stages, j, None))
        ops += [("consume", i % stages, i, None), ("release", i % stages, i, None)]
    return tuple(ops)


def _per_slot(name: str, dtype: str, S: int, slotted: bool) -> Operand:
    """A per-slot scalar operand (``(S,)``, or 0-d shared) every block reads."""
    shape = (S,) if slotted else ()
    return Operand(name, shape, dtype, IN,
                   lambda block, rank, ex: [((0, S),) if slotted else ()])


@functools.lru_cache(maxsize=512)
def stdp_launch(p: _stream.StdpPlan, *, slotted_w: bool = True, slotted_c: bool = False,
                slotted_reward: bool = False, gate: str = "", dw_stats: bool = False,
                open_slots=None) -> KernelLaunch:
    """The descriptor of one B5 launch (``csrc/stdp_update.cu``: ``launch_ring``
    on the ``cp.async`` fill, ``stdp_update_element_kernel`` otherwise): a
    persistent grid of ``StdpPlan.blocks`` blocks of 256 threads walking
    ``(slot, tile)`` units (:meth:`StdpPlan.walk`), ``StdpPlan.smem`` bytes of
    dynamic shared memory (the ring; none on the element fill). ``gate``: ``""``
    (no ``learn_until``), ``"shared"`` (0-d) or ``"slot"`` (``(S,)``). ``open_slots``
    (default: every slot) is the example of the ``learn_until`` gate: a closed
    slot's traces are copied through by every block's share of threads and
    its matrices are not touched."""
    S, B, K, N = p.S, p.B, p.K, p.N
    tk, bn, threads = _stream.STDP_TK, _stream.BLOCK_N, _stream.THREADS
    open_ = tuple(open_slots) if open_slots is not None else (True,) * S

    def units(block):
        t = np.arange(block[0], p.tiles, p.blocks, dtype=np.int64)
        slots = [s for s in range(S) if open_[s]]
        sl = np.repeat(np.asarray(slots, np.int64), len(t))
        tt = np.tile(t, len(slots))
        kt, nt = np.divmod(tt, p.n_tiles)
        return sl, kt * tk, nt * bn, kt, nt

    def boxes(*ranges):
        return np.stack([np.stack(r, -1) for r in ranges], 1)

    def trace(extent, which):
        def fp(block, rank, ex):
            sl, k0, n0, _, _ = units(block)
            lo = k0 if which == "pre" else n0
            zero = np.zeros_like(sl)
            return boxes((sl, sl + 1), (zero, zero + B), (lo, lo + extent))
        return fp

    def matrix(slotted):
        def fp(block, rank, ex):
            sl, k0, n0, _, _ = units(block)
            lead = ((sl, sl + 1),) if slotted else ()
            return boxes(*lead, (k0, k0 + tk), (n0, n0 + bn))
        return fp

    def trace_out(which, length):
        def fp(block, rank, ex):
            sl, k0, n0, kt, nt = units(block)
            keep = (nt == 0) if which == "pre" else (kt == 0)
            lo = (k0 if which == "pre" else n0)[keep]
            sl = sl[keep]
            zero = np.zeros_like(sl)
            tiles = boxes((sl, sl + 1), (zero, zero + B),
                          (lo, lo + (tk if which == "pre" else bn)))
            # closed slots: every block's share of threads copies the traces through
            step = p.blocks * threads
            closed = [((s, s + 1),) + box for s in range(S) if not open_[s]
                      for i in range(block[0] * threads, B * length, step)
                      for box in flat_boxes(i, min(B * length, i + threads), length)]
            return np.concatenate([tiles, np.asarray(closed, np.int64).reshape(-1, 3, 2)])
        return fp

    lead = int(slotted_w)
    wshape = ((S,) if slotted_w else ()) + (K, N)
    cshape = ((S,) if slotted_c else ()) + (K, N)
    checked_w = (lead, lead + 1)
    pre, post, own = trace(tk, "pre"), trace(bn, "post"), matrix(slotted_w)
    ins = [Operand("s_pre", (S, B, K), "float32", IN, pre, (2,)),
           Operand("x_pre", (S, B, K), "float32", IN, pre, (2,)),
           Operand("s_post", (S, B, N), "float32", IN, post, (2,)),
           Operand("x_post", (S, B, N), "float32", IN, post, (2,)),
           Operand("w", wshape, "float32", IN, own, checked_w),
           Operand("c", cshape, "float32", IN, matrix(slotted_c),
                   (len(cshape) - 2, len(cshape) - 1))]
    # each element of w (and elig) is read and written by the thread that owns it
    outs = [Operand("w_out", wshape, "float32", OUT, own, checked_w)]
    aliases = [Alias("w", "w_out", shared=True)]
    if p.rstdp:
        ins.append(Operand("elig", wshape, "float32", IN, own, checked_w))
        outs.append(Operand("elig_out", wshape, "float32", OUT, own, checked_w))
        aliases.append(Alias("elig", "elig_out", shared=True))
        ins.append(_per_slot("reward", "float32", S, slotted_reward))
    if gate:
        ins += [Operand("tick", (), "int32", IN, lambda block, rank, ex: [()]),
                _per_slot("learn_until", "int32", S, gate == "slot")]
    outs += [Operand("x_pre_out", (S, B, K), "float32", OUT, trace_out("pre", K), (2,)),
             Operand("x_post_out", (S, B, N), "float32", OUT, trace_out("post", N), (2,))]
    if dw_stats:
        outs.append(Operand("stats", (S, p.blocks, 2), "float32", OUT,
                            lambda block, rank, ex: [((0, S), (block[0], block[0] + 1),
                                                      (0, 2))]))
    def stages(block, rank, ex):
        n = len(p.walk(block[0], open_))
        return stdp_schedule(n, p.stages), n

    static = _stream.b5_static_smem() + (STATS_SMEM if dw_stats else 0)
    per_block = p.smem + _stream.b5_static_smem() + _stream.BLOCK_RESERVE
    ring = p.fill == "cp.async"
    return KernelLaunch(
        name="stdp_update", symbol="stdp_update_kernel" if ring else "stdp_update_element_kernel",
        grid=(p.blocks, 1, 1), block=(threads, 1, 1), smem_dynamic=p.smem, smem_static=static,
        blocks_per_sm=max(1, min(_stream.MAX_BLOCKS_PER_SM, _stream.SM_SMEM // per_block)),
        operands=tuple(ins + outs), aliases=tuple(aliases),
        stage_schedule=stages if ring else None,
        # every gate closed: no block walks a unit
        quiet_schedule=(lambda: stdp_schedule(0, p.stages)) if ring else None,
        plan_args=p.args(), plan=p)


def fused_stdp_step(s_pre, x_pre, s_post, x_post, w, c, elig, reward, *, rule: str,
                    a_plus: float, a_minus: float, decay_pre: float, decay_post: float,
                    decay_elig: float, lr_reward: float, w_min: float, w_max: float,
                    tick=None, learn_until=None, in_place: bool = False,
                    dw_stats: bool = False):
    """One learning tick: ``(w', elig', x_pre', x_post')``.

    Shapes, for one network: ``s_pre, x_pre`` (B, K), ``s_post, x_post``
    (B, N), ``w, c, elig`` (K, N), ``reward`` a 0-d tensor. With a leading
    slot axis S on the spikes and traces, ``w`` and ``elig`` are (S, K, N)
    (each slot learns its own matrix), ``c`` (S, K, N) or shared (K, N), and
    ``reward`` 0-d or (S,). All f32 and on one device.

    ``tick`` (0-d int32) and ``learn_until`` (0-d or (S,) int32), both on the
    device, gate the update: where ``tick >= learn_until`` nothing changes.

    ``in_place=True`` updates ``w`` and ``elig`` in their buffers and returns
    them; otherwise they are left as they were. For ``rule="stdp"`` the
    eligibility is never read or written (the returned ``elig`` is the
    input). The traces always come back in fresh buffers.

    Returns the :class:`STDPStepOut`; with ``dw_stats=True`` the pair
    ``(out, stats)``, where ``stats`` ``(G, P, 2)`` holds partial sums of
    ``|w' - w|`` and ``(w' - w)^2`` of the committed update for each of the
    G weight matrices (the slots, or one shared): the kernel's P per-block
    partials, or the twin's one.
    """
    if rule not in RULES:
        raise ValueError(f"unknown plasticity rule {rule!r}; have {RULES}")
    if (tick is None) != (learn_until is None):
        raise ValueError("tick and learn_until gate the update together: pass both or neither")
    hyper = dict(rule=rule, a_plus=a_plus, a_minus=a_minus, decay_pre=decay_pre,
                 decay_post=decay_post, decay_elig=decay_elig, lr_reward=lr_reward,
                 w_min=w_min, w_max=w_max)
    if w.device.type == "cpu":
        with _build.twin("stdp_update"):
            got = fused_stdp_step_ref(s_pre, x_pre, s_post, x_post, w, c, elig, reward,
                                      tick=tick, learn_until=learn_until, dw_stats=dw_stats,
                                      **hyper)
            out, stats = got if dw_stats else (got, None)
            if in_place:
                w.copy_(out.w)
                if rule == "rstdp":
                    elig.copy_(out.elig)
                out = out._replace(w=w, elig=elig)
            return (out, stats) if dw_stats else out
    if w.device.type != "cuda":
        raise ValueError(f"fused_stdp_step runs on cuda or cpu tensors, got {w.device}")
    return _launch(s_pre, x_pre, s_post, x_post, w, c, elig, reward, tick, learn_until,
                   in_place, dw_stats, hyper)


def _launch(s_pre, x_pre, s_post, x_post, w, c, elig, reward, tick, learn_until,
            in_place, dw_stats, hyper):
    global launches, last_plan, last_launch
    slotted = s_pre.dim() == 3
    if not slotted:
        s_pre, x_pre = s_pre.unsqueeze(0), x_pre.unsqueeze(0)
        s_post, x_post = s_post.unsqueeze(0), x_post.unsqueeze(0)
    S, B, K = s_pre.shape
    N = s_post.shape[-1]
    dev, f32, i32 = w.device, torch.float32, torch.int32
    rstdp = hyper["rule"] == "rstdp"
    for name, t, n in (("s_pre", s_pre, K), ("x_pre", x_pre, K),
                       ("s_post", s_post, N), ("x_post", x_post, N)):
        _build.expect(t, name, f32, (S, B, n), dev)
    w_slot = _build.expect_slotted(w, "w", f32, (K, N), S, dev)
    c_slot = _build.expect_slotted(c, "c", f32, (K, N), S, dev)
    e_slot = _build.expect_slotted(elig, "elig", f32, (K, N), S, dev)
    if S > 1 and (w_slot == 0 or (rstdp and e_slot == 0)):
        raise ValueError("w and elig need a slot axis when S > 1: every slot "
                         "updates its own matrix")
    r_slot = _build.expect_slotted(reward, "reward", f32, (), S, dev)
    u_slot = 0
    if learn_until is not None:
        _build.expect(tick, "tick", i32, (), dev)
        u_slot = _build.expect_slotted(learn_until, "learn_until", i32, (), S, dev)
    if not in_place:
        w = w.clone()
        elig = elig.clone() if rstdp else elig
    x_pre_out, x_post_out = torch.empty_like(x_pre), torch.empty_like(x_post)
    P = _build.ptr
    streamed = (w, c, elig) if rstdp else (w, c)
    plan = _stream.stdp_plan(S, B, K, N, rstdp=rstdp,
                             strides=(w_slot, c_slot, e_slot if rstdp else 0),
                             is_aligned=_stream.aligned16(P(t) for t in streamed),
                             sms=_build.sm_count(dev))
    desc = stdp_launch(plan, slotted_w=w_slot != 0, slotted_c=c_slot != 0,
                       slotted_reward=r_slot != 0,
                       gate="" if learn_until is None else "slot" if u_slot else "shared",
                       dw_stats=dw_stats)
    stats = torch.empty((S, plan.blocks, 2), dtype=f32, device=dev) if dw_stats else None
    err = _build.library().repro_stdp_update(
        P(s_pre), P(x_pre), P(s_post), P(x_post), P(w), w_slot, P(c), c_slot,
        P(elig), e_slot, P(reward), r_slot, P(tick), P(learn_until), u_slot,
        P(x_pre_out), P(x_post_out), P(stats), S, B, K, N, int(rstdp),
        *(float(hyper[k]) for k in ("a_plus", "a_minus", "decay_pre", "decay_post",
                                    "decay_elig", "lr_reward", "w_min", "w_max")),
        *desc.plan_args, torch.cuda.current_stream(dev).cuda_stream)
    _build.check("stdp_update", err)
    launches += 1
    last_plan, last_launch = plan, desc
    if not slotted:
        x_pre_out, x_post_out = x_pre_out[0], x_post_out[0]
    out = STDPStepOut(w=w, elig=elig, x_pre=x_pre_out, x_post=x_post_out)
    return (out, stats) if dw_stats else out
