"""Kernel B5: one fused STDP / R-STDP learning tick on Hopper.

Counterpart of ``repro.kernels.stdp_update`` (``_stdp_kernel`` /
``fused_stdp_step``). The CUDA source is ``csrc/stdp_update.cu``; its plain
twin is :func:`repro_torch.kernels.ref.fused_stdp_step_ref`, with the same
arguments. The wrapper runs the twin for tensors on the CPU and launches the
kernel for tensors on the card; anything else raises. ``launches`` counts
kernel launches; ``last_plan`` is the
:class:`repro_torch.kernels._stream.StdpPlan` of the last launch. With
``dw_stats=True`` the kernel also writes its per-block partial sums of
``|dw|`` and ``dw^2`` for the tick telemetry (a separate instantiation:
without it the kernel runs exactly as before).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, _stream
from repro_torch.kernels.ref import STDPStepOut, fused_stdp_step_ref

RULES = ("stdp", "rstdp")
launches = 0
last_plan = None


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
    global launches, last_plan
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
    stats = torch.empty((S, plan.blocks, 2), dtype=f32, device=dev) if dw_stats else None
    err = _build.library().repro_stdp_update(
        P(s_pre), P(x_pre), P(s_post), P(x_post), P(w), w_slot, P(c), c_slot,
        P(elig), e_slot, P(reward), r_slot, P(tick), P(learn_until), u_slot,
        P(x_pre_out), P(x_post_out), P(stats), S, B, K, N, int(rstdp),
        *(float(hyper[k]) for k in ("a_plus", "a_minus", "decay_pre", "decay_post",
                                    "decay_elig", "lr_reward", "w_min", "w_max")),
        *plan.args(), torch.cuda.current_stream(dev).cuda_stream)
    _build.check("stdp_update", err)
    launches += 1
    last_plan = plan
    if not slotted:
        x_pre_out, x_post_out = x_pre_out[0], x_post_out[0]
    out = STDPStepOut(w=w, elig=elig, x_pre=x_pre_out, x_post=x_post_out)
    return (out, stats) if dw_stats else out
