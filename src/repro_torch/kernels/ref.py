"""Plain PyTorch twins of the port's kernels (the counterpart of
``repro.kernels.ref``).

Each hand-written kernel has its twin here, with the arithmetic written out
step by step in the reference's order: the CPU tests hold the twins against
the JAX package, ``chip_smoke.py`` holds each kernel against its twin on the
card, and a kernel wrapper runs its twin for a tensor on the CPU.

Shapes follow the kernel wrappers: ``(B, ...)`` for one network, or with a
leading slot axis ``(S, B, ...)`` where the weights are ``(S, K, N)`` (or
``(K, N)`` shared) and the per-neuron rows ``(S, N)`` (or ``(N,)``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

MODES = ("fixed_leak", "euler")


class LIFStepOut(NamedTuple):
    v: torch.Tensor
    r: torch.Tensor
    y: torch.Tensor


WALKS = ("live", "all")


def spike_matmul_ref(s: torch.Tensor, w: torch.Tensor, c) -> torch.Tensor:
    """Masked synaptic product ``s @ (w * c)`` with f32 accumulation
    (``c=None``: ``w`` is already the premasked ``W*C``)."""
    wc = (w if c is None else w * c.to(w.dtype)).to(torch.float32)
    return s.to(torch.float32) @ wc


def event_spike_matmul_ref(s: torch.Tensor, w: torch.Tensor, c: torch.Tensor,
                           k_active: int) -> torch.Tensor:
    """Event-driven oracle: the dense product, which the spike-list gather
    equals whenever no row spikes more than ``k_active`` times."""
    return spike_matmul_ref(s, w, c)


def event_gather_sum(idx: torch.Tensor, counts: torch.Tensor, wc: torch.Tensor, *,
                     walk: str) -> torch.Tensor:
    """The spike-list gather: per row, the sum of rows ``idx[..., j]`` of
    ``wc``, added one slot at a time in ascending slot order from 0.

    ``idx`` is ``(B, k)`` or ``(S, B, k)``, ``counts`` ``(B,)`` or ``(S, B)``,
    ``wc`` ``(K', N)`` shared or ``(S, K', N)`` per slot. ``walk="live"``
    stops at ``counts`` (kernel B3: the sentinel tail is never read);
    ``walk="all"`` adds every slot (kernel B4), so ``wc`` must hold the
    all-zero sentinel row the tail points at.
    """
    if walk not in WALKS:
        raise ValueError(f"walk must be one of {WALKS}, got {walk!r}")
    acc = torch.zeros(idx.shape[:-1] + wc.shape[-1:], dtype=torch.float32,
                      device=wc.device)
    slot = (torch.arange(wc.shape[0], device=wc.device).reshape(-1, 1)
            if wc.dim() == 3 else None)
    for j in range(idx.shape[-1]):
        rows = idx[..., j].long()
        live = j < counts
        if walk == "live":
            rows = torch.where(live, rows, 0)
        got = (wc[rows] if slot is None else wc[slot, rows]).to(torch.float32)
        acc = torch.where(live.unsqueeze(-1), acc + got, acc) if walk == "live" else acc + got
    return acc


def _row(p: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A per-neuron row, shaped to broadcast against ``like``: ``(N,)`` as is,
    ``(S, N)`` against ``(S, B, N)`` as ``(S, 1, N)``."""
    return p.unsqueeze(-2) if p.dim() == 2 and like.dim() == 3 else p


def lif_epilogue_ref(acc, v, r, drive, v_th, leak, r_ref, gain, i_bias, v_reset,
                     mode: str):
    """The shared LIF epilogue (``repro.kernels.lif_step._lif_epilogue``)."""
    v_th, leak, r_ref, gain, i_bias, v_reset = (
        _row(p, v) for p in (v_th, leak, r_ref, gain, i_bias, v_reset))
    syn = acc if drive is None else acc + drive
    if mode == "euler":
        v_tilde = (1.0 - leak) * v + gain * (syn + i_bias)
    elif mode == "fixed_leak":
        active = (v != 0).to(torch.float32)
        leak_step = torch.minimum(leak * active, torch.abs(v))
        v_tilde = v + syn + i_bias - torch.sign(v) * leak_step
    else:
        raise ValueError(f"the kernels support {MODES}, got {mode!r}")
    spiked = (v_tilde >= v_th) & (r == 0)
    v_new = torch.where(spiked | (r > 0), v_reset, v_tilde).to(v.dtype)
    r_new = torch.where(spiked, r_ref, torch.clamp_min(r - 1, 0)).to(r.dtype)
    return LIFStepOut(v=v_new, r=r_new, y=spiked.to(v.dtype))


def fused_lif_step_ref(s, w, c, v, r, drive, v_th, leak, r_ref, gain, i_bias, v_reset,
                       *, mode: str = "fixed_leak") -> LIFStepOut:
    """Twin of kernel B1: ``s @ (w*c)`` (+ drive) then the LIF epilogue."""
    acc = spike_matmul_ref(s, w, c)
    return lif_epilogue_ref(acc, v, r, drive, v_th, leak, r_ref, gain, i_bias,
                            v_reset, mode)


def write_gated(got: LIFStepOut, out, gate) -> LIFStepOut:
    """A twin's result as its gated kernel leaves it: written into ``out``
    where ``gate`` is open (everywhere without a gate); a kernel whose gate
    is closed writes nothing. ``gate`` is a 0-d bool, or ``(S,)``, one per
    slot of ``(S, B, N)`` outputs."""
    if out is None:
        return got
    for dst, src in zip(out, got):
        if gate is None:
            dst.copy_(src)
        else:
            dst.copy_(torch.where(gate.reshape(gate.shape + (1,) * (dst.dim() - gate.dim())),
                                  src, dst))
    return out


def event_lif_dispatch_ref(idx, counts, wc, v, r, drive, v_th, leak, r_ref, gain,
                           i_bias, v_reset, *, mode: str = "fixed_leak",
                           walk: str = "live") -> LIFStepOut:
    """Twin of kernels B3 (``walk="live"``) and B4 (``walk="all"``): the
    spike-list gather of :func:`event_gather_sum`, then the LIF epilogue."""
    acc = event_gather_sum(idx, counts, wc, walk=walk)
    return lif_epilogue_ref(acc, v, r, drive, v_th, leak, r_ref, gain, i_bias,
                            v_reset, mode)


def delayed_product(ring: torch.Tensor, slot: torch.Tensor, wc: torch.Tensor,
                    delays: torch.Tensor) -> torch.Tensor:
    """Per-synapse delays: synapse ``(p, q)`` with delay ``d`` reads ring slot
    ``(slot - (d - 1)) % D``, as the d-major flattened contraction
    ``(..., D*K) @ (D*K, N)`` of the reference einsum. A delay outside
    ``[1, D]`` routes nothing. ``slot`` is a 0-d device tensor: no host sync.
    """
    D = ring.shape[-2]
    back = torch.arange(D, device=ring.device, dtype=slot.dtype)
    hist = ring.index_select(-2, torch.remainder(slot - back, D).long())
    planes = torch.stack([wc * (delays == d + 1).to(wc.dtype) for d in range(D)], dim=-3)
    return hist.flatten(-2) @ planes.flatten(-3, -2)


def check_ring(delays, dly_full, dly_out) -> None:
    """The ring-write contract shared by kernel B2 and its twin: ``dly_out is
    dly_full`` writes the fresh spikes in place, which is race-free only when
    the tick reads one ring slot and writes another."""
    if dly_out is None:
        return
    if dly_full is None:
        raise ValueError("dly_out needs dly_full: there is no ring to write")
    if dly_out is dly_full:
        if delays is not None:
            raise ValueError(
                "per-synapse delays read every ring slot, the write slot "
                "included: write dly' to a separate buffer, not in place")
        if dly_full.shape[-2] < 2:
            raise ValueError("an in-place ring write needs max_delay > 1")


def fused_tick_ref(slots, dly_read, w, c, delays, v, r, drive, dly_full,
                   v_th, leak, r_ref, gain, i_bias, v_reset, *,
                   mode: str = "fixed_leak", dly_out=None):
    """Twin of kernel B2, with the same signature as its wrapper.

    ``slots`` is the device int32 pair ``[tick % D, (tick+1) % D]``;
    ``dly_read`` the ``(..., B, Dr, K)`` history (the previous ``y`` as
    ``Dr = 1`` when the ring is degenerate); ``w`` the premasked ``W*C``
    when ``c`` is None. ``dly_full`` is the ring to write through (None: no
    write); ``dly_out`` its target: None for a fresh buffer, ``dly_full``
    itself to write in place, or a spare buffer. Returns
    ``(v', r', y', dly')``.
    """
    check_ring(delays, dly_full, dly_out)
    wc = w if c is None else w * c.to(w.dtype)
    if delays is None:
        s = dly_read.index_select(-2, slots[:1].long()).squeeze(-2)
        acc = s @ wc
    else:
        acc = delayed_product(dly_read, slots[0], wc, delays)
    out = lif_epilogue_ref(acc, v, r, drive, v_th, leak, r_ref, gain, i_bias,
                           v_reset, mode)
    ring = None
    if dly_full is not None:
        write = slots[1:].long()
        fresh = out.y.unsqueeze(-2)
        if dly_out is dly_full:
            ring = dly_full.index_copy_(-2, write, fresh)
        else:
            ring = dly_full.index_copy(-2, write, fresh)
            if dly_out is not None:
                ring = dly_out.copy_(ring)
    return out.v, out.r, out.y, ring


class STDPStepOut(NamedTuple):
    w: torch.Tensor       # (S?, K, N) updated weights, clipped to [w_min, w_max]
    elig: torch.Tensor    # (S?, K, N) eligibility (decayed and accumulated iff rstdp)
    x_pre: torch.Tensor   # (S?, B, K) updated presynaptic traces
    x_post: torch.Tensor  # (S?, B, N) updated postsynaptic traces


def _per_slot(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A scalar or per-slot ``(S,)`` value, shaped to broadcast against a
    ``(S, ., .)`` tensor ``like`` (a scalar stays a scalar)."""
    return t.reshape(-1, 1, 1) if t.dim() == 1 and like.dim() == 3 else t


def fused_stdp_step_ref(s_pre, x_pre, s_post, x_post, w, c, elig, reward, *,
                        rule: str, a_plus: float, a_minus: float, decay_pre: float,
                        decay_post: float, decay_elig: float, lr_reward: float,
                        w_min: float, w_max: float, tick=None,
                        learn_until=None, dw_stats: bool = False):
    """Twin of kernel B5: trace decay + pair-STDP outer-product update
    (``repro.kernels.ref.fused_stdp_step_ref``, in its association order).

    Shapes: ``s_pre, x_pre`` (B, K); ``s_post, x_post`` (B, N); ``w, c,
    elig`` (K, N); ``reward`` a 0-d tensor -- or each with a leading slot
    axis S (``c`` may stay shared, ``reward`` may be ``(S,)``). LTP pairs the
    updated pre trace with this tick's post spikes, LTD this tick's pre
    spikes with the updated post trace; batch rows sum. Synapses with
    ``c == 0`` come back bit-identical, not clipped.

    ``tick`` (0-d int32) and ``learn_until`` (0-d or ``(S,)`` int32) gate
    the whole update, as the reference engine's ``jnp.where`` does: where
    ``tick >= learn_until`` every output equals its input.

    ``dw_stats=True`` returns ``(out, stats)`` with ``stats`` ``(G, 1, 2)``:
    ``sum |dw|`` and ``sum dw^2`` of the committed delta ``dw = w' - w`` (the
    reference engine's, after the gate and the clip) for each of the G
    weight matrices, the slots or one shared -- kernel B5's statistics, with
    one partial per matrix.
    """
    f32 = torch.float32
    x_pre_new = decay_pre * x_pre.to(f32) + s_pre.to(f32)
    x_post_new = decay_post * x_post.to(f32) + s_post.to(f32)
    ltp = x_pre_new.transpose(-1, -2) @ s_post.to(f32)
    ltd = s_pre.to(f32).transpose(-1, -2) @ x_post_new
    cf = c.to(f32)
    dw = (a_plus * ltp - a_minus * ltd) * cf
    wf = w.to(f32)
    if rule == "rstdp":
        elig_new = decay_elig * elig.to(f32) + dw
        w_new = wf + lr_reward * _per_slot(reward.to(f32), dw) * elig_new
    else:
        elig_new = elig.to(f32)
        w_new = wf + dw
    w_new = torch.where(cf > 0, torch.clamp(w_new, w_min, w_max), wf)
    if learn_until is not None:
        gate = tick < learn_until
        w_new = torch.where(_per_slot(gate, w_new), w_new, wf)
        elig_new = torch.where(_per_slot(gate, elig_new), elig_new, elig.to(f32))
        x_pre_new = torch.where(_per_slot(gate, x_pre_new), x_pre_new, x_pre.to(f32))
        x_post_new = torch.where(_per_slot(gate, x_post_new), x_post_new, x_post.to(f32))
    out = STDPStepOut(w=w_new.to(w.dtype), elig=elig_new.to(elig.dtype),
                      x_pre=x_pre_new.to(x_pre.dtype), x_post=x_post_new.to(x_post.dtype))
    if not dw_stats:
        return out
    dw = (out.w.to(f32) - wf).reshape(-1, *wf.shape[-2:])
    stats = torch.stack((dw.abs().sum((-2, -1)), (dw * dw).sum((-2, -1))), dim=-1)
    return out, stats.unsqueeze(1)
