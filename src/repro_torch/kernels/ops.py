"""State bridges between the engine's records and the kernel wrappers.

Counterpart of ``repro.kernels.ops`` (``fused_lif_step``, ``fused_tick``,
``fused_lif_step_slots``). The reference pads every operand to block
multiples here; the port's kernels bounds-check their ragged edges, so the
bridges only reshape (views, no copies): the batch dimensions flatten to
``B``, and a slot axis, when the parameters carry one, stays in front. The
reference's ``fused_stdp_step`` bridge is only padding, so the port has
none: :func:`repro_torch.plasticity.rules.plasticity_step` calls kernel B5's
wrapper directly.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.lif import LIFState
from repro_torch.kernels import lif_step as _lif_kernel
from repro_torch.kernels import tick_fused as _tick_kernel

_INFERENCE_ONLY = ("the {} backend is inference-only; the surrogate gradient "
                   "arrives with the classifier slice (ROADMAP A.5)")


def slot_count(params) -> Optional[int]:
    """S when every leaf of ``params`` carries a leading slot axis, else None."""
    return params.w.shape[0] if params.w.dim() == 3 else None


def flatten_state(x: torch.Tensor, S: Optional[int], trailing: int = 1) -> torch.Tensor:
    """``(..., *tail)`` -> ``(S, B, *tail)`` (``S = 1`` without a slot axis)."""
    tail = tuple(x.shape[x.dim() - trailing:])
    return x.reshape((S or 1, -1) + tail)


def drive_of(ext: Optional[torch.Tensor], w_in: torch.Tensor, S: Optional[int]):
    """The external drive ``ext @ w_in`` as ``(S, B, n)`` (one batched matmul,
    left to cuBLAS in full f32 as the reference leaves it to XLA)."""
    if ext is None:
        return None
    return flatten_state(ext, S) @ w_in


def fused_lif_step(lif_state: LIFState, spikes: torch.Tensor, params,
                   ext: Optional[torch.Tensor], *, mode: str = "fixed_leak",
                   surrogate: bool = False) -> LIFState:
    """``network.step(backend="pallas")``'s datapath: kernel B1 on the
    arriving spikes, with the drive computed outside."""
    if surrogate:
        raise NotImplementedError(_INFERENCE_ONLY.format("pallas"))
    S = slot_count(params)
    shape = lif_state.v.shape
    lif = params.lif
    out = _lif_kernel.fused_lif_step(
        flatten_state(spikes, S), params.w, params.c,
        flatten_state(lif_state.v, S), flatten_state(lif_state.r, S),
        drive_of(ext, params.w_in, S),
        lif.v_th, lif.leak, lif.r_ref, lif.gain, lif.i_bias, lif.v_reset, mode=mode)
    return LIFState(v=out.v.reshape(shape), r=out.r.reshape(shape),
                    y=out.y.reshape(shape))


def fused_lif_step_slots(lif_state: LIFState, spikes: torch.Tensor, params,
                         ext: Optional[torch.Tensor], *, mode: str = "fixed_leak",
                         surrogate: bool = False) -> LIFState:
    """Slot-batched :func:`fused_lif_step`: every leaf carries a leading
    slot axis S, which the kernel takes as a launch-grid dimension."""
    if slot_count(params) is None:
        raise ValueError("fused_lif_step_slots needs (S, n, n) weights")
    return fused_lif_step(lif_state, spikes, params, ext, mode=mode, surrogate=surrogate)


def fused_tick(state, params, ext: Optional[torch.Tensor], *,
               wc: Optional[torch.Tensor] = None, delays: Optional[torch.Tensor] = None,
               mode: str = "fixed_leak", surrogate: bool = False,
               ring_out: Optional[torch.Tensor] = None) -> Tuple[LIFState, torch.Tensor]:
    """``TickEngine``'s ``"pallas_fused"`` datapath: one launch of kernel B2.

    Args:
      wc: the premasked ``W*C`` (frozen path, hoisted by the caller); None
        streams ``params.w`` and ``params.c``.
      delays: optional per-synapse delays ``(n, n)`` int32 in ``[1, D]``.
      ring_out: where the new ring goes when ``D > 1``: ``state.delay_buf``
        itself to write in place (no per-synapse delays only), a spare
        buffer of the same shape, or None for a fresh one.

    Returns ``(lif_state', delay_buf')``; the ring comes back unchanged when
    ``D == 1``, as in the reference.
    """
    if surrogate:
        raise NotImplementedError(_INFERENCE_ONLY.format("pallas_fused"))
    S = slot_count(params)
    shape = state.lif.v.shape
    D = state.delay_buf.shape[-2]
    tick = state.tick
    # The ring pointers stay on the device (the TPU kernel's scalar prefetch).
    slots = torch.stack([torch.remainder(tick, D), torch.remainder(tick + 1, D)]).to(
        torch.int32)
    ring = flatten_state(state.delay_buf, S, trailing=2)
    if delays is None and D == 1:
        read = flatten_state(state.lif.y, S).unsqueeze(-2)   # the ring is y itself
    else:
        read = ring
    dly_full = ring if D > 1 else None
    dly_out = None
    if dly_full is not None and ring_out is not None:
        dly_out = dly_full if ring_out is state.delay_buf else flatten_state(
            ring_out, S, trailing=2)
    lif = params.lif
    v, r, y, ring2 = _tick_kernel.fused_tick(
        slots, read, params.w if wc is None else wc, params.c if wc is None else None,
        None if delays is None else delays.to(torch.int32),
        flatten_state(state.lif.v, S), flatten_state(state.lif.r, S),
        drive_of(ext, params.w_in, S), dly_full,
        lif.v_th, lif.leak, lif.r_ref, lif.gain, lif.i_bias, lif.v_reset,
        mode=mode, dly_out=dly_out)
    out = LIFState(v=v.reshape(shape), r=r.reshape(shape), y=y.reshape(shape))
    if ring2 is None:
        return out, state.delay_buf
    return out, ring2.reshape(state.delay_buf.shape)
