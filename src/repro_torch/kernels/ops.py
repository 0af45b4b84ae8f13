"""State bridges between the engine's records and the kernel wrappers.

Counterpart of ``repro.kernels.ops`` (``spike_matmul``, ``fused_lif_step``,
``fused_tick``, ``fused_lif_step_slots``, and the event backend's ``EventFanIn``,
``event_synaptic_input``, ``event_spike_matmul`` and ``event_lif_step``).
The reference pads every operand to block multiples here; the port's
kernels bounds-check their ragged edges, so the bridges only reshape
(views, no copies): the batch dimensions flatten to ``B``, and a slot
axis, when the parameters carry one, stays in front. The reference's
``fused_stdp_step`` bridge is only padding, so the port has none:
:func:`repro_torch.plasticity.rules.plasticity_step` calls kernel B5's
wrapper directly.

The event bridges build the spike list on the device by a stable
compaction (ascending spiking ids, then the sentinel ``K``), the order the
reference's tie-stable ``lax.top_k`` gives, with no host round trip. Where
the reference branches with ``lax.cond`` (overflow fallback, adaptive
knee), the port launches the dense kernel B1 and the event kernel every
tick behind one device flag: the one whose gate is open writes the tick.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.lif import LIFParams, LIFState, lif_step
from repro_torch.kernels import event_dispatch as _event_kernel
from repro_torch.kernels import lif_step as _lif_kernel
from repro_torch.kernels import spike_matmul as _sm_kernel
from repro_torch.kernels import tick_fused as _tick_kernel
from repro_torch.kernels.ref import LIFStepOut, event_gather_sum

OVERFLOW = ("fallback", "strict", "unchecked")
KERNELS = ("db", "grid")

_INFERENCE_ONLY = "{} backend is inference-only; use backend='jnp' to train"


def spike_matmul(s: torch.Tensor, w: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``s @ (w*c)`` as (B, N) f32 through kernel B6 (its twin on CPU
    tensors). The reference pads every operand to its blocks here; B6
    bounds-checks its ragged edges, so nothing is copied."""
    return _sm_kernel.spike_matmul(s, w, c)


def row_params(lif: LIFParams, slotted: bool) -> LIFParams:
    """Per-slot rows ``(S, n)`` broadcast against ``(S, B, n)`` as ``(S, 1, n)``."""
    if not slotted:
        return lif
    return LIFParams(**{f.name: getattr(lif, f.name).unsqueeze(-2)
                        for f in dataclasses.fields(LIFParams)})


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
    arriving spikes (0 or 1, which the kernel's fused multiply-add needs to
    round as the twin does), with the drive computed outside."""
    if surrogate:
        raise ValueError(_INFERENCE_ONLY.format("pallas"))
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
        raise ValueError(_INFERENCE_ONLY.format("pallas_fused"))
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


# -- the event backend ---------------------------------------------------------


class EventOverflowError(RuntimeError):
    """``overflow="strict"``: a row spiked more times than the spike list holds."""


@dataclasses.dataclass(frozen=True)
class EventFanIn:
    """Padded fan-in lists on the device (the event backend's gather layout).

    ``idx[m, j]`` is the j-th presynaptic source of postsynaptic neuron
    ``m`` (ascending, 0-padded); ``mask`` gates the padding to 0. Either may
    carry a leading slot axis ``(S, n, cap)``. Built once per topology from
    :func:`repro_torch.core.connectivity.padded_fan_in`; like the connection
    list it is runtime data.
    """

    idx: torch.Tensor     # (n, cap) int32
    mask: torch.Tensor    # (n, cap) float32

    @classmethod
    def from_padded(cls, nbrs, device=None) -> "EventFanIn":
        """From a :class:`~repro_torch.core.connectivity.PaddedNeighbors`
        (``device=None``: the card)."""
        from repro_torch import device as _device

        if nbrs.axis != "in":
            raise ValueError(
                f"EventFanIn needs fan-in lists (axis='in'), got {nbrs.axis!r}")
        dev = _device.resolve(device)
        return cls(idx=torch.as_tensor(np.asarray(nbrs.idx), dtype=torch.int32, device=dev),
                   mask=torch.as_tensor(np.asarray(nbrs.mask), dtype=torch.float32,
                                        device=dev))

    @classmethod
    def from_dense(cls, c, cap: Optional[int] = None, device=None) -> "EventFanIn":
        """From a connection list (numpy or a tensor; ``device=None``: ``c``'s
        device when it is a tensor, else the card)."""
        from repro_torch.core import connectivity
        from repro_torch.core.dispatch_policy import _host

        if device is None:
            device = getattr(c, "device", None)
        return cls.from_padded(connectivity.padded_fan_in(_host(c) > 0, cap), device=device)


def default_k_active(n: int) -> int:
    """Default spike-slot budget for the top-k event path: n/8, floored at 8
    (:func:`repro_torch.core.dispatch_policy.resolve_k_active`)."""
    from repro_torch.core.dispatch_policy import resolve_k_active

    return resolve_k_active(n, None)


def spike_list(s: torch.Tensor, k: int):
    """The spike list of each row of ``s`` (``(..., K)``), on the device.

    Returns ``(idx, counts, n_spiking)``: ``idx`` ``(..., k)`` int32 holds
    the first ``k`` spiking ids in ascending order, then the sentinel ``K``;
    ``counts`` the live slots (``min(n_spiking, k)``); ``n_spiking`` every
    row's spike count. A stable compaction (cumulative sum, then a scatter
    into a ``(..., k+1)`` buffer whose last slot takes the rest), so nothing
    is read back to the host; rows past ``k`` truncate as the reference's
    ``top_k`` does.
    """
    K = s.shape[-1]
    live = s > 0
    n_spiking = live.sum(-1, dtype=torch.int32)
    pos = torch.cumsum(live, -1, dtype=torch.int32) - 1
    target = torch.where(live & (pos < k), pos, k).long()
    buf = torch.full(s.shape[:-1] + (k + 1,), K, dtype=torch.int32, device=s.device)
    ids = torch.arange(K, dtype=torch.int32, device=s.device).expand(s.shape)
    buf.scatter_(-1, target, ids)      # the spare slot k takes every other id
    return buf[..., :k].contiguous(), torch.clamp_max(n_spiking, k), n_spiking


def fan_in_edges(wc: torch.Tensor, fan_in: EventFanIn) -> torch.Tensor:
    """The per-edge weights ``wc[idx[m, j], m] * mask[m, j]``, ``(S?, n, cap)``
    (hoisted out of the tick loop on the frozen path)."""
    n = wc.shape[-1]
    cols = torch.arange(n, device=wc.device).unsqueeze(-1)
    idx = fan_in.idx.long()
    if wc.dim() == 3:
        slot = torch.arange(wc.shape[0], device=wc.device).reshape(-1, 1, 1)
        edges = wc[slot, idx, cols]
    else:
        edges = wc[idx, cols]
    return edges * fan_in.mask


def fan_in_product(s: torch.Tensor, w_edges: torch.Tensor, fan_in: EventFanIn) -> torch.Tensor:
    """The fan-in gather: ``syn[..., m] = sum_j s[..., idx[m, j]] * w_edges[m, j]``.

    ``s`` is ``(..., K)`` with shared lists, or ``(S, B, K)`` with per-slot
    lists ``(S, n, cap)``."""
    idx = fan_in.idx.long()
    s = s.to(torch.float32)
    if idx.dim() == 2:
        return torch.einsum("...nc,nc->...n", s[..., idx], w_edges.to(torch.float32))
    S, B, K = s.shape
    n, cap = idx.shape[-2:]
    gathered = torch.gather(s.unsqueeze(-2).expand(S, B, n, K), -1,
                            idx.unsqueeze(1).expand(S, B, n, cap))
    return torch.einsum("sbnc,snc->sbn", gathered, w_edges.to(torch.float32))


def _per_slot(flag: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A 0-d or per-slot ``(S,)`` flag shaped to broadcast against ``like``
    (``(S, B, N)`` with a slot axis)."""
    return flag.reshape(flag.shape + (1,) * (like.dim() - flag.dim()))


def network_over(n_spiking: torch.Tensor, k: int, S: Optional[int]) -> torch.Tensor:
    """Each network's overflow flag from its rows' spike counts ``(S, B)``: a
    row spiked more than ``k`` times. ``(S,)`` with a slot axis, else 0-d."""
    over = (n_spiking > k).any(-1)
    return over.squeeze(0) if S is None else over


def _overflow_check(over: torch.Tensor, k: int, flag: Optional[torch.Tensor]) -> None:
    """``overflow="strict"``: fold ``over`` (any slot's) into ``flag`` on the
    device, or, without a flag, raise at once (a host read)."""
    over = over.any()
    if flag is not None:
        flag.logical_or_(over)
    elif bool(over):
        raise EventOverflowError(f"event dispatch overflow: spiking rows > k_active={k}")


def event_synaptic_input(s: torch.Tensor, wc: torch.Tensor, *,
                         k_active: Optional[int] = None,
                         fan_in: Optional[EventFanIn] = None,
                         overflow: str = "fallback",
                         w_edges: Optional[torch.Tensor] = None,
                         take_dense: Optional[torch.Tensor] = None,
                         overflow_flag: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Event-driven synaptic input, the plain version of the event tick.

    * top-k spike list (default): the (at most ``k_active``) spiking rows of
      each batch row, in ascending order, gathered from ``wc`` and added one
      at a time (:func:`repro_torch.kernels.ref.event_gather_sum`).
    * fan-in gather (``fan_in`` given): every postsynaptic neuron reads its
      padded in-edge list; ``w_edges`` is the hoisted
      :func:`fan_in_edges` (derived here when None).

    ``s`` is ``(..., K)`` against ``wc`` ``(K, N)``, or ``(S, B, K)`` against
    ``(S, K, N)``. ``overflow`` (top-k only) is what happens when a row
    spikes more than ``k_active`` times: ``"fallback"`` takes the dense
    product, ``"strict"`` raises :class:`EventOverflowError` (or, given
    ``overflow_flag``, a 0-d device bool, sets it and lets the caller raise
    later), ``"unchecked"`` truncates. ``take_dense`` (a device bool: 0-d,
    or ``(S,)`` against per-slot ``wc``) forces the dense product, as the
    adaptive knee does. Each network decides for itself, as under the
    reference's ``vmap``: with a slot axis a slot goes dense only when one
    of its own rows overflows.
    """
    if fan_in is not None:
        return fan_in_product(s, fan_in_edges(wc, fan_in) if w_edges is None else w_edges,
                              fan_in)
    if overflow not in OVERFLOW:
        raise ValueError(f"unknown overflow mode {overflow!r}; have {OVERFLOW}")
    from repro_torch.core.dispatch_policy import resolve_k_active

    k = resolve_k_active(s.shape[-1], k_active)
    idx, counts, n_spiking = spike_list(s, k)
    syn = event_gather_sum(idx, counts, wc, walk="live")
    over = ((n_spiking > k).flatten(1).any(-1) if wc.dim() == 3
            else (n_spiking > k).any())
    if overflow == "strict":
        _overflow_check(over, k, overflow_flag)
    elif overflow == "fallback":
        take_dense = over if take_dense is None else take_dense | over
    if take_dense is None:
        return syn
    return torch.where(_per_slot(take_dense, syn), s.to(torch.float32) @ wc.to(torch.float32),
                       syn)


def event_spike_matmul(s: torch.Tensor, w: torch.Tensor, c: torch.Tensor, *, k_active: int,
                       overflow: str = "fallback") -> torch.Tensor:
    """``s @ (w * c)`` through the spike-list gather, exact at any rate
    under ``overflow="fallback"`` (see :func:`event_synaptic_input`)."""
    wc = w * c.to(w.dtype)
    return event_synaptic_input(s, wc, k_active=k_active, overflow=overflow)


def event_drive(ext: Optional[torch.Tensor], w_in: torch.Tensor, S: Optional[int],
                ext_diag: bool):
    """The external drive as ``(S, B, n)``: ``ext @ w_in``, or with
    ``ext_diag`` the elementwise ``ext * diag(w_in)``, bit-identical when
    ``w_in`` is diagonal (adding exact zeros changes no bit)."""
    if ext is None or not ext_diag:
        return drive_of(ext, w_in, S)
    diag = torch.diagonal(w_in, dim1=-2, dim2=-1)
    return flatten_state(ext, S) * (diag.unsqueeze(-2) if diag.dim() == 2 else diag)


def event_lif_step(lif_state: LIFState, spikes: torch.Tensor, params, ext: Optional[torch.Tensor],
                   wc: torch.Tensor, *, k_active: Optional[int] = None,
                   fan_in: Optional[EventFanIn] = None, overflow: str = "fallback",
                   mode: str = "fixed_leak", surrogate: bool = False, ext_diag: bool = False,
                   use_kernel: Optional[bool] = None, kernel: Optional[str] = None,
                   w_edges: Optional[torch.Tensor] = None,
                   wc_sentinel: Optional[torch.Tensor] = None,
                   take_dense: Optional[torch.Tensor] = None,
                   overflow_flag: Optional[torch.Tensor] = None, with_over: bool = False):
    """``TickEngine(backend="event")``'s datapath: synaptic input from the
    spike list (or the fan-in lists), drive, LIF step.

    ``use_kernel`` (default: the top-k path without ``surrogate``) runs the
    top-k path through kernel B3 (``kernel="db"``, the default) or B4
    (``"grid"``), whose wrappers run their plain twin on CPU tensors. When
    the tick may go dense -- ``overflow="fallback"`` with a row past
    ``k_active``, or ``take_dense`` from the adaptive knee -- kernel B1 runs
    on the premasked ``wc`` behind the same device flag, and exactly one of
    the two writes the tick. The flag is per network: 0-d, or ``(S,)`` with
    a slot axis, where each slot's blocks read their own. B4 reads
    ``wc_sentinel``, ``wc`` with an
    all-zero row appended (built here when None). The fan-in gather and the
    ``use_kernel=False`` path are plain PyTorch (:func:`event_synaptic_input`).
    ``w_edges``, ``overflow_flag``: see :func:`event_synaptic_input`.

    Returns the new :class:`LIFState`; with ``with_over`` the pair
    ``(state, over)``, ``over`` each network's device bool (0-d, or ``(S,)``
    with a slot axis) that a row spiked past ``k_active`` on the top-k path,
    in every overflow mode, as the reference's telemetry counts it (None on
    the fan-in gather, which cannot overflow).
    """
    if use_kernel is None:
        use_kernel = fan_in is None and not surrogate
    S = slot_count(params)
    shape = lif_state.v.shape
    drive = event_drive(ext, params.w_in, S, ext_diag)
    flat = lambda a: flatten_state(a, S)
    s = flat(spikes)
    if not use_kernel:
        syn = event_synaptic_input(s, wc, k_active=k_active, fan_in=fan_in,
                                   overflow=overflow, w_edges=w_edges,
                                   take_dense=take_dense, overflow_flag=overflow_flag)
        if drive is not None:
            syn = syn + drive
        st = LIFState(v=flat(lif_state.v), r=flat(lif_state.r), y=flat(lif_state.y))
        out = lif_step(st, syn, row_params(params.lif, S is not None), mode=mode,
                       surrogate=surrogate)
        new = LIFState(v=out.v.reshape(shape), r=out.r.reshape(shape), y=out.y.reshape(shape))
        if not with_over:
            return new
        over = None
        if fan_in is None:
            from repro_torch.core.dispatch_policy import resolve_k_active

            k = resolve_k_active(s.shape[-1], k_active)
            over = network_over((s > 0).sum(-1), k, S)
        return new, over
    if surrogate:
        raise ValueError("event kernel path is inference-only; use the jnp path to train")
    kernel = "db" if kernel is None else kernel
    if kernel not in KERNELS:
        raise ValueError(f"kernel must be 'db' or 'grid', got {kernel!r}")
    if overflow not in OVERFLOW:
        raise ValueError(f"unknown overflow mode {overflow!r}; have {OVERFLOW}")
    from repro_torch.core.dispatch_policy import resolve_k_active

    k = resolve_k_active(s.shape[-1], k_active)
    idx, counts, n_spiking = spike_list(s, k)
    over = network_over(n_spiking, k, S)
    gate = take_dense
    if overflow == "fallback":
        gate = over if gate is None else gate | over
    elif overflow == "strict":
        _overflow_check(over, k, overflow_flag)
    lif = params.lif
    rows = (lif.v_th, lif.leak, lif.r_ref, lif.gain, lif.i_bias, lif.v_reset)
    v, r = flat(lif_state.v), flat(lif_state.r)
    out = None
    if gate is not None:
        out = LIFStepOut(v=torch.empty_like(v), r=torch.empty_like(r), y=torch.empty_like(v))
        _lif_kernel.fused_lif_step(s, wc, None, v, r, drive, *rows, mode=mode,
                                   run_if=gate, out=out)
    if kernel == "db":
        res = _event_kernel.event_lif_dispatch_db(idx, wc, v, r, drive, *rows, counts=counts,
                                                  mode=mode, skip=gate, out=out)
    else:
        if wc_sentinel is None:
            wc_sentinel = sentinel_rows(wc)
        res = _event_kernel.event_lif_dispatch(idx, wc_sentinel, v, r, drive, *rows,
                                               mode=mode, skip=gate, out=out)
    new = LIFState(v=res.v.reshape(shape), r=res.r.reshape(shape), y=res.y.reshape(shape))
    return (new, over) if with_over else new


def sentinel_rows(wc: torch.Tensor) -> torch.Tensor:
    """``wc`` with the all-zero sentinel row appended: ``(..., K+1, N)``, the
    operand kernel B4 reads (built once per rollout by the engine)."""
    return torch.nn.functional.pad(wc, (0, 0, 0, 1))
