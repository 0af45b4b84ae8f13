"""TickEngine: ONE tick body behind every rollout flavour.

Counterpart of ``repro.core.engine`` for frozen weights. The tick -- delay
line read, masked synaptic accumulation (the mux fabric), LIF update, delay
line write -- exists only in :meth:`TickEngine.tick_body`, and the backend
is decided in exactly one branch there. The reference's backend names carry
over unchanged, so ``ModelConfig.snn_backend`` values mean the same:

========================  =================================================
``"jnp"``                 the plain PyTorch tick (the reference's jnp arm)
``"pallas"``              kernel B1, the fused masked product + LIF step
                          (``csrc/lif_step.cu``); the ring read and write
                          stay outside, as in the reference
``"pallas_fused"``        kernel B2, the whole tick in one launch
                          (``csrc/tick_fused.cu``)
``"event"``               not ported yet: raises (ROADMAP A.7)
========================  =================================================

On CPU tensors the kernel backends run their kernels' plain twins, which is
how the parity tests reach them.

The frozen rollout hoists ``W*C`` once, outside the tick loop. ``scan`` is
a Python loop over ticks with no host sync inside: the tick counter and the
ring pointers stay on the device, and the raster is written into a
preallocated ``(T, ..., n)`` tensor.

Learning (plasticity), telemetry, the sharded mesh and the event backend
arrive with later slices; asking for them raises ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from repro_torch.core.lif import LIFParams, lif_step
from repro_torch.core.network_types import SNNParams, SNNState, masked_weights
from repro_torch.kernels import ops, ref

_BACKENDS = ("jnp", "pallas", "pallas_fused", "event")
_MODES = ("fixed_leak", "euler", "int")
LATER = {
    "event": "the event backend arrives with the event slice (ROADMAP A.7)",
    "plasticity": "plasticity arrives with the STDP slice (ROADMAP A.8)",
    "telemetry": "telemetry arrives with the observability slice (ROADMAP A.9)",
    "mesh": "the sharded fabric arrives with the sharding slice (ROADMAP A.11)",
    "surrogate": "surrogate-gradient training arrives with the classifier slice "
                 "(ROADMAP A.5)",
}


@dataclasses.dataclass(frozen=True)
class TickCarry:
    """What one tick hands the next. The reference's learning (``plast``,
    ``w``), telemetry and knee-policy slots arrive with their slices."""

    state: SNNState


@dataclasses.dataclass(frozen=True)
class EngineOptions:
    """The engine's configuration, validated at construction.

    Same field names and defaults as the reference; the fields of slices
    not ported yet raise ``NotImplementedError`` when set.
    """

    mode: str = "fixed_leak"
    surrogate: bool = False
    backend: str = "jnp"
    plasticity: Optional[Any] = None
    telemetry: bool = False
    mesh: Optional[Any] = None
    event_k_active: Optional[int] = None
    event_overflow: str = "fallback"
    event_dispatch: str = "auto"
    event_knee: Optional[int] = None
    event_hysteresis: float = 0.75
    event_ext_diag: bool = False

    def __post_init__(self):
        if self.backend not in _BACKENDS:
            raise ValueError(f"backend must be one of {_BACKENDS}, got {self.backend!r}")
        if self.mode not in _MODES:
            raise ValueError(f"mode must be one of {_MODES}, got {self.mode!r}")
        event_defaults = (None, "fallback", "auto", None, 0.75, False)
        event_fields = (self.event_k_active, self.event_overflow, self.event_dispatch,
                        self.event_knee, self.event_hysteresis, self.event_ext_diag)
        if self.backend == "event" or event_fields != event_defaults:
            raise NotImplementedError(LATER["event"])
        for name in ("plasticity", "telemetry", "mesh", "surrogate"):
            if getattr(self, name) not in (None, False):
                raise NotImplementedError(LATER[name])


def _row_params(lif: LIFParams, slotted: bool) -> LIFParams:
    """Per-slot rows ``(S, n)`` broadcast against ``(S, B, n)`` as ``(S, 1, n)``."""
    if not slotted:
        return lif
    return LIFParams(**{f.name: getattr(lif, f.name).unsqueeze(-2)
                        for f in dataclasses.fields(LIFParams)})


class TickEngine:
    """The resident tick datapath, configured by :class:`EngineOptions`."""

    def __init__(self, options: Optional[EngineOptions] = None):
        if options is not None and not isinstance(options, EngineOptions):
            raise TypeError(f"options must be an EngineOptions, got {type(options)}")
        self.options = options if options is not None else EngineOptions()

    def masked_weights(self, params: SNNParams) -> torch.Tensor:
        """``W*C``; ``w`` itself for the implicit all-to-all (``c=None``)."""
        return masked_weights(params)

    # -- the single tick body ---------------------------------------------

    def tick_body(
        self,
        carry: TickCarry,
        xs: Tuple[Optional[torch.Tensor], Optional[torch.Tensor]],
        *,
        params: SNNParams,
        wc: Optional[torch.Tensor] = None,
        delays: Optional[torch.Tensor] = None,
        ring_out: Optional[torch.Tensor] = None,
    ) -> Tuple[TickCarry, torch.Tensor]:
        """One synchronous tick: delay-line read -> synaptic input -> LIF
        step -> delay-line write.

        Args:
          xs: ``(ext, reward)``; ``reward`` belongs to learning and must be None.
          wc: the premasked ``W*C`` hoisted by :meth:`scan`; None derives it.
          delays: optional per-synapse delays ``(n, n)`` int in ``[1, D]``.
          ring_out: ``"pallas_fused"`` only -- the buffer the kernel writes the
            new ring into (see :func:`repro_torch.kernels.ops.fused_tick`);
            None leaves the input ring untouched.
        """
        ext, reward = xs
        if reward is not None:
            raise NotImplementedError(LATER["plasticity"])
        opts = self.options
        st = carry.state
        backend = opts.backend
        if params.c is None and backend in ("pallas", "pallas_fused"):
            raise ValueError(
                "c=None (implicit all-to-all) needs the jnp backend: the kernels "
                "take c as an explicit operand")
        D = st.delay_buf.shape[-2]

        if backend == "pallas_fused":
            lif_state, delay_buf = ops.fused_tick(
                st, params, ext, wc=wc, delays=delays, mode=opts.mode,
                ring_out=ring_out)
            state2 = SNNState(lif=lif_state, delay_buf=delay_buf, tick=st.tick + 1)
            return TickCarry(state=state2), lif_state.y

        S = ops.slot_count(params)
        slot = torch.remainder(st.tick, D)
        if wc is None and (delays is not None or backend != "pallas"):
            wc = masked_weights(params)
        if delays is None:
            arriving = (st.delay_buf.index_select(-2, slot.reshape(1).long()).squeeze(-2)
                        if D > 1 else st.lif.y)
            if backend == "pallas":
                lif_state = ops.fused_lif_step(st.lif, arriving, params, ext,
                                               mode=opts.mode)
            else:
                # (the int datapath emits int32 spikes; the product is f32)
                syn = ops.flatten_state(arriving, S).to(wc.dtype) @ wc
                lif_state = self._lif(st, syn, params, ext, S)
        else:
            # Per-synapse delays: the reference einsum, on every dense backend.
            ring = ops.flatten_state(st.delay_buf, S, trailing=2)
            syn = ref.delayed_product(ring, slot, wc, delays)
            lif_state = self._lif(st, syn, params, ext, S)

        # Delay-line write: fresh spikes land at tick + 1 (one-tick minimum).
        if D > 1:
            write = torch.remainder(st.tick + 1, D).reshape(1).long()
            fresh = lif_state.y.to(st.delay_buf.dtype).unsqueeze(-2)
            delay_buf = st.delay_buf.index_copy(-2, write, fresh)
        else:
            delay_buf = st.delay_buf
        state2 = SNNState(lif=lif_state, delay_buf=delay_buf, tick=st.tick + 1)
        return TickCarry(state=state2), lif_state.y

    def _lif(self, st: SNNState, syn: torch.Tensor, params: SNNParams,
             ext: Optional[torch.Tensor], S: Optional[int]):
        """Drive + plain LIF step on the flattened ``(S, B, n)`` sum."""
        drive = ops.drive_of(ext, params.w_in, S)
        if drive is not None:
            syn = syn + drive
        shape = st.lif.v.shape
        flat = dataclasses.replace(
            st.lif, **{f: ops.flatten_state(getattr(st.lif, f), S) for f in "vry"})
        out = lif_step(flat, syn, _row_params(params.lif, S is not None),
                       mode=self.options.mode)
        return dataclasses.replace(
            out, **{f: getattr(out, f).reshape(shape) for f in "vry"})

    # -- tick loop ---------------------------------------------------------

    def scan(
        self,
        params: SNNParams,
        carry0: TickCarry,
        ext_seq: Optional[torch.Tensor],
        n_ticks: int,
        *,
        delays: Optional[torch.Tensor] = None,
    ) -> Tuple[TickCarry, torch.Tensor]:
        """Run ``n_ticks`` ticks (``len(ext_seq)`` when given); returns
        ``(final_carry, raster)`` with the raster ``(T, ..., n)``.

        ``W*C`` is hoisted once for the loop. On ``"pallas_fused"`` with
        ``D > 1`` the loop owns its ring buffers (the caller's state is never
        written): without per-synapse delays kernel B2 writes the new spikes
        into the one ring in place; with them it writes into a second buffer,
        and the two alternate tick by tick.
        """
        opts = self.options
        T = int(n_ticks) if ext_seq is None else int(ext_seq.shape[0])
        wc = None
        if opts.backend != "pallas" or delays is not None:
            wc = masked_weights(params)
        state = carry0.state
        D = state.delay_buf.shape[-2]
        fused_ring = opts.backend == "pallas_fused" and D > 1
        spare = None
        if fused_ring:
            state = dataclasses.replace(state, delay_buf=state.delay_buf.clone())
            if delays is not None:
                spare = torch.empty_like(state.delay_buf)
        carry = dataclasses.replace(carry0, state=state)
        y0 = state.lif.y
        raster = torch.empty((T,) + tuple(y0.shape), dtype=y0.dtype, device=y0.device)
        for t in range(T):
            ext = None if ext_seq is None else ext_seq[t]
            ring_in = carry.state.delay_buf
            ring_out = None
            if fused_ring:
                ring_out = ring_in if delays is None else spare
            carry, y = self.tick_body(carry, (ext, None), params=params, wc=wc,
                                      delays=delays, ring_out=ring_out)
            if fused_ring and delays is not None:
                spare = ring_in
            raster[t] = y
        return carry, raster

    # -- entry points --------------------------------------------------------

    def tick(self, state: SNNState, params: SNNParams,
             ext: Optional[torch.Tensor] = None, *,
             delays: Optional[torch.Tensor] = None) -> SNNState:
        """One frozen-weight tick (the public ``network.step`` semantics)."""
        carry, _ = self.tick_body(TickCarry(state=state), (ext, None),
                                  params=params, delays=delays)
        return carry.state

    def rollout(self, params: SNNParams, state: SNNState,
                ext_seq: Optional[torch.Tensor], n_ticks: int, *,
                delays: Optional[torch.Tensor] = None):
        """Frozen-weight rollout; returns ``(final_state, raster)``."""
        final, raster = self.scan(params, TickCarry(state=state), ext_seq, n_ticks,
                                  delays=delays)
        return final.state, raster

    def learning_rollout(self, *args, **kwargs):
        raise NotImplementedError(LATER["plasticity"])

    def chunk(self, params: SNNParams, carry: TickCarry,
              ext_seq: Optional[torch.Tensor], n_ticks: int, *,
              delays: Optional[torch.Tensor] = None) -> Tuple[TickCarry, torch.Tensor]:
        """``n_ticks`` more ticks from an existing carry: K chunks of T ticks
        equal one rollout of K*T ticks (the tick counter rides the carry)."""
        return self.scan(params, carry, ext_seq, n_ticks, delays=delays)
