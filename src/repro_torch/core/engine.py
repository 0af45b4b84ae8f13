"""TickEngine: ONE tick body behind every rollout flavour.

Counterpart of ``repro.core.engine``. The tick -- delay
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
``"event"``               event-driven dispatch: the spike-list gather
                          (kernel B3, ``csrc/event_dispatch.cu``; B4 with
                          ``event_kernel="grid"``), the fan-in gather or the
                          dense product, as ``event_dispatch`` says
========================  =================================================

On CPU tensors the kernel backends run their kernels' plain twins, which is
how the parity tests reach them.

The frozen rollout hoists ``W*C`` once, outside the tick loop. A learning
rollout carries the mutable ``w`` instead: every tick streams it and ``c``
into the tick (kernel B2 or B1, or ``w*c`` on ``jnp``), then runs the
plasticity hook -- kernel B5 (``csrc/stdp_update.cu``) on the kernel
backends, its plain twin on ``jnp``. ``scan`` is a Python loop over ticks
with no host sync inside: the tick counter, the ring pointers, the rewards
and the ``learn_until`` gate stay on the device, and the raster is written
into a preallocated ``(T, ..., n)`` tensor.

The event arm's ``lax.cond``s (overflow fallback, adaptive knee) become a
device flag: kernel B1 and the event kernel both launch, and the flag opens
exactly one of them, so the tick loop still never reads back to the host.
The hysteresis bit rides the carry as a device bool. ``overflow="strict"``
accumulates a device flag and raises once, after the loop.

``telemetry=True`` carries a :class:`~repro_torch.obs.telemetry.TickTelemetry`
through the loop: every tick, on every backend, one launch of the telemetry
kernel folds the post-tick state, the event arm's overflow and knee flags and
the plasticity pass's dw statistics into it on the device (kernel B5 writes
those statistics only when asked, so with telemetry off every kernel runs as
before and the telemetry kernel never launches). ``rollout`` and
``learning_rollout`` then return it last, as the reference's do.

``surrogate=True`` (surrogate-gradient BPTT) runs on ``"jnp"`` and on the
event backend's plain path; the kernel backends raise the reference's
``ValueError`` ("inference-only") at the tick.

``mesh`` (a :class:`~repro_torch.parallel.mesh.SNNMesh`) shards the fabric by
destination columns over a world of ranks: ``scan`` and everything that goes
through it (``rollout``, ``learning_rollout``, ``chunk``) run
:func:`repro_torch.parallel.snn_sharding.sharded_scan` on this rank's
operands, and the tick body all-gathers the arriving spikes before the
backend dispatch (DESIGN.md §15).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from repro_torch.core import dispatch_policy
from repro_torch.core.lif import LIFParams, lif_step
from repro_torch.core.network_types import SNNParams, SNNState, masked_weights
from repro_torch.kernels import ops, ref
from repro_torch.kernels import telemetry as telemetry_kernel
from repro_torch.obs import tracing
from repro_torch.obs.telemetry import TickTelemetry
from repro_torch.plasticity import rules as plasticity_rules
from repro_torch.plasticity.stdp import PlasticityState

_BACKENDS = ("jnp", "pallas", "pallas_fused", "event")
_MODES = ("fixed_leak", "euler", "int")
_OVERFLOW = ops.OVERFLOW
_DISPATCH = ("auto", "fan_in", "topk", "dense")


@dataclasses.dataclass(frozen=True)
class TickCarry:
    """What one tick hands the next.

    Attributes:
      state: the network state (LIF + delay line + tick counter).
      plast: plasticity traces and eligibility, or None on the frozen path.
      w: the mutable weight matrix, or None on the frozen path (frozen
        weights stay in the parameters, so the hoisted ``W*C`` is valid for
        the whole rollout).
      telem: the :class:`~repro_torch.obs.telemetry.TickTelemetry`
        accumulators (the state's batch shape), or None when the engine's
        ``telemetry`` option is off.
      policy: the adaptive knee's hysteresis bit on the device, one per
        network as the reference's ``vmap`` keeps it: a 0-d bool, or an
        ``(S,)`` bool with a slot axis. None when no knee is armed. True
        means the previous tick of that network took the dense arm for
        speed.
    """

    state: SNNState
    plast: Optional[PlasticityState] = None
    w: Optional[torch.Tensor] = None
    telem: Optional[TickTelemetry] = None
    policy: Optional[torch.Tensor] = None


@dataclasses.dataclass(frozen=True)
class EngineOptions:
    """The engine's configuration, validated at construction.

    Same field names, defaults and checks as the reference.

    ``plasticity`` (a :class:`~repro_torch.plasticity.stdp.PlasticityParams`)
    arms the plasticity hook for carries that hold weights;
    ``plasticity_backend`` picks its backend and defaults to following
    ``backend`` (``"pallas_fused"`` and ``"event"`` map to the ``"pallas"``
    pass, kernel B5; the reference maps ``"event"`` to its jnp pass).

    The ``event_*`` fields configure ``backend="event"``: the spike budget
    (``event_k_active``, default ``n // 8`` floored at 8), what an overflowing
    tick does (``event_overflow``), the strategy (``event_dispatch``: ``"auto"``
    is the fan-in gather when neighbour lists are given, else the spike
    list), the adaptive knee and its release fraction, and the elementwise
    diagonal drive. ``event_kernel`` (the port's own field) picks the
    spike-list kernel: ``"db"`` (B3, the default) or ``"grid"`` (B4).

    ``mesh`` (a :class:`~repro_torch.parallel.mesh.SNNMesh`) runs ``scan`` and
    everything that goes through it on this rank's shard of the fabric, cut
    by destination columns (:mod:`repro_torch.parallel.snn_sharding`; its
    operands and results are the rank's own). ``shard_axis`` names the mesh
    axis (None: the mesh's first), checked against the mesh; set without
    ``mesh`` it only marks the options ``sharded``, as in the reference. The
    engine that runs inside a shard is the :class:`TickEngine` given a
    ``gather`` mesh.
    """

    mode: str = "fixed_leak"
    surrogate: bool = False
    backend: str = "jnp"
    plasticity: Optional[Any] = None
    plasticity_backend: Optional[str] = None
    telemetry: bool = False
    mesh: Optional[Any] = None
    shard_axis: Optional[str] = None
    event_k_active: Optional[int] = None
    event_overflow: str = "fallback"
    event_dispatch: str = "auto"
    event_knee: Optional[int] = None
    event_hysteresis: float = 0.75
    event_ext_diag: bool = False
    event_kernel: str = "db"

    def __post_init__(self):
        if self.backend not in _BACKENDS:
            raise ValueError(f"backend must be one of {_BACKENDS}, got {self.backend!r}")
        if self.mode not in _MODES:
            raise ValueError(f"mode must be one of {_MODES}, got {self.mode!r}")
        if self.plasticity_backend not in (None,) + _BACKENDS:
            raise ValueError(f"plasticity_backend must be None or one of {_BACKENDS}, "
                             f"got {self.plasticity_backend!r}")
        if self.event_overflow not in _OVERFLOW:
            raise ValueError(f"event_overflow must be one of {_OVERFLOW}, "
                             f"got {self.event_overflow!r}")
        if self.event_dispatch not in _DISPATCH:
            raise ValueError(f"event_dispatch must be one of {_DISPATCH}, "
                             f"got {self.event_dispatch!r}")
        if self.event_kernel not in ops.KERNELS:
            raise ValueError(f"event_kernel must be one of {ops.KERNELS}, "
                             f"got {self.event_kernel!r}")
        if self.event_k_active is not None and int(self.event_k_active) < 1:
            raise ValueError(f"event_k_active must be >= 1 (or None for the n//8 "
                             f"default), got {self.event_k_active}")
        if self.event_knee is not None:
            if int(self.event_knee) < 1:
                raise ValueError(f"event_knee must be >= 1 ticks' spikes (or None to "
                                 f"disable the adaptive knee), got {self.event_knee}")
            if self.event_overflow != "fallback":
                raise ValueError(
                    "event_knee requires event_overflow='fallback' (the knee routes "
                    "overflow ticks to the dense arm silently, which contradicts "
                    "strict/unchecked semantics)")
        if not (0.0 < float(self.event_hysteresis) <= 1.0):
            raise ValueError("event_hysteresis is a release *fraction* of the knee and "
                             f"must lie in (0, 1], got {self.event_hysteresis}")
        if self.mesh is not None:
            # Checked by what the engine calls on it, so the core imports no
            # mesh module.
            if not all(callable(getattr(self.mesh, a, None))
                       for a in ("all_gather", "all_reduce", "columns")):
                raise ValueError(f"mesh must be a repro_torch.parallel.mesh.SNNMesh, "
                                 f"got {type(self.mesh)}")
            axis = self.shard_axis if self.shard_axis is not None else self.mesh.axis
            if axis not in self.mesh.axis_names:
                raise ValueError(f"shard_axis {axis!r} is not a mesh axis "
                                 f"(axes: {self.mesh.axis_names})")
        if self.sharded and self.event_ext_diag:
            raise ValueError(
                "event_ext_diag is unavailable on the sharded path: each shard holds "
                "a rectangular (n_in, n/D) slice of w_in whose diagonal is NOT the "
                "diagonal drive; the full ext @ w_in product is rectangular-safe, "
                "use that")

    @property
    def sharded(self) -> bool:
        """True when the options name a partition of the fabric: a ``mesh``
        or, as in the reference, a ``shard_axis``."""
        return self.mesh is not None or self.shard_axis is not None

    def resolved_shard_axis(self) -> Optional[str]:
        """The mesh axis the fabric shards over (None when unsharded)."""
        if self.shard_axis is not None:
            return self.shard_axis
        if self.mesh is not None:
            return self.mesh.axis_names[0]
        return None

    def effective_backend(self) -> str:
        """The backend the tick body dispatches to.

        Sharded ``"pallas_fused"`` remaps to ``"pallas"``: the whole-tick
        kernel B2 couples the ring's width to the state's inside one launch
        and so cannot span the per-tick spike all-gather; kernel B1 (ring
        read and write outside) composes with it unchanged. On the frozen
        path the weights live on the dyadic u8 grid, where every f32 sum
        order is exact, so the two arms are bitwise equal; learning pushes
        weights off the grid, so remapped learning equals single-device
        ``"pallas"`` bitwise and the whole-tick kernel to the ulp. (A
        one-rank mesh skips the remap: see ``sharded_scan``. The tick body
        itself remaps by its ``gather``: see :class:`TickEngine`.)"""
        if self.sharded and self.backend == "pallas_fused":
            return "pallas"
        return self.backend

    def plasticity_pass(self) -> str:
        """The plasticity hook's backend: ``"pallas"`` (kernel B5) or ``"jnp"``
        (its plain twin)."""
        pb = self.plasticity_backend or self.backend
        return "pallas" if pb in ("pallas_fused", "event") else pb

    def _event_strategy(self, neighbors) -> str:
        """Resolve ``event_dispatch`` against what the call provided."""
        strategy = self.event_dispatch
        if strategy == "auto":
            strategy = "fan_in" if neighbors is not None else "topk"
        if strategy == "fan_in" and neighbors is None:
            raise ValueError(
                "event_dispatch='fan_in' needs fan-in neighbor lists: pass "
                "neighbors=EventFanIn.from_dense(c) (or let dispatch_policy.plan "
                "build them)")
        return strategy


@dataclasses.dataclass(frozen=True)
class EventPrep:
    """The event arm's operands, prepared once per rollout.

    Attributes:
      strategy: ``"topk"``, ``"fan_in"`` or ``"dense"``.
      k: the spike budget (:func:`~repro_torch.core.dispatch_policy.resolve_k_active`).
      fan_in: the fan-in lists with int64 indices (``"fan_in"`` only).
      w_edges: the per-edge weights, hoisted on the frozen path.
      sentinel: ``W*C`` with the all-zero row kernel B4 reads, hoisted on
        the frozen path (``event_kernel="grid"``; a learning tick pads its
        own ``W*C``).
      overflow_flag: 0-d device bool set by an overflowing tick under
        ``event_overflow="strict"``.
    """

    strategy: str
    k: int
    fan_in: Optional[ops.EventFanIn] = None
    w_edges: Optional[torch.Tensor] = None
    sentinel: Optional[torch.Tensor] = None
    overflow_flag: Optional[torch.Tensor] = None


class TickEngine:
    """The resident tick datapath, configured by :class:`EngineOptions`.

    ``gather`` (the :class:`~repro_torch.parallel.mesh.SNNMesh` of a shard,
    set by ``sharded_scan`` for its inner engine) makes the tick body
    all-gather the arriving spikes over the mesh before the synaptic
    product, and remaps ``"pallas_fused"`` to ``"pallas"`` (see
    :meth:`EngineOptions.effective_backend`): it alone marks the engine that
    runs inside a shard."""

    def __init__(self, options: Optional[EngineOptions] = None, *, gather=None):
        if options is not None and not isinstance(options, EngineOptions):
            raise TypeError(f"options must be an EngineOptions, got {type(options)}")
        self.options = options if options is not None else EngineOptions()
        self.gather = gather
        backend = self.options.backend
        self.backend = "pallas" if gather is not None and backend == "pallas_fused" else backend

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
        plastic_c: Optional[torch.Tensor] = None,
        learn_until: Optional[torch.Tensor] = None,
        in_place: bool = False,
        neighbors: Optional[ops.EventFanIn] = None,
        event: Optional[EventPrep] = None,
        traced: bool = False,
    ) -> Tuple[TickCarry, torch.Tensor]:
        """One synchronous tick: delay-line read -> synaptic input -> LIF
        step -> delay-line write [-> plasticity hook].

        Args:
          xs: ``(ext, reward)``: this tick's drive and dopamine (0-d, or
            ``(S,)`` per slot); either may be None.
          wc: the premasked ``W*C`` hoisted by :meth:`scan` (frozen path);
            None derives it (from the carried ``w`` when learning).
          delays: optional per-synapse delays ``(n, n)`` int in ``[1, D]``.
          ring_out: ``"pallas_fused"`` only -- the buffer the kernel writes the
            new ring into (see :func:`repro_torch.kernels.ops.fused_tick`);
            None leaves the input ring untouched.
          plastic_c: the learnable-synapse mask (default ``params.c``).
          learn_until: optional device int32 tick bound, 0-d or ``(S,)``: the
            plasticity hook commits nothing from that tick on.
          in_place: the caller owns the carry's ``w``, ``plast.elig`` and
            ``telem`` and lets kernel B5 and the telemetry kernel update them
            in their buffers (:meth:`scan` does); otherwise the carry given
            is never written.
          neighbors: the ``"event"`` backend's fan-in lists
            (:class:`~repro_torch.kernels.ops.EventFanIn`); ignored by the
            dense backends.
          event: the event arm's operands as :meth:`scan` prepares them once
            per rollout; None prepares them for this tick alone.
          traced: label the tick's regions for a running profiler
            (:func:`repro_torch.obs.tracing.trace_scope`; :meth:`scan` asks
            once per rollout whether one runs).
        """
        ext, reward = xs
        opts = self.options
        st = carry.state
        backend = self.backend
        learning = carry.w is not None
        # A learning tick streams this tick's w and c into the kernels.
        p = dataclasses.replace(params, w=carry.w) if learning else params
        D = st.delay_buf.shape[-2]

        if backend == "pallas_fused":
            with tracing.trace_scope("tick/pallas_fused", traced):
                lif_state, delay_buf = ops.fused_tick(
                    st, p, ext, wc=wc, delays=delays, mode=opts.mode,
                    surrogate=opts.surrogate, ring_out=ring_out)
            state2 = SNNState(lif=lif_state, delay_buf=delay_buf, tick=st.tick + 1)
            return self._tick_tail(carry, st, state2, reward, params, plastic_c,
                                   learn_until, in_place, traced=traced)

        S = ops.slot_count(params)
        slot = torch.remainder(st.tick, D)
        if wc is None and (delays is not None or backend != "pallas"):
            wc = masked_weights(p)
        policy = flags = s_pre = None
        if delays is None:
            arriving = (st.delay_buf.index_select(-2, slot.reshape(1).long()).squeeze(-2)
                        if D > 1 else st.lif.y)
            if self.gather is not None:
                # The cross-shard spike exchange, the one collective a tick:
                # every rank reduces its columns over the full fan-in in the
                # single-device order. It sits before the event arm's knee,
                # so every rank's device gates see the same spikes. Learning
                # reads the gathered spikes as the presynaptic events.
                with tracing.trace_scope("tick/spike_all_gather", traced):
                    arriving = s_pre = self.gather.all_gather(arriving)
            if backend == "pallas":
                with tracing.trace_scope("tick/pallas", traced):
                    lif_state = ops.fused_lif_step(st.lif, arriving, p, ext,
                                                   mode=opts.mode, surrogate=opts.surrogate)
            elif backend == "event":
                if event is None:
                    event = self.prepare_event(params, wc, neighbors, learning=learning)
                with tracing.trace_scope(f"tick/event/{event.strategy}", traced):
                    lif_state, policy, flags = self._event_tick(carry, st, arriving, ext,
                                                                params, wc, event)
            else:
                with tracing.trace_scope("tick/jnp", traced):
                    # (the int datapath emits int32 spikes; the product is f32)
                    syn = ops.flatten_state(arriving, S).to(wc.dtype) @ wc
                    lif_state = self._lif(st, syn, params, ext, S)
        else:
            # Per-synapse delays: the reference einsum, on every backend but
            # pallas_fused (per-delay history planes defeat one spike list).
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
        if policy is not None:
            carry = dataclasses.replace(carry, policy=policy)
        return self._tick_tail(carry, st, state2, reward, params, plastic_c,
                               learn_until, in_place, flags=flags, traced=traced,
                               s_pre=s_pre)

    # -- the event arm -------------------------------------------------------

    def prepare_event(self, params: SNNParams, wc: Optional[torch.Tensor], neighbors, *,
                      learning: bool, w_edges: Optional[torch.Tensor] = None) -> EventPrep:
        """The event arm's per-rollout operands: the strategy and spike budget,
        the fan-in lists with int64 indices and (frozen) the per-edge
        weights (the caller's ``w_edges`` when given), kernel B4's
        sentinel-row operand, the strict-overflow flag."""
        opts = self.options
        strategy = opts._event_strategy(neighbors)
        n = params.w.shape[-2]
        k = dispatch_policy.resolve_k_active(n, opts.event_k_active)
        dev = params.w.device
        fan_in = edges = sentinel = flag = None
        if strategy == "fan_in":
            fan_in = ops.EventFanIn(idx=neighbors.idx.long(), mask=neighbors.mask)
            if not learning:
                edges = ops.fan_in_edges(wc, fan_in) if w_edges is None else w_edges
        elif strategy == "topk":
            if opts.event_kernel == "grid" and not learning:
                sentinel = ops.sentinel_rows(wc)
            if opts.event_overflow == "strict":
                flag = torch.zeros((), dtype=torch.bool, device=dev)
        return EventPrep(strategy=strategy, k=k, fan_in=fan_in, w_edges=edges,
                         sentinel=sentinel, overflow_flag=flag)

    def _event_tick(self, carry: TickCarry, st: SNNState, arriving: torch.Tensor,
                    ext: Optional[torch.Tensor], params: SNNParams, wc: torch.Tensor,
                    ev: EventPrep):
        """The event backend's synaptic input + LIF step; returns
        ``(lif_state, hysteresis bit or None, telemetry flags or None)``.

        The flags, taken only when the carry holds telemetry, are each
        network's ``(over, take_dense)`` device bools as the reference counts
        them: on the top-k path a row past ``k_active`` in every overflow
        mode, and with the knee its gate; nothing on ``fan_in`` and
        ``dense``."""
        opts = self.options
        S = ops.slot_count(params)
        if ev.strategy == "dense":
            # The masked product with the (possibly diagonal) drive: bitwise
            # the jnp tick.
            syn = ops.flatten_state(arriving, S).to(wc.dtype) @ wc
            drive = ops.event_drive(ext, params.w_in, S, opts.event_ext_diag)
            return (self._lif(st, syn if drive is None else syn + drive, params, None, S),
                    None, None)
        kw = dict(mode=opts.mode, surrogate=opts.surrogate, ext_diag=opts.event_ext_diag,
                  kernel=opts.event_kernel)
        if ev.strategy == "fan_in":
            return ops.event_lif_step(st.lif, arriving, params, ext, wc, fan_in=ev.fan_in,
                                      w_edges=ev.w_edges, **kw), None, None
        counted = opts.telemetry and carry.telem is not None
        if opts.event_knee is None:
            out = ops.event_lif_step(st.lif, arriving, params, ext, wc, k_active=ev.k,
                                     overflow=opts.event_overflow, wc_sentinel=ev.sentinel,
                                     overflow_flag=ev.overflow_flag, with_over=counted, **kw)
            return (out[0], None, (out[1], None)) if counted else (out, None, None)
        # The adaptive knee: past min(knee, k) spikes in a row the dense arm is
        # the faster exact one; once dense, stay dense until the count falls
        # to hysteresis * knee. Overflow (m > k) must go dense for the bits.
        # Each network decides for itself, as under the reference's vmap: m,
        # the bit and the gate are (S,) with a slot axis, 0-d without.
        m = (ops.flatten_state(arriving, S) > 0).sum(-1).amax(-1)
        if S is None:
            m = m.squeeze(0)
        hi = min(int(opts.event_knee), ev.k)
        lo = int(hi * opts.event_hysteresis)
        prev = (carry.policy if carry.policy is not None
                else torch.zeros_like(m, dtype=torch.bool))
        dense_mode = (m > hi) | (prev & (m > lo))
        take_dense = (m > ev.k) | dense_mode
        out = ops.event_lif_step(st.lif, arriving, params, ext, wc, k_active=ev.k,
                                 overflow="unchecked", wc_sentinel=ev.sentinel,
                                 take_dense=take_dense, with_over=counted, **kw)
        policy = dense_mode if carry.policy is not None else None
        if counted:
            return out[0], policy, (out[1], take_dense)
        return out, policy, None

    def _tick_tail(self, carry: TickCarry, st: SNNState, state2: SNNState, reward,
                   params: SNNParams, plastic_c, learn_until, in_place: bool,
                   flags=None, traced: bool = False,
                   s_pre: Optional[torch.Tensor] = None) -> Tuple[TickCarry, torch.Tensor]:
        """The plasticity hook (when the carry holds weights), the telemetry
        fold (when it holds telemetry) and the new carry.

        ``s_pre`` defaults to ``st.lif.y``, the previous tick's emissions (what
        arrives with ``max_delay == 1``, which learning requires); a shard's
        tick passes the gathered full-width spikes instead, so the pass sees
        the whole presynaptic axis against its local columns. ``s_post`` is
        this tick's. The hook runs after the tick kernel, as its own pass over
        ``(w, elig, traces)``; the ``learn_until`` gate is folded into it.
        With telemetry it also hands back the committed delta's ``|dw|`` and
        ``dw^2`` sums, and one launch of the telemetry kernel folds them, the
        post-tick state and the event arm's ``flags`` (``(over,
        take_dense)``) into the accumulators.
        """
        y = state2.lif.y
        opts = self.options
        telem = carry.telem if opts.telemetry else None
        new = {"state": state2}
        dw = None
        if carry.w is not None and opts.plasticity is not None:
            with tracing.trace_scope("tick/plasticity", traced):
                out = plasticity_rules.plasticity_step(
                    carry.plast, st.lif.y if s_pre is None else s_pre, y, carry.w,
                    params.c if plastic_c is None else plastic_c, opts.plasticity, reward,
                    backend=opts.plasticity_pass(),
                    tick=None if learn_until is None else st.tick, learn_until=learn_until,
                    in_place=in_place, dw_stats=telem is not None)
            new.update(plast=out[0], w=out[1])
            dw = out[2] if telem is not None else None
        if telem is not None:
            over, take_dense = flags or (None, None)
            if not in_place:
                new["telem"] = telem = telem.clone()
            telemetry_kernel.tick_telemetry(telem, y, state2.lif.v, state2.lif.r, over=over,
                                            take_dense=take_dense, dw_stats=dw)
        return dataclasses.replace(carry, **new), y

    def _lif(self, st: SNNState, syn: torch.Tensor, params: SNNParams,
             ext: Optional[torch.Tensor], S: Optional[int]):
        """Drive + plain LIF step on the flattened ``(S, B, n)`` sum."""
        drive = ops.drive_of(ext, params.w_in, S)
        if drive is not None:
            syn = syn + drive
        shape = st.lif.v.shape
        flat = dataclasses.replace(
            st.lif, **{f: ops.flatten_state(getattr(st.lif, f), S) for f in "vry"})
        out = lif_step(flat, syn, ops.row_params(params.lif, S is not None),
                       mode=self.options.mode, surrogate=self.options.surrogate)
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
        rewards: Optional[torch.Tensor] = None,
        delays: Optional[torch.Tensor] = None,
        plastic_c: Optional[torch.Tensor] = None,
        learn_until=None,
        neighbors: Optional[ops.EventFanIn] = None,
        wc: Optional[torch.Tensor] = None,
        w_edges: Optional[torch.Tensor] = None,
        owned: bool = False,
    ) -> Tuple[TickCarry, torch.Tensor]:
        """Run ``n_ticks`` ticks (``len(ext_seq)`` when given); returns
        ``(final_carry, raster)`` with the raster ``(T, ..., n)``.

        Frozen carries (``carry0.w is None``) get ``W*C`` hoisted once for
        the loop, or use the caller's ``wc`` (and on the event backend's
        fan-in path its per-edge weights ``w_edges``), which must equal what
        the hoist would compute: a caller that keeps them resident across
        calls (the continuous server) passes them. Learning carries stream
        their ``w`` every tick; ``rewards`` is ``(T,)`` or, per slot,
        ``(T, S)``. The caller's tensors are never written: on
        ``"pallas_fused"`` with ``D > 1`` the loop owns its ring buffers
        (kernel B2 writes the new spikes into the one ring in place, or with
        per-synapse delays into a second buffer, the two alternating tick by
        tick), and a learning loop on kernel B5 clones ``w`` and ``elig``
        once and then updates them in place. ``owned=True`` hands the loop
        the carry's ``w``, ``plast.elig`` and ``telem`` to update in their
        buffers instead, with no clone: the caller owns them and reads them
        back from the returned carry.

        On ``"event"`` the arm's operands are prepared once here
        (:meth:`prepare_event`), the knee's hysteresis bit is seeded into
        the carry, and ``event_overflow="strict"`` raises
        :class:`~repro_torch.kernels.ops.EventOverflowError` after the loop
        if any tick overflowed.

        With ``telemetry`` the carry's accumulators are cloned (a chunk goes
        on from them) or seeded at zero with the state's batch shape, one per
        slot on a slot axis, and the loop folds every tick into them in
        place. Whether a profiler runs is asked once, here.

        With ``mesh`` set the whole scan runs on this rank's shard instead
        (:func:`repro_torch.parallel.snn_sharding.sharded_scan`): the operands
        and results are the rank's own, the hoisted ``W*C`` is the local slab.
        """
        opts = self.options
        if opts.mesh is not None:
            from repro_torch.parallel import snn_sharding

            return snn_sharding.sharded_scan(
                self, params, carry0, ext_seq, n_ticks, rewards=rewards, delays=delays,
                plastic_c=plastic_c, learn_until=learn_until, neighbors=neighbors, wc=wc,
                w_edges=w_edges, owned=owned)
        backend = self.backend
        T = int(n_ticks) if ext_seq is None else int(ext_seq.shape[0])
        learning = carry0.w is not None
        if learning:
            wc = None
        elif wc is None and (backend != "pallas" or delays is not None):
            wc = masked_weights(params)
        state = carry0.state
        D = state.delay_buf.shape[-2]
        fused_ring = backend == "pallas_fused" and D > 1
        spare = None
        if fused_ring:
            state = dataclasses.replace(state, delay_buf=state.delay_buf.clone())
            if delays is not None:
                spare = torch.empty_like(state.delay_buf)
        carry = dataclasses.replace(carry0, state=state)
        event = None
        if backend == "event" and delays is None:
            event = self.prepare_event(params, wc, neighbors, learning=learning,
                                       w_edges=w_edges)
            if (opts.event_knee is not None and event.strategy == "topk"
                    and carry.policy is None):
                S = ops.slot_count(params)
                carry = dataclasses.replace(carry, policy=torch.zeros(
                    () if S is None else (S,), dtype=torch.bool, device=state.tick.device))
        if opts.telemetry:
            v0 = state.lif.v
            telem = carry.telem
            if telem is None:
                telem = TickTelemetry.zeros(v0.shape[:-1], device=v0.device)
            elif not owned:
                telem = telem.clone()
            carry = dataclasses.replace(carry, telem=telem)
        if (learning and not owned and opts.plasticity is not None
                and opts.plasticity_pass() == "pallas"):
            # B5 leaves elig untouched under rule="stdp": only R-STDP writes it.
            elig = carry.plast.elig
            if opts.plasticity.rule == "rstdp":
                elig = elig.clone()
            plast = dataclasses.replace(carry.plast, elig=elig)
            carry = dataclasses.replace(carry, w=carry.w.clone(), plast=plast)
        if learn_until is not None:
            learn_until = torch.as_tensor(learn_until, dtype=torch.int32,
                                          device=state.tick.device)
        y0 = state.lif.y
        raster = torch.empty((T,) + tuple(y0.shape), dtype=y0.dtype, device=y0.device)
        traced = tracing.profiling()
        for t in range(T):
            ext = None if ext_seq is None else ext_seq[t]
            reward = None if rewards is None else rewards[t]
            ring_in = carry.state.delay_buf
            ring_out = None
            if fused_ring:
                ring_out = ring_in if delays is None else spare
            carry, y = self.tick_body(carry, (ext, reward), params=params, wc=wc,
                                      delays=delays, ring_out=ring_out,
                                      plastic_c=plastic_c, learn_until=learn_until,
                                      in_place=True, neighbors=neighbors, event=event,
                                      traced=traced)
            if fused_ring and delays is not None:
                spare = ring_in
            raster[t] = y
        if event is not None and event.overflow_flag is not None and bool(event.overflow_flag):
            # The loop's only host read, after the last tick.
            raise ops.EventOverflowError(
                f"event dispatch overflow: a row spiked more than k_active={event.k} "
                "times on at least one tick")
        return carry, raster

    # -- entry points --------------------------------------------------------

    def tick(self, state: SNNState, params: SNNParams,
             ext: Optional[torch.Tensor] = None, *,
             delays: Optional[torch.Tensor] = None,
             neighbors: Optional[ops.EventFanIn] = None) -> SNNState:
        """One frozen-weight tick (the public ``network.step`` semantics): a
        one-tick :meth:`scan`."""
        if self.options.mesh is not None:
            raise ValueError(
                "tick() is single-device; the sharded engine runs through "
                "scan()/rollout()/chunk() (a 1-tick chunk() is the sharded single tick)")
        final, _ = self.scan(params, TickCarry(state=state),
                             None if ext is None else ext.unsqueeze(0), 1, delays=delays,
                             neighbors=neighbors)
        return final.state

    def rollout(self, params: SNNParams, state: SNNState,
                ext_seq: Optional[torch.Tensor], n_ticks: int, *,
                delays: Optional[torch.Tensor] = None,
                neighbors: Optional[ops.EventFanIn] = None):
        """Frozen-weight rollout; returns ``(final_state, raster)``, and the
        :class:`~repro_torch.obs.telemetry.TickTelemetry` third with the
        ``telemetry`` option."""
        final, raster = self.scan(params, TickCarry(state=state), ext_seq, n_ticks,
                                  delays=delays, neighbors=neighbors)
        if self.options.telemetry:
            return final.state, raster, final.telem
        return final.state, raster

    def _learning_defaults(self, params: SNNParams, rewards, plastic_c, n_ticks: int,
                           device, what: str):
        """Rewards default to zeros, the plastic mask to ``params.c``."""
        if rewards is None:
            rewards = torch.zeros((n_ticks,), dtype=torch.float32, device=device)
        if plastic_c is None:
            if params.c is None:
                raise ValueError(
                    f"{what} with c=None (implicit all-to-all) needs an explicit "
                    "plastic_c mask (pass torch.ones((n, n)) to learn every synapse)")
            plastic_c = params.c
        return rewards, plastic_c

    def learning_rollout(self, params: SNNParams, state: SNNState,
                         plast_state: PlasticityState, ext_seq: Optional[torch.Tensor],
                         n_ticks: int, *, rewards: Optional[torch.Tensor] = None,
                         plastic_c: Optional[torch.Tensor] = None, learn_until=None,
                         neighbors: Optional[ops.EventFanIn] = None):
        """Learning rollout: the carry holds mutable weights; returns
        ``((final_state, final_plast_state, final_w), raster)``, and the
        telemetry third with the ``telemetry`` option.

        ``learn_until`` (0-d or per slot ``(S,)``) freezes the plasticity hook
        from that tick on -- see :meth:`tick_body`. The caller's ``params.w``
        and ``plast_state`` are never written."""
        if self.options.plasticity is None:
            raise ValueError("learning_rollout needs a TickEngine with plasticity set")
        if state.delay_buf.shape[-2] != 1:
            raise ValueError(
                "learning_rollout requires max_delay == 1 (pair STDP reads the "
                "previous tick's spikes as the presynaptic events)")
        rewards, plastic_c = self._learning_defaults(
            params, rewards, plastic_c, n_ticks, state.tick.device, "learning")
        carry0 = TickCarry(state=state, plast=plast_state, w=params.w)
        final, raster = self.scan(params, carry0, ext_seq, n_ticks, rewards=rewards,
                                  plastic_c=plastic_c, learn_until=learn_until,
                                  neighbors=neighbors)
        if self.options.telemetry:
            return (final.state, final.plast, final.w), raster, final.telem
        return (final.state, final.plast, final.w), raster

    def init_learning_carry(self, params: SNNParams, state: SNNState,
                            plast_state: PlasticityState) -> TickCarry:
        """The chunk-resumable carry of a fresh learning run (pairs with
        :meth:`chunk`)."""
        return TickCarry(state=state, plast=plast_state, w=params.w)

    def chunk(self, params: SNNParams, carry: TickCarry,
              ext_seq: Optional[torch.Tensor], n_ticks: int, *,
              rewards: Optional[torch.Tensor] = None,
              delays: Optional[torch.Tensor] = None,
              plastic_c: Optional[torch.Tensor] = None,
              learn_until=None,
              neighbors: Optional[ops.EventFanIn] = None,
              wc: Optional[torch.Tensor] = None,
              w_edges: Optional[torch.Tensor] = None,
              owned: bool = False) -> Tuple[TickCarry, torch.Tensor]:
        """``n_ticks`` more ticks from an existing carry: K chunks of T ticks
        equal one rollout of K*T ticks (the tick counter, traces, weights and
        telemetry ride the carry). On learning carries ``rewards`` default to
        zeros and ``plastic_c`` to ``params.c``. ``wc``, ``w_edges`` and
        ``owned``: see :meth:`scan` (by default the caller's carry is never
        written)."""
        if carry.w is not None:
            rewards, plastic_c = self._learning_defaults(
                params, rewards, plastic_c, n_ticks, carry.state.tick.device,
                "a learning chunk")
        return self.scan(params, carry, ext_seq, n_ticks, rewards=rewards,
                         delays=delays, plastic_c=plastic_c, learn_until=learn_until,
                         neighbors=neighbors, wc=wc, w_edges=w_edges, owned=owned)

