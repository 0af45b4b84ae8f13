"""The SNN processor core: all-to-all network and its rollout wrappers.

Counterpart of ``repro.core.network``. One call to :func:`step` is one
synchronous network tick; :func:`rollout` runs many. The tick itself lives
only in :meth:`repro_torch.core.engine.TickEngine.tick_body`; everything
here builds an engine and threads a carry through it.

``dispatch=`` picks the event backend's strategy: a
:class:`~repro_torch.core.dispatch_policy.DispatchPlan`, ``"auto"`` (plan
here from ``params.c`` and ``params.w_in``, read on the host once), or a
strategy string (``"fan_in"``, ``"topk"``, ``"dense"``). ``telemetry=True``
appends a :class:`~repro_torch.obs.telemetry.TickTelemetry` to what
:func:`rollout` and :func:`learning_rollout` return, as the reference's do.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.core.engine import EngineOptions, TickCarry, TickEngine  # noqa: F401
from repro_torch.core.lif import LIFParams
from repro_torch.core.network_types import (  # noqa: F401 (re-exports)
    SNNParams, SNNState, synaptic_input,
)


def _resolve_dispatch(dispatch, params: SNNParams, state: SNNState, neighbors):
    """Turn ``dispatch`` into engine options (+ fan-in lists): a
    :class:`~repro_torch.core.dispatch_policy.DispatchPlan` is used as it is,
    ``"auto"`` plans here from ``params.c`` / ``params.w_in`` at the state's
    batch size, and a strategy string goes to ``event_dispatch``."""
    from repro_torch.core import dispatch_policy

    if isinstance(dispatch, dispatch_policy.DispatchPlan):
        plan = dispatch
    elif dispatch == "auto":
        batch = 1
        for d in state.lif.v.shape[:-1]:
            batch *= int(d)
        plan = dispatch_policy.plan(params.c, w_in=params.w_in, batch=batch)
    else:
        return dict(backend="event", event_dispatch=str(dispatch)), neighbors
    if neighbors is None:
        neighbors = plan.neighbors
    return plan.engine_kwargs(), neighbors


def _build_engine(options: Optional[EngineOptions], kw, dispatch, params, state, neighbors):
    """The one engine-construction point of the wrappers: ``options`` wins
    over the per-call keywords in ``kw``, and a ``dispatch`` policy lays its
    event options over either."""
    dkw = {}
    if dispatch is not None:
        dkw, neighbors = _resolve_dispatch(dispatch, params, state, neighbors)
    if options is not None:
        if not isinstance(options, EngineOptions):
            raise TypeError(f"options must be an EngineOptions, got {type(options)}")
        opts = dataclasses.replace(options, **dkw)
    else:
        opts = EngineOptions(**{**kw, **dkw})
    return TickEngine(opts), neighbors


def step(state: SNNState, params: SNNParams, ext: Optional[torch.Tensor] = None, *,
         mode: str = "fixed_leak", surrogate: bool = False,
         delays: Optional[torch.Tensor] = None, backend: str = "jnp", neighbors=None,
         dispatch=None, options: Optional[EngineOptions] = None) -> SNNState:
    """One synchronous network tick (``ext``: this tick's drive ``(..., n_in)``).

    ``neighbors`` (an :class:`~repro_torch.kernels.ops.EventFanIn`) switches the
    ``"event"`` backend to its fan-in gather; ``dispatch``: see the module
    docstring."""
    eng, neighbors = _build_engine(options, dict(mode=mode, surrogate=surrogate,
                                                 backend=backend),
                                   dispatch, params, state, neighbors)
    return eng.tick(state, params, ext, delays=delays, neighbors=neighbors)


def rollout(params: SNNParams, state: SNNState, ext_seq: Optional[torch.Tensor],
            n_ticks: int, *, mode: str = "fixed_leak", surrogate: bool = False,
            delays: Optional[torch.Tensor] = None, backend: str = "jnp", neighbors=None,
            telemetry: bool = False, dispatch=None,
            options: Optional[EngineOptions] = None):
    """Run ``n_ticks`` ticks; returns ``(final_state, raster)``.

    ``ext_seq`` is ``(n_ticks, ..., n_in)`` or None; the raster is
    ``(n_ticks, ..., n)``. ``W*C`` is hoisted out of the tick loop.
    ``neighbors`` / ``dispatch``: see :func:`step`. ``telemetry=True``
    returns ``(final_state, raster, telemetry)``, the accumulators of
    :class:`~repro_torch.obs.telemetry.TickTelemetry` with the state's batch
    shape; off by default, and when off every kernel runs as without it.
    ``options`` supersedes the per-call keywords.
    """
    eng, neighbors = _build_engine(options, dict(mode=mode, surrogate=surrogate,
                                                 backend=backend, telemetry=telemetry),
                                   dispatch, params, state, neighbors)
    return eng.rollout(params, state, ext_seq, n_ticks, delays=delays, neighbors=neighbors)


def learning_rollout(params: SNNParams, state: SNNState, plast_state,
                     ext_seq: Optional[torch.Tensor], n_ticks: int, *,
                     plasticity=None, rewards: Optional[torch.Tensor] = None,
                     plastic_c: Optional[torch.Tensor] = None, mode: str = "fixed_leak",
                     backend: str = "jnp", plasticity_backend: Optional[str] = None,
                     neighbors=None, telemetry: bool = False, dispatch=None,
                     options: Optional[EngineOptions] = None):
    """Run ``n_ticks`` learning ticks: the carry holds the mutable weights.

    Each tick runs the inference datapath with the current weights, then the
    plasticity hook on the spikes that tick produced (``s_pre`` the previous
    tick's emissions, ``max_delay == 1``; ``s_post`` this tick's). Weights
    stay gated by ``plastic_c`` and clipped to the u8 register domain, so the
    result serialises straight back through a ``RegisterBank``.

    Args:
      plast_state: initial :class:`~repro_torch.plasticity.stdp.PlasticityState`
        with batch dims matching ``state``.
      plasticity: the :class:`~repro_torch.plasticity.stdp.PlasticityParams`
        (or set in ``options``).
      rewards: ``(n_ticks,)`` dopamine on the device; None means zeros.
      plastic_c: learnable-synapse mask; defaults to ``params.c``.
      backend / plasticity_backend: as in the reference; the plasticity
        backend follows ``backend`` by default (``"pallas_fused"``,
        ``"pallas"`` and ``"event"`` run kernel B5, ``"jnp"`` its plain twin).
      neighbors, dispatch: the event backend's fan-in lists and strategy
        (see :func:`step`).
      telemetry: True appends a
        :class:`~repro_torch.obs.telemetry.TickTelemetry` to the result (its
        ``dw_l1`` / ``dw_sq`` sum the committed weight updates).

    Returns ``((final_state, final_plast_state, final_w), raster)``, plus a
    trailing telemetry element with ``telemetry=True``. The caller's
    ``params.w`` and ``plast_state`` are never written.
    """
    if (isinstance(options, EngineOptions) and options.plasticity is None
            and plasticity is not None):
        options = dataclasses.replace(options, plasticity=plasticity,
                                      plasticity_backend=plasticity_backend)
    eng, neighbors = _build_engine(
        options, dict(mode=mode, backend=backend, plasticity=plasticity,
                      plasticity_backend=plasticity_backend, telemetry=telemetry),
        dispatch, params, state, neighbors)
    return eng.learning_rollout(params, state, plast_state, ext_seq, n_ticks,
                                rewards=rewards, plastic_c=plastic_c, neighbors=neighbors)


def forward_layered(params: SNNParams, spikes_in: torch.Tensor, layer_sizes,
                    n_ticks: Optional[int] = None, *, mode: str = "fixed_leak",
                    surrogate: bool = False, backend: str = "jnp",
                    time_major: bool = False) -> Tuple[torch.Tensor, SNNState]:
    """The paper's inference pattern: drive the input layer for ``n_ticks``
    (default ``depth + 1``), read the output layer's spikes.

    ``time_major=True``: ``spikes_in`` is a spike train ``(n_ticks, ..., n_in)``;
    False: one drive ``(..., n_in)`` clamped over every tick. (The reference's
    deprecated shape heuristic for ``time_major=None`` is not ported.)
    Returns ``(output raster (n_ticks, ..., n_out), final state)``.
    """
    n = params.w.shape[0]
    if n_ticks is None:
        n_ticks = len(layer_sizes) + 1
    if time_major:
        if spikes_in.dim() < 2 or spikes_in.shape[0] != n_ticks:
            raise ValueError(
                "time_major spikes_in needs a leading time axis of length "
                f"n_ticks={n_ticks}; got shape {tuple(spikes_in.shape)}")
        ext_seq = spikes_in
        batch_shape = spikes_in.shape[1:-1]
    else:
        ext_seq = spikes_in.unsqueeze(0).expand((n_ticks,) + tuple(spikes_in.shape))
        batch_shape = spikes_in.shape[:-1]
    state = SNNState.zeros(batch_shape, n, dtype=params.w.dtype, device=params.w.device)
    eng = TickEngine(EngineOptions(mode=mode, surrogate=surrogate, backend=backend))
    final, raster = eng.rollout(params, state, ext_seq, n_ticks)
    return raster[..., n - layer_sizes[-1]:], final


def params_from_registers(bank, *, dtype=torch.float32, device=None) -> SNNParams:
    """Runtime parameters straight from a :class:`RegisterBank` image.

    The per-neuron weight layout broadcasts each postsynaptic neuron's
    weight byte across its fan-in; the per-synapse layout uses the matrix.
    """
    dev = _device.resolve(device)
    n = bank.n
    c = bank.get_connection_list().astype(np.float32)
    if bank.weights.ndim == 1:
        w = np.broadcast_to(bank.weights.astype(np.float32)[None, :], (n, n)).copy()
    else:
        w = bank.weights.astype(np.float32)
    as_t = lambda a, dt=dtype: torch.as_tensor(np.asarray(a), dtype=dt, device=dev)
    lif = LIFParams(
        v_th=as_t(bank.thresholds),
        leak=as_t(bank.leak),
        r_ref=as_t(bank.refractory, torch.int32),
        gain=torch.ones((n,), dtype=dtype, device=dev),
        i_bias=torch.zeros((n,), dtype=dtype, device=dev),
        v_reset=torch.zeros((n,), dtype=dtype, device=dev),
    )
    return SNNParams(w=as_t(w), c=as_t(c), w_in=torch.eye(n, dtype=dtype, device=dev),
                     lif=lif)
