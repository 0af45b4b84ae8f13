"""The SNN processor core: all-to-all network and its rollout wrappers.

Counterpart of ``repro.core.network``. One call to :func:`step` is one
synchronous network tick; :func:`rollout` runs many. The tick itself lives
only in :meth:`repro_torch.core.engine.TickEngine.tick_body`; everything
here builds an engine and threads a carry through it.

Not ported yet: ``dispatch=`` and ``neighbors=`` (event slice),
``telemetry=True`` (observability slice); they raise.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.core.engine import LATER, EngineOptions, TickCarry, TickEngine  # noqa: F401
from repro_torch.core.lif import LIFParams
from repro_torch.core.network_types import (  # noqa: F401 (re-exports)
    SNNParams, SNNState, synaptic_input,
)


def _engine(options: Optional[EngineOptions], **kw) -> TickEngine:
    if options is not None:
        if not isinstance(options, EngineOptions):
            raise TypeError(f"options must be an EngineOptions, got {type(options)}")
        return TickEngine(options)
    return TickEngine(EngineOptions(**kw))


def step(state: SNNState, params: SNNParams, ext: Optional[torch.Tensor] = None, *,
         mode: str = "fixed_leak", surrogate: bool = False,
         delays: Optional[torch.Tensor] = None, backend: str = "jnp",
         options: Optional[EngineOptions] = None) -> SNNState:
    """One synchronous network tick (``ext``: this tick's drive ``(..., n_in)``)."""
    eng = _engine(options, mode=mode, surrogate=surrogate, backend=backend)
    return eng.tick(state, params, ext, delays=delays)


def rollout(params: SNNParams, state: SNNState, ext_seq: Optional[torch.Tensor],
            n_ticks: int, *, mode: str = "fixed_leak", surrogate: bool = False,
            delays: Optional[torch.Tensor] = None, backend: str = "jnp",
            telemetry: bool = False, options: Optional[EngineOptions] = None):
    """Run ``n_ticks`` ticks; returns ``(final_state, raster)``.

    ``ext_seq`` is ``(n_ticks, ..., n_in)`` or None; the raster is
    ``(n_ticks, ..., n)``. ``W*C`` is hoisted out of the tick loop.
    """
    eng = _engine(options, mode=mode, surrogate=surrogate, backend=backend,
                  telemetry=telemetry)
    return eng.rollout(params, state, ext_seq, n_ticks, delays=delays)


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
        backend follows ``backend`` by default (``"pallas_fused"`` and
        ``"pallas"`` run kernel B5, ``"jnp"`` its plain twin).
      neighbors, dispatch (event slice) and telemetry (observability slice)
        raise ``NotImplementedError``.

    Returns ``((final_state, final_plast_state, final_w), raster)``. The
    caller's ``params.w`` and ``plast_state`` are never written.
    """
    if neighbors is not None or dispatch is not None:
        raise NotImplementedError(LATER["event"])
    if options is not None:
        if not isinstance(options, EngineOptions):
            raise TypeError(f"options must be an EngineOptions, got {type(options)}")
        if options.plasticity is None and plasticity is not None:
            options = dataclasses.replace(options, plasticity=plasticity,
                                          plasticity_backend=plasticity_backend)
    eng = _engine(options, mode=mode, backend=backend, plasticity=plasticity,
                  plasticity_backend=plasticity_backend, telemetry=telemetry)
    return eng.learning_rollout(params, state, plast_state, ext_seq, n_ticks,
                                rewards=rewards, plastic_c=plastic_c)


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
