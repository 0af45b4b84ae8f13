"""Parameter/state records shared by the tick engine and its wrappers.

Counterpart of ``repro.core.network_types``. Every leaf may carry a
leading *slot* axis ``S`` (the multi-tenant server's resident networks):
``w``/``c``/``w_in`` are then ``(S, n, n)``, the LIF rows ``(S, n)`` and
the state ``(S, ..., n)``. The reference reaches the same thing with
``vmap``; here the slot axis is written out and the kernels take it as a
launch-grid dimension with per-slot strides.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch import device as _device
from repro_torch.core.lif import LIFParams, LIFState


@dataclasses.dataclass(frozen=True)
class SNNParams:
    """Network parameters (runtime data, never baked into a kernel).

    Attributes:
      w: synaptic weights ``(n, n)``; ``w[pre, post]``.
      c: connection list ``(n, n)`` 0/1, or None for the implicit
        all-to-all (the effective matrix is ``w``; accepted by the
        ``"jnp"`` backend only -- the kernels take ``c`` explicitly).
      w_in: input weights ``(n_in, n)``.
      lif: per-neuron :class:`LIFParams`.
    """

    w: torch.Tensor
    c: Optional[torch.Tensor]
    w_in: torch.Tensor
    lif: LIFParams


@dataclasses.dataclass(frozen=True)
class SNNState:
    """Rollout state: LIF state + circular delay line + tick counter.

    ``delay_buf`` has shape ``(..., max_delay, n)``; slot ``k % max_delay``
    holds the spikes that arrive at tick ``k``. ``tick`` is a 0-d int32
    tensor on the state's device, so the tick loop never reads it back.
    """

    lif: LIFState
    delay_buf: torch.Tensor
    tick: torch.Tensor

    @staticmethod
    def zeros(batch_shape, n: int, max_delay: int = 1, dtype=torch.float32,
              device=None) -> "SNNState":
        dev = _device.resolve(device)
        return SNNState(
            lif=LIFState.zeros(batch_shape, n, dtype=dtype, device=dev),
            delay_buf=torch.zeros(tuple(batch_shape) + (max_delay, n),
                                  dtype=dtype, device=dev),
            tick=torch.zeros((), dtype=torch.int32, device=dev),
        )


def masked_weights(params: SNNParams) -> torch.Tensor:
    """``W*C``: the mux fabric's effective matrix (``w`` itself when c=None)."""
    if params.c is None:
        return params.w
    return params.w * params.c.to(params.w.dtype)


def synaptic_input(spikes: torch.Tensor, params: SNNParams,
                   ext: Optional[torch.Tensor]) -> torch.Tensor:
    """``sum_pre s[pre] * W[pre,post] * C[pre,post] (+ ext @ W_in)``."""
    syn = spikes @ masked_weights(params)
    if ext is not None:
        syn = syn + ext @ params.w_in
    return syn
