"""Weights and state carried across from the JAX package.

The reference's ``SNNParams`` / ``SNNState`` / ``LIFParams`` leaves travel as
a flat dict of numpy arrays keyed by their dotted field path: ``"w"``, ``"c"``
(absent or None for the implicit all-to-all), ``"w_in"``, ``"lif.v_th"``,
``"lif.leak"``, ``"lif.r_ref"``, ``"lif.gain"``, ``"lif.i_bias"``,
``"lif.v_reset"`` for parameters; ``"lif.v"``, ``"lif.r"``, ``"lif.y"``,
``"delay_buf"``, ``"tick"`` for state. Dtypes are preserved (f32 weights
and state, int32 ``r`` / ``r_ref`` / ``tick``), so a round trip is exact.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.core.lif import LIFParams, LIFState
from repro_torch.core.network_types import SNNParams, SNNState

_LIF_PARAMS = tuple(f.name for f in dataclasses.fields(LIFParams))
_LIF_STATE = tuple(f.name for f in dataclasses.fields(LIFState))


def _to_t(a, dev) -> torch.Tensor:
    return torch.from_numpy(np.array(a)).to(dev)   # a copy: never aliases the caller


def _to_np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def params_from_numpy(tree: Dict[str, np.ndarray], device=None) -> SNNParams:
    dev = _device.resolve(device)
    c = tree.get("c")
    return SNNParams(
        w=_to_t(tree["w"], dev),
        c=None if c is None else _to_t(c, dev),
        w_in=_to_t(tree["w_in"], dev),
        lif=LIFParams(**{k: _to_t(tree[f"lif.{k}"], dev) for k in _LIF_PARAMS}))


def params_to_numpy(params: SNNParams) -> Dict[str, np.ndarray]:
    out = {"w": _to_np(params.w), "w_in": _to_np(params.w_in)}
    if params.c is not None:
        out["c"] = _to_np(params.c)
    out.update({f"lif.{k}": _to_np(getattr(params.lif, k)) for k in _LIF_PARAMS})
    return out


def state_from_numpy(tree: Dict[str, np.ndarray], device=None) -> SNNState:
    dev = _device.resolve(device)
    return SNNState(
        lif=LIFState(**{k: _to_t(tree[f"lif.{k}"], dev) for k in _LIF_STATE}),
        delay_buf=_to_t(tree["delay_buf"], dev),
        tick=_to_t(tree["tick"], dev))


def state_to_numpy(state: SNNState) -> Dict[str, np.ndarray]:
    out = {f"lif.{k}": _to_np(getattr(state.lif, k)) for k in _LIF_STATE}
    out["delay_buf"] = _to_np(state.delay_buf)
    out["tick"] = _to_np(state.tick)
    return out
