"""Weights and state carried across from the JAX package.

The reference's ``SNNParams`` / ``SNNState`` / ``LIFParams`` leaves travel as
a flat dict of numpy arrays keyed by their dotted field path: ``"w"``, ``"c"``
(absent or None for the implicit all-to-all), ``"w_in"``, ``"lif.v_th"``,
``"lif.leak"``, ``"lif.r_ref"``, ``"lif.gain"``, ``"lif.i_bias"``,
``"lif.v_reset"`` for parameters; ``"lif.v"``, ``"lif.r"``, ``"lif.y"``,
``"delay_buf"``, ``"tick"`` for state; ``"x_pre"``, ``"x_post"``, ``"elig"``
for a ``PlasticityState``; and for a ``TickCarry`` the state's keys under
``"state."``, the plasticity state's under ``"plast."`` and ``"w"`` (the two
learning leaves are absent on a frozen carry), and the knee's hysteresis bit
as ``"policy"`` when the carry holds one. Dtypes are preserved (f32
weights and state, int32 ``r`` / ``r_ref`` / ``tick``), so a round trip is
exact.

The event backend's inputs travel the same way: fan-in lists as the pair
``(idx, mask)`` of numpy arrays, and a ``DispatchPlan`` as a dict of its
fields with the lists under ``"neighbors.idx"`` / ``"neighbors.mask"``.
The classifier's models too: a ``TrainedSNN`` as its arrays and scalars, a
``DeployedSNN`` with its register bank as the ``serialize()`` byte stream
plus the device-local bias register.

The LM's parameters and decode caches travel as the reference's own trees
(``{"embed", "lm_head"?, "vision_proj"?, "stages": [{"layerI": {"mixer",
"ffn"}}], "final_ln"}``, every stacked leaf with its leading ``groups``
axis, the MoE FFN's ``shared`` subtree included; caches ``[{"layerI":
{"kv": {"k", "v"}} | {"conv", "h"} | {"att_x", "ffn_x", "wkv"}}]``) with
numpy leaves. numpy has no bfloat16 and the port does not import
``ml_dtypes``: a bf16 array travels as float32 (``np.asarray(x,
np.float32)``, exact), and the port casts each leaf back to its spec's
dtype (the f32 state leaves, mamba ``h`` and rwkv ``wkv``, stay f32). The
vlm's ``vision_embeds`` travel the same way. A train state travels as the
reference's ``TrainState(params, opt)`` with ``opt`` an
``AdamWState(step, m, v)`` or ``AdafactorState(step, vr, vc)`` (any
NamedTuples with those fields) of numpy leaves, the moments cast to the
config's ``opt_state_dtype``, the Adafactor factors float32 and ``step``
int32.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.core.lif import LIFParams, LIFState
from repro_torch.core.network_types import SNNParams, SNNState
from repro_torch.plasticity.stdp import PlasticityState

_LIF_PARAMS = tuple(f.name for f in dataclasses.fields(LIFParams))
_LIF_STATE = tuple(f.name for f in dataclasses.fields(LIFState))
_PLAST = tuple(f.name for f in dataclasses.fields(PlasticityState))


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


def plast_from_numpy(tree: Dict[str, np.ndarray], device=None) -> PlasticityState:
    dev = _device.resolve(device)
    return PlasticityState(**{k: _to_t(tree[k], dev) for k in _PLAST})


def plast_to_numpy(plast: PlasticityState) -> Dict[str, np.ndarray]:
    return {k: _to_np(getattr(plast, k)) for k in _PLAST}


def carry_from_numpy(tree: Dict[str, np.ndarray], device=None):
    """A :class:`~repro_torch.core.engine.TickCarry`: frozen when the tree has
    no ``"w"``, learning otherwise."""
    from repro_torch.core.engine import TickCarry

    dev = _device.resolve(device)
    sub = lambda prefix: {k[len(prefix):]: v for k, v in tree.items()
                          if k.startswith(prefix)}
    state = state_from_numpy(sub("state."), dev)
    policy = None if tree.get("policy") is None else _to_t(tree["policy"], dev)
    if "w" not in tree:
        return TickCarry(state=state, policy=policy)
    return TickCarry(state=state, plast=plast_from_numpy(sub("plast."), dev),
                     w=_to_t(tree["w"], dev), policy=policy)


def carry_to_numpy(carry) -> Dict[str, np.ndarray]:
    out = {f"state.{k}": v for k, v in state_to_numpy(carry.state).items()}
    if carry.w is not None:
        out.update({f"plast.{k}": v for k, v in plast_to_numpy(carry.plast).items()})
        out["w"] = _to_np(carry.w)
    if carry.policy is not None:
        out["policy"] = _to_np(carry.policy)
    return out


def fan_in_from_numpy(idx, mask, device=None):
    """An :class:`~repro_torch.kernels.ops.EventFanIn` from the reference's
    fan-in lists (``idx`` int32, ``mask`` f32, ``(n, cap)`` or per slot)."""
    from repro_torch.kernels.ops import EventFanIn

    dev = _device.resolve(device)
    return EventFanIn(idx=_to_t(np.asarray(idx, np.int32), dev),
                      mask=_to_t(np.asarray(mask, np.float32), dev))


def fan_in_to_numpy(fan_in):
    """``(idx, mask)`` as numpy arrays."""
    return _to_np(fan_in.idx), _to_np(fan_in.mask)


_PLAN_FIELDS = ("strategy", "k_active", "knee", "hysteresis", "ext_diag", "cap", "costs")


def plan_from_numpy(tree: Dict, device=None):
    """A :class:`~repro_torch.core.dispatch_policy.DispatchPlan` from its
    fields (the fan-in lists, when present, under ``"neighbors.idx"`` and
    ``"neighbors.mask"``)."""
    from repro_torch.core.dispatch_policy import DispatchPlan

    neighbors = None
    if tree.get("neighbors.idx") is not None:
        neighbors = fan_in_from_numpy(tree["neighbors.idx"], tree["neighbors.mask"], device)
    return DispatchPlan(neighbors=neighbors, **{k: tree[k] for k in _PLAN_FIELDS})


def plan_to_numpy(plan) -> Dict:
    """The fields of a ``DispatchPlan`` (of either package) as plain values."""
    out = {k: getattr(plan, k) for k in _PLAN_FIELDS}
    out["costs"] = dict(out["costs"])
    if plan.neighbors is not None:
        host = lambda a: _to_np(a) if isinstance(a, torch.Tensor) else np.asarray(a)
        out["neighbors.idx"] = host(plan.neighbors.idx)
        out["neighbors.mask"] = host(plan.neighbors.mask)
    return out


_TRAINED_SCALARS = {"v_th": float, "n_ticks": int, "leak": float, "r_ref": int}
_DEPLOYED_ARRAYS = ("w_int", "th_int", "b_int")


def trained_to_numpy(model) -> Dict:
    """A ``TrainedSNN`` (of either package) as ``{"w", "bias"}`` float32
    arrays and its four scalars."""
    out = {"w": np.array(model.w, np.float32), "bias": np.array(model.bias, np.float32)}
    out.update({k: cast(getattr(model, k)) for k, cast in _TRAINED_SCALARS.items()})
    return out


def trained_from_numpy(tree: Dict):
    """The port's :class:`~repro_torch.core.classifier.TrainedSNN` (host
    arrays, as the reference keeps them)."""
    from repro_torch.core.classifier import TrainedSNN

    return TrainedSNN(w=np.array(tree["w"], np.float32), bias=np.array(tree["bias"], np.float32),
                      **{k: cast(tree[k]) for k, cast in _TRAINED_SCALARS.items()})


def deployed_to_numpy(dep) -> Dict:
    """A ``DeployedSNN`` (of either package): its bank as the UART stream
    (``"bank"``, the ``serialize()`` bytes) plus the device-local ``"bias"``
    register, the bank's size and layout, the reconstructed integer network
    and ``scale`` / ``n_ticks``."""
    out = {"bank": dep.bank.serialize(), "bias": np.array(dep.bank.bias, np.uint8),
           "n": int(dep.bank.n), "weight_layout": str(dep.bank.weight_layout.value),
           "scale": float(dep.scale), "n_ticks": int(dep.n_ticks)}
    out.update({k: np.array(getattr(dep, k), np.int32) for k in _DEPLOYED_ARRAYS})
    return out


def deployed_from_numpy(tree: Dict):
    """The port's :class:`~repro_torch.core.classifier.DeployedSNN`: the bank
    reloaded from its stream (``load_bytes``) with the bias register set
    after the reload, as ``deploy`` does."""
    from repro_torch.core.classifier import DeployedSNN
    from repro_torch.core.registers import RegisterBank, WeightLayout

    bank = RegisterBank(tree["n"], weight_layout=WeightLayout(tree["weight_layout"]))
    bank.load_bytes(tree["bank"])
    bank.set_bias(tree["bias"])
    return DeployedSNN(bank=bank, scale=float(tree["scale"]), n_ticks=int(tree["n_ticks"]),
                       **{k: np.array(tree[k], np.int32) for k in _DEPLOYED_ARRAYS})


def _lm_tree_from_numpy(tree, specs, dtype, dev):
    from repro_torch.models.common import Spec, torch_dtype

    if isinstance(specs, Spec):
        return torch.from_numpy(np.array(tree)).to(dev, torch_dtype(specs.dtype or dtype))
    if isinstance(specs, dict):
        if set(tree) != set(specs):
            raise KeyError(f"tree keys {sorted(tree)} are not the spec's {sorted(specs)}")
        return {k: _lm_tree_from_numpy(tree[k], specs[k], dtype, dev) for k in specs}
    if len(tree) != len(specs):
        raise ValueError(f"{len(tree)} stages, the spec has {len(specs)}")
    return [_lm_tree_from_numpy(t, s, dtype, dev) for t, s in zip(tree, specs)]


def _lm_tree_to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _lm_tree_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_lm_tree_to_numpy(v) for v in tree]
    t = tree.detach()
    return np.array(_to_np(t.float() if t.is_floating_point() else t))   # never a view


def lm_params_from_numpy(tree, cfg, device=None):
    """An LM's parameters (``repro_torch.models.model`` layout) from the
    reference's tree of numpy arrays, each cast to its spec's dtype."""
    from repro_torch.models import model

    return _lm_tree_from_numpy(tree, model.specs(cfg), model.dtype_of(cfg),
                               _device.resolve(device))


def lm_params_to_numpy(params):
    """The parameters as a tree of numpy arrays (floats as float32)."""
    return _lm_tree_to_numpy(params)


def lm_cache_from_numpy(tree, cfg, device=None):
    """A decode cache from the reference's (a list per stage, leaves
    ``(groups, batch, ...)``), each leaf cast to its spec's dtype. The batch
    is read from any leaf and ``s_max`` from a self-attention layer's K (a
    cache without one, rwkv's, has no ``s_max``)."""
    from repro_torch.models import model
    from repro_torch.models import transformer as tf
    from repro_torch.util import tree as tree_util

    batch, s_max = np.shape(tree_util.leaves(tree)[0])[1], 1
    for stage, plan in zip(tree, tf.stage_plans(cfg)):
        attn = [i for i, lp in enumerate(plan.layers) if lp.mixer == "attn"]
        if attn:
            s_max = np.shape(stage[f"layer{attn[0]}"]["kv"]["k"])[2]
            break
    specs = model.make_cache_specs(cfg, batch, s_max)
    return _lm_tree_from_numpy(tree, specs, model.dtype_of(cfg), _device.resolve(device))


def lm_cache_to_numpy(caches):
    """A decode cache as a list of trees of numpy arrays (floats as float32)."""
    return _lm_tree_to_numpy(caches)


def lm_vision_from_numpy(vision_embeds, cfg, device=None) -> torch.Tensor:
    """The vlm's ``vision_embeds`` (B, n_vision_tokens, d_vision) from the
    reference's array, in the model dtype (``batch_specs``'s)."""
    from repro_torch.models import model

    return torch.from_numpy(np.array(vision_embeds, np.float32)).to(
        _device.resolve(device), model.dtype_of(cfg))


def train_state_from_numpy(state, cfg, pcfg, device=None):
    """The port's :class:`~repro_torch.launch.steps.TrainState` from the
    reference's (numpy leaves): parameters in their spec's dtype, AdamW's
    ``m`` / ``v`` in ``pcfg.opt_state_dtype`` (Adafactor's ``vr`` / ``vc``
    float32), ``step`` int32."""
    from repro_torch.launch.steps import TrainState
    from repro_torch.models import model
    from repro_torch.models.common import torch_dtype
    from repro_torch.optim import adafactor, adamw
    from repro_torch.util import tree as tree_util

    dev = _device.resolve(device)
    params = lm_params_from_numpy(state.params, cfg, dev)
    step = torch.from_numpy(np.array(state.opt.step, np.int32)).to(dev)
    if pcfg.optimizer == "adamw":
        mom = lambda t: _lm_tree_from_numpy(t, model.specs(cfg),
                                            torch_dtype(pcfg.opt_state_dtype), dev)
        opt = adamw.AdamWState(step=step, m=mom(state.opt.m), v=mom(state.opt.v))
    else:
        f32 = lambda t: tree_util.map(lambda a: _to_t(np.asarray(a, np.float32), dev), t)
        opt = adafactor.AdafactorState(step=step, vr=f32(state.opt.vr), vc=f32(state.opt.vc))
    return TrainState(params=params, opt=opt)


def train_state_to_numpy(state):
    """The port's train state as the same NamedTuples of numpy leaves (floats
    as float32, ``step`` int32)."""
    from repro_torch.launch.steps import TrainState

    opt = type(state.opt)(*(_lm_tree_to_numpy(f) for f in state.opt))
    return TrainState(params=_lm_tree_to_numpy(state.params), opt=opt)
