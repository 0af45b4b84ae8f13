"""Generic decoder stack: every assigned architecture is a *stage plan*.

Counterpart of ``repro.models.transformer``. A model is a list of stages;
each stage repeats ``n_groups`` identical groups; a group applies a fixed
pattern of layers (mixer + FFN kind):

  dense/audio     1 stage, group = [attn + dense]
  llama4 (MoE)    1 stage, group = [attn + moe(+shared)]
  moonshot        2 stages: [attn + dense] x1, then [attn + moe] x47
  jamba           1 stage of 9 groups x 8 layers (attn at idx 4, mamba
                  elsewhere; MoE at odd indices)
  vlm             1 stage of 20 groups x 5 layers (cross-attn at idx 0)
  rwkv6           1 stage, group = [time-mix + channel-mix]

The reference's ``lax.scan`` over groups is a Python loop here. Prefill
and decode index the stacked leaves (views, not copies); caches (the KV
caches, the cross layers' vision K/V, the mamba ``conv`` / ``h`` and the
rwkv ``att_x`` / ``ffn_x`` / ``wkv`` states) are stacked the same way and
written in place: the caches returned are the caches given. Train mode
``unbind``s each stacked leaf once per forward instead, so its backward
stacks one gradient a leaf (the backward of an index writes a zero tensor
the size of the whole stacked leaf for every group).

``remat`` is the reference's ``jax.checkpoint`` of each group body in train
mode, here ``torch.utils.checkpoint`` (non-reentrant): ``"block"`` keeps
only each group's input and recomputes the group in the backward,
``"dots"`` also keeps the outputs of the products without batch
dimensions (the 2-D matmuls, ``aten.mm``; the reference's
``checkpoint_dots_with_no_batch_dims``), ``"none"`` keeps everything.
Remat changes no number.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils import checkpoint as _ckpt

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import ffn as ffn_mod
from repro_torch.models import rwkv as rwkv_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import Spec, stack_specs
from repro_torch.parallel.sharding import constrain, grad_laid_out
from repro_torch.util import trips
from repro_torch.util import tree as tree_util


@dataclasses.dataclass(frozen=True)
class LayerPlan:
    mixer: str   # attn | cross | mamba | rwkv
    ffn: str     # dense | moe | rwkv | none


@dataclasses.dataclass(frozen=True)
class StagePlan:
    n_groups: int
    layers: Tuple[LayerPlan, ...]


def stage_plans(cfg: ModelConfig) -> List[StagePlan]:
    fam = cfg.family
    if fam in ("dense", "audio"):
        return [StagePlan(cfg.n_layers, (LayerPlan("attn", "dense"),))]
    if fam == "moe":
        stages = []
        if cfg.first_dense_layers:
            stages.append(StagePlan(cfg.first_dense_layers, (LayerPlan("attn", "dense"),)))
        rest = cfg.n_layers - cfg.first_dense_layers
        stages.append(StagePlan(rest, (LayerPlan("attn", "moe"),)))
        return stages
    if fam == "hybrid":
        g = cfg.group_size
        assert cfg.n_layers % g == 0
        layers = tuple(
            LayerPlan(
                "attn" if i == cfg.attn_index else "mamba",
                "moe" if cfg.is_moe_layer(i) else "dense",
            )
            for i in range(g)
        )
        return [StagePlan(cfg.n_layers // g, layers)]
    if fam == "vlm":
        g = cfg.group_size
        assert cfg.n_layers % g == 0
        layers = tuple(
            LayerPlan("cross" if i == cfg.cross_index else "attn", "dense")
            for i in range(g)
        )
        return [StagePlan(cfg.n_layers // g, layers)]
    if fam == "rwkv":
        return [StagePlan(cfg.n_layers, (LayerPlan("rwkv", "rwkv"),))]
    raise ValueError(f"unknown family {fam!r}")


# ---------------------------------------------------------------------------
# specs


def _layer_specs(cfg: ModelConfig, plan: LayerPlan) -> Dict[str, Any]:
    s: Dict[str, Any] = {}
    if plan.mixer == "attn":
        s["mixer"] = attn.attn_specs(cfg)
    elif plan.mixer == "cross":
        s["mixer"] = attn.attn_specs(cfg, cross=True)
    elif plan.mixer == "mamba":
        s["mixer"] = ssm_mod.mamba_specs(cfg)
    elif plan.mixer == "rwkv":
        s["mixer"] = rwkv_mod.rwkv_att_specs(cfg)
    else:
        raise ValueError(plan.mixer)
    if plan.ffn == "dense":
        s["ffn"] = ffn_mod.dense_ffn_specs(cfg, cfg.d_ff_dense or None)
    elif plan.ffn == "moe":
        s["ffn"] = ffn_mod.moe_ffn_specs(cfg)
    elif plan.ffn == "rwkv":
        s["ffn"] = rwkv_mod.rwkv_ffn_specs(cfg)
    elif plan.ffn != "none":
        raise ValueError(plan.ffn)
    return s


def stack_stage_specs(cfg: ModelConfig) -> List[Dict[str, Any]]:
    out = []
    for stage in stage_plans(cfg):
        layer_specs = {
            f"layer{i}": _layer_specs(cfg, lp) for i, lp in enumerate(stage.layers)
        }
        out.append(stack_specs(layer_specs, stage.n_groups, "groups"))
    return out


# ---------------------------------------------------------------------------
# caches

def _layer_cache_specs(
    cfg: ModelConfig, plan: LayerPlan, batch: int, s_max: int
) -> Optional[Dict[str, Any]]:
    dh, hkv = cfg.d_head, cfg.n_kv_heads
    if plan.mixer == "attn":
        kv = {
            "k": Spec((batch, s_max, hkv * dh), ("batch", "kv_seq", None), "zeros"),
            "v": Spec((batch, s_max, hkv * dh), ("batch", "kv_seq", None), "zeros"),
        }
        return {"kv": kv}
    if plan.mixer == "cross":
        nv = cfg.n_vision_tokens
        kv = {
            "k": Spec((batch, nv, hkv * dh), ("batch", "vision_seq", None), "zeros"),
            "v": Spec((batch, nv, hkv * dh), ("batch", "vision_seq", None), "zeros"),
        }
        return {"kv": kv}
    if plan.mixer == "mamba":
        return {
            "conv": Spec((batch, cfg.d_conv - 1, cfg.d_inner), ("batch", None, "d_inner"),
                         "zeros"),
            "h": Spec((batch, cfg.d_inner, cfg.d_state), ("batch", "d_inner", "d_state"),
                      "zeros", dtype="float32"),
        }
    if plan.mixer == "rwkv":
        h_n, dk = rwkv_mod.rwkv_heads(cfg), cfg.rwkv_head_dim
        return {
            "att_x": Spec((batch, cfg.d_model), ("batch", "embed"), "zeros"),
            "ffn_x": Spec((batch, cfg.d_model), ("batch", "embed"), "zeros"),
            "wkv": Spec((batch, h_n, dk, dk), ("batch", "rwkv_heads", "rwkv_key", None),
                        "zeros", dtype="float32"),
        }
    return None


def cache_specs(cfg: ModelConfig, batch: int, s_max: int) -> List[Dict[str, Any]]:
    """Spec tree for the decode cache, one entry per stage (stacked)."""
    out = []
    for stage in stage_plans(cfg):
        layer_caches = {}
        for i, lp in enumerate(stage.layers):
            c = _layer_cache_specs(cfg, lp, batch, s_max)
            if c is not None:
                layer_caches[f"layer{i}"] = c
        out.append(stack_specs(layer_caches, stage.n_groups, "groups"))
    return out


# ---------------------------------------------------------------------------
# apply


def _group(tree, g: int):
    """Group ``g`` of a stacked tree: every leaf indexed on its groups axis
    (a view)."""
    if isinstance(tree, dict):
        return {k: _group(v, g) for k, v in tree.items()}
    return tree[g]


def _unbind(tree, n: int) -> List[Any]:
    """The ``n`` groups of a stacked tree, each leaf ``unbind``-ed once (views
    whose backward is one ``stack`` a leaf)."""
    if isinstance(tree, dict):
        per_key = {k: _unbind(v, n) for k, v in tree.items()}
        return [{k: per_key[k][g] for k in tree} for g in range(n)]
    return list(tree.unbind(0))


def _save_2d_products(ctx, op, *args, **kwargs):
    """The ``"dots"`` policy: keep the outputs of the products without batch
    dimensions, recompute the rest."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return _ckpt.CheckpointPolicy.MUST_SAVE
    return _ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _rematted(body, remat: str):
    """``body`` under the reference's ``remat`` policy (train mode)."""
    if remat == "none" or not torch.is_grad_enabled():
        return body
    if remat == "block":
        return functools.partial(trips.checkpoint, body, use_reentrant=False)
    if remat == "dots":
        ctx = functools.partial(_ckpt.create_selective_checkpoint_contexts, _save_2d_products)
        return functools.partial(trips.checkpoint, body, use_reentrant=False, context_fn=ctx)
    raise ValueError(f"unknown remat {remat!r}")


def _write(cache: Dict[str, torch.Tensor], new: Dict[str, torch.Tensor]) -> None:
    """Copy each new state leaf into its cache view, in place."""
    for k, v in new.items():
        cache[k].copy_(v)


def _apply_layer(
    x: torch.Tensor,
    p: Dict[str, Any],
    cfg: ModelConfig,
    plan: LayerPlan,
    *,
    mode: str,
    positions: torch.Tensor,
    cache_pos,
    cache: Optional[Dict[str, Any]],
    vision_proj: Optional[torch.Tensor],
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One layer; returns (x, aux loss or None). The cache (one group's
    views) is written in place: prefill writes the fresh K/V, the vision
    K/V and the recurrent states; decode writes the step's K/V and states.
    A cross layer's decode reads the vision K/V that prefill wrote."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"unknown mode {mode!r}")
    if plan.mixer == "attn":
        if mode == "train":
            x, _ = attn.self_attention(x, p["mixer"], cfg, positions=positions)
        elif mode == "prefill":
            x, kv = attn.self_attention(
                x, p["mixer"], cfg, positions=positions, cache_pos="prefill")
            # Write fresh K/V into the fixed-size cache buffer.
            attn.write_rows(cache["kv"]["k"], kv.k, 0)
            attn.write_rows(cache["kv"]["v"], kv.v, 0)
        else:
            kvc = attn.KVCache(k=cache["kv"]["k"], v=cache["kv"]["v"])
            x, _ = attn.self_attention(
                x, p["mixer"], cfg, positions=positions, cache=kvc, cache_pos=cache_pos)
    elif plan.mixer == "cross":
        if mode == "decode":
            kv = attn.KVCache(k=cache["kv"]["k"], v=cache["kv"]["v"])
        else:
            kv = attn.project_vision_kv(vision_proj, p["mixer"], cfg)
            if mode == "prefill":
                _write(cache["kv"], kv._asdict())
        x = attn.cross_attention(x, p["mixer"], cfg, kv_cache=kv)
    elif plan.mixer == "mamba":
        if mode == "train":
            x, _ = ssm_mod.mamba_block(x, p["mixer"], cfg)
        else:
            st = None
            if mode == "decode":
                st = ssm_mod.MambaState(conv=cache["conv"], h=cache["h"])
            x, new_st = ssm_mod.mamba_block(x, p["mixer"], cfg, state=st, return_state=True)
            _write(cache, new_st._asdict())
    elif plan.mixer == "rwkv":
        st = None
        if mode == "decode":
            st = rwkv_mod.RWKVState(
                att_x=cache["att_x"], ffn_x=cache["ffn_x"], wkv=cache["wkv"])
        want_state = mode != "train"
        x, new_att_x, new_wkv = rwkv_mod.rwkv_time_mix(
            x, p["mixer"], cfg, state=st, return_state=want_state)
        x, new_ffn_x = rwkv_mod.rwkv_channel_mix(
            x, p["ffn"], cfg,
            state_x=st.ffn_x if st is not None else None, return_state=want_state)
        if want_state:
            _write(cache, {"att_x": new_att_x, "ffn_x": new_ffn_x, "wkv": new_wkv})
        return x, None

    # FFN (rwkv handled above)
    if plan.ffn == "dense":
        return ffn_mod.dense_ffn(x, p["ffn"]), None
    if plan.ffn == "moe":
        # Decode steps get serving capacity headroom; train/prefill use the
        # config's capacity factor.
        cap = ffn_mod.DECODE_CAPACITY_FACTOR if mode == "decode" else None
        return ffn_mod.moe_ffn(x, p["ffn"], cfg, cap_factor=cap)
    return x, None


def apply_stages(
    x: torch.Tensor,
    stage_params: List[Dict[str, Any]],
    cfg: ModelConfig,
    *,
    mode: str,
    positions: torch.Tensor,
    cache_pos=None,
    caches: Optional[List[Dict[str, Any]]] = None,
    vision_proj: Optional[torch.Tensor] = None,
    remat: str = "block",
) -> Tuple[torch.Tensor, Optional[List[Dict[str, Any]]], torch.Tensor]:
    """Run all stages; returns (x, caches, total_aux). ``caches`` (needed for
    prefill and decode) are written in place and returned; ``remat`` applies
    in train mode only.

    ``total_aux`` sums, over the groups, the aux loss of each group's LAST
    layer (0 when that layer has no MoE FFN): the reference's scan body
    rebinds ``aux`` at every layer and adds only the last one's to its
    carry, so a jamba group counts its layer 7 and drops layers 1, 3 and 5.
    The port keeps that sum (ROADMAP, faults of the reference), and its
    gradient follows it."""
    plans = stage_plans(cfg)
    if mode != "train" and caches is None:
        raise ValueError(f"mode {mode!r} needs caches (model.init_cache)")
    total_aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for s, (stage, params) in enumerate(zip(plans, stage_params)):
        def group_body(h, p_group, c_group=None, _stage=stage):
            aux = None
            for i, lp in enumerate(_stage.layers):
                name = f"layer{i}"
                h, aux = _apply_layer(
                    h, p_group[name], cfg, lp, mode=mode, positions=positions,
                    cache_pos=cache_pos, cache=c_group.get(name) if c_group is not None else None,
                    vision_proj=vision_proj)
            return constrain(h, "batch", "seq", "embed"), aux

        if mode == "train":
            body = _rematted(group_body, remat)
            for p_group in _unbind(params, stage.n_groups):
                x, aux = body(x, tree_util.map(grad_laid_out, p_group))
                if aux is not None:
                    total_aux = total_aux + aux
            continue
        for g in range(stage.n_groups):
            x, aux = group_body(x, _group(params, g), _group(caches[s], g))
            if aux is not None:
                total_aux = total_aux + aux
    return x, caches, total_aux
