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

The plans are pure data and cover every family. The layers run for the
``attn`` mixer and the ``dense`` FFN (the dense and audio families); any
other mixer or FFN raises ``NotImplementedError`` naming ROADMAP A.7b.

The reference's ``lax.scan`` over groups is a Python loop here that indexes
the stacked leaves (views, not copies). KV caches are stacked the same way
and written in place: the caches returned are the caches given.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import ffn as ffn_mod
from repro_torch.models.common import Spec, stack_specs

NEXT_SLICE = "ROADMAP A.7b (MoE / mamba / rwkv / cross-attention serving)"


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


def check_ported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` naming ROADMAP A.7b unless every layer of
    ``cfg`` is an ``attn`` mixer with a ``dense`` FFN (the dense and audio
    families)."""
    kinds = sorted({(lp.mixer, lp.ffn) for st in stage_plans(cfg) for lp in st.layers
                    if (lp.mixer, lp.ffn) != ("attn", "dense")})
    if kinds:
        layers = ", ".join(f"{m!r} mixer + {f!r} FFN" for m, f in kinds)
        raise NotImplementedError(f"{cfg.name}: the {cfg.family!r} family's layers ({layers}) "
                                  f"are not ported yet; they wait for {NEXT_SLICE}")


# ---------------------------------------------------------------------------
# specs


def _layer_specs(cfg: ModelConfig, plan: LayerPlan) -> Dict[str, Any]:
    return {"mixer": attn.attn_specs(cfg),
            "ffn": ffn_mod.dense_ffn_specs(cfg, cfg.d_ff_dense or None)}


def stack_stage_specs(cfg: ModelConfig) -> List[Dict[str, Any]]:
    check_ported(cfg)
    out = []
    for stage in stage_plans(cfg):
        layer_specs = {
            f"layer{i}": _layer_specs(cfg, lp) for i, lp in enumerate(stage.layers)
        }
        out.append(stack_specs(layer_specs, stage.n_groups, "groups"))
    return out


# ---------------------------------------------------------------------------
# caches

def _layer_cache_specs(cfg: ModelConfig, batch: int, s_max: int) -> Dict[str, Any]:
    dh, hkv = cfg.d_head, cfg.n_kv_heads
    kv = {
        "k": Spec((batch, s_max, hkv * dh), ("batch", "kv_seq", None), "zeros"),
        "v": Spec((batch, s_max, hkv * dh), ("batch", "kv_seq", None), "zeros"),
    }
    return {"kv": kv}


def cache_specs(cfg: ModelConfig, batch: int, s_max: int) -> List[Dict[str, Any]]:
    """Spec tree for the decode cache, one entry per stage (stacked)."""
    check_ported(cfg)
    out = []
    for stage in stage_plans(cfg):
        layer_caches = {f"layer{i}": _layer_cache_specs(cfg, batch, s_max)
                        for i in range(len(stage.layers))}
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
) -> torch.Tensor:
    """One layer (an ``attn`` mixer and a ``dense`` FFN); the cache (one
    group's views) is written in place."""
    if mode == "train":
        x, _ = attn.self_attention(x, p["mixer"], cfg, positions=positions)
    elif mode == "prefill":
        x, kv = attn.self_attention(
            x, p["mixer"], cfg, positions=positions, cache_pos="prefill")
        # Write fresh K/V into the fixed-size cache buffer.
        sq = kv.k.shape[1]
        cache["kv"]["k"][:, :sq] = kv.k
        cache["kv"]["v"][:, :sq] = kv.v
    elif mode == "decode":
        kvc = attn.KVCache(k=cache["kv"]["k"], v=cache["kv"]["v"])
        x, _ = attn.self_attention(
            x, p["mixer"], cfg, positions=positions, cache=kvc, cache_pos=cache_pos)
    else:
        raise ValueError(f"unknown mode {mode!r}")
    return ffn_mod.dense_ffn(x, p["ffn"])


def apply_stages(
    x: torch.Tensor,
    stage_params: List[Dict[str, Any]],
    cfg: ModelConfig,
    *,
    mode: str,
    positions: torch.Tensor,
    cache_pos=None,
    caches: Optional[List[Dict[str, Any]]] = None,
) -> Tuple[torch.Tensor, Optional[List[Dict[str, Any]]], torch.Tensor]:
    """Run all stages; returns (x, caches, total_aux). ``caches`` (needed for
    prefill and decode) are written in place and returned; the dense FFN
    adds no auxiliary loss, so ``total_aux`` is 0. The layers are those
    :func:`check_ported` admits (``model.forward`` checks)."""
    plans = stage_plans(cfg)
    if mode != "train" and caches is None:
        raise ValueError(f"mode {mode!r} needs caches (model.init_cache)")
    for s, (stage, params) in enumerate(zip(plans, stage_params)):
        for g in range(stage.n_groups):
            p_group = _group(params, g)
            c_group = _group(caches[s], g) if mode != "train" else None
            for i, lp in enumerate(stage.layers):
                name = f"layer{i}"
                x = _apply_layer(x, p_group[name], cfg, lp, mode=mode, positions=positions,
                                 cache_pos=cache_pos,
                                 cache=c_group[name] if c_group is not None else None)
    return x, caches, torch.zeros((), dtype=torch.float32, device=x.device)
