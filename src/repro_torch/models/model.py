"""Top-level model: embed -> stages -> norm -> head, plus step functions.

Counterpart of ``repro.models.model`` for the dense and audio families:

  specs(cfg)                      parameter Spec tree
  init(cfg, gen, device)          materialized params (the port's own draws)
  forward(params, cfg, tokens)    logits (+ caches in prefill / decode)
  loss_fn(params, cfg, batch)     forward + NLL (no backward: ROADMAP A.7c)
  prefill_fn / decode_fn          serving steps with KV caches
  make_cache_specs / init_cache   the decode cache

The reference's ``remat`` argument is a training-memory knob of its
compiled backward pass; it changes no number and is not taken here.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch import device as _device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tf
from repro_torch.models.common import (
    Spec, cross_entropy, init_params, param_count, rms_norm, sinusoidal_pos_embed, torch_dtype,
    zeros_params,
)


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return torch_dtype(cfg.dtype)


# ---------------------------------------------------------------------------
# specs

def specs(cfg: ModelConfig) -> Dict[str, Any]:
    d, v = cfg.d_model, cfg.vocab_size
    s: Dict[str, Any] = {}
    if cfg.family == "audio":
        s["embed"] = Spec((cfg.n_codebooks, v, d), ("codebooks", "vocab", "embed_param"))
        s["lm_head"] = Spec((d, cfg.n_codebooks, v), ("embed_param", "codebooks", "vocab"))
    else:
        s["embed"] = Spec((v, d), ("vocab", "embed_param"))
        if not cfg.tie_embeddings:
            s["lm_head"] = Spec((d, v), ("embed_param", "vocab"))
    if cfg.family == "vlm":
        s["vision_proj"] = Spec((cfg.d_vision, d), ("vision_embed", "embed_param"))
    s["stages"] = tf.stack_stage_specs(cfg)
    s["final_ln"] = Spec((d,), ("norm",), "ones")
    return s


def init(cfg: ModelConfig, gen: torch.Generator, device=None):
    """Parameters drawn from ``gen`` on ``device`` (None: the card); ``gen``
    must live on that device."""
    return init_params(specs(cfg), gen, dtype_of(cfg), device)


def n_params(cfg: ModelConfig) -> int:
    return param_count(specs(cfg))


# ---------------------------------------------------------------------------
# forward

def _embed(params, cfg: ModelConfig, tokens: torch.Tensor,
           positions: torch.Tensor) -> torch.Tensor:
    if cfg.family == "audio":
        # tokens: (B, S, K); sum the K codebook embeddings (MusicGen).
        x = params["embed"][0][tokens[..., 0]]
        for kb in range(1, cfg.n_codebooks):
            x = x + params["embed"][kb][tokens[..., kb]]
    else:
        x = params["embed"][tokens]
    if cfg.pos_embed == "sinusoidal":
        x = x + sinusoidal_pos_embed(positions, cfg.d_model).to(x.dtype)
    return x


def _head(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    x = rms_norm(x, params["final_ln"])
    if cfg.family == "audio":
        d, k, v = params["lm_head"].shape
        return (x @ params["lm_head"].reshape(d, k * v)).reshape(*x.shape[:-1], k, v)
    if cfg.tie_embeddings:
        return x @ params["embed"].T
    return x @ params["lm_head"]


def forward(
    params,
    cfg: ModelConfig,
    tokens: torch.Tensor,
    *,
    mode: str,
    positions: Optional[torch.Tensor] = None,
    cache_pos=None,
    caches=None,
):
    """Returns (logits, caches, aux); ``caches`` are written in place."""
    tf.check_ported(cfg)
    b, s = tokens.shape[0], tokens.shape[1]
    if positions is None:
        positions = torch.arange(s, device=tokens.device).expand(b, s)
    x = _embed(params, cfg, tokens, positions)
    x, new_caches, aux = tf.apply_stages(
        x, params["stages"], cfg,
        mode=mode, positions=positions, cache_pos=cache_pos, caches=caches)
    return _head(params, cfg, x), new_caches, aux


# ---------------------------------------------------------------------------
# step functions

def loss_fn(params, cfg: ModelConfig,
            batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    logits, _, aux = forward(params, cfg, batch["inputs"], mode="train")
    nll = cross_entropy(logits, batch["targets"])
    loss = nll + cfg.router_aux_weight * aux
    return loss, {"nll": nll, "router_aux": aux}


def prefill_fn(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor], caches):
    """Process a full prompt, fill caches; returns (last-token logits, caches)."""
    logits, new_caches, _ = forward(params, cfg, batch["inputs"], mode="prefill",
                                    caches=caches)
    return logits[:, -1], new_caches


def decode_fn(params, cfg: ModelConfig, batch: Dict[str, Any], caches):
    """One decode step: new token at position ``pos`` (an int) against full
    caches, written in place."""
    pos = int(batch["pos"])
    b = batch["token"].shape[0]
    positions = torch.full((b, 1), pos, dtype=torch.int64, device=batch["token"].device)
    logits, new_caches, _ = forward(params, cfg, batch["token"], mode="decode",
                                    positions=positions, cache_pos=pos, caches=caches)
    return logits[:, -1], new_caches


# ---------------------------------------------------------------------------
# caches

def make_cache_specs(cfg: ModelConfig, batch: int, s_max: int):
    return tf.cache_specs(cfg, batch, s_max)


def init_cache(cfg: ModelConfig, batch: int, s_max: int, device=None):
    return zeros_params(make_cache_specs(cfg, batch, s_max), dtype_of(cfg),
                        _device.resolve(device))

