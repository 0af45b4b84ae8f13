"""Top-level model: embed -> stages -> norm -> head, plus step functions.

Counterpart of ``repro.models.model`` for every LM family:

  specs(cfg)                      parameter Spec tree
  init(cfg, gen, device)          materialized params (the port's own draws)
  forward(params, cfg, tokens)    logits (+ caches in prefill / decode)
  loss_fn(params, cfg, batch)     train NLL (+ MoE aux), differentiable by autograd
  prefill_fn / decode_fn          serving steps with KV / SSM / RWKV caches
  make_cache_specs / init_cache   the decode cache
  batch_specs(cfg, shape)         the input Spec tree of one (arch, shape) cell

The vlm family takes ``vision_embeds`` (B, n_vision_tokens, d_vision) in
the model dtype, as ``batch_specs`` declares them; its decode steps read
the vision K/V that prefill wrote into the cache.

``remat`` (``"block"`` by default, as the reference's; ``"dots"``,
``"none"``) is the activation-checkpoint policy of train mode's group
bodies (:func:`repro_torch.models.transformer.apply_stages`); it trades the
backward's memory for a second forward and changes no number. Prefill and
decode run without it.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch import device as _device
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import transformer as tf
from repro_torch.models.common import (
    Spec, cross_entropy, init_params, param_count, rms_norm, sinusoidal_pos_embed, torch_dtype,
    zeros_params,
)
from repro_torch.parallel.sharding import (constrain, dot, even_placements, is_dtensor,
                                           local_offsets, relayout, split_over)


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

def _lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]``; for ids split over more than one mesh axis (the
    multi-pod batch over ``("pod", "data")``, or the sequence over
    ``"model"`` beside the batch under Megatron-SP) as ``F.embedding``,
    whose DTensor rules take them where indexing's (or its backward's)
    refuse them on the card's torch. A table whose rows (``vocab``) a mesh
    dim splits that splits no id is looked up row-locally
    (:func:`_lookup_rows`)."""
    if is_dtensor(table) and is_dtensor(ids):
        vocab = [i for i, p in enumerate(table.placements) if p.is_shard(0)]
        if vocab and not any(ids.placements[i].is_shard() for i in vocab):
            return _lookup_rows(table, ids, vocab)
    if is_dtensor(ids) and sum(p.is_shard() for p in ids.placements) > 1:
        return torch.nn.functional.embedding(ids, table)
    return table[ids]


def _lookup_rows(table, ids, vocab) -> torch.Tensor:
    """``table[ids]`` with the table's rows split over the mesh dims
    ``vocab``: each rank looks its ids up in its own rows (an id outside
    them gives zeros there), a partial sum over those dims that the
    ``constrain`` after the lookup reduces -- the reference's partitioned
    gather. DTensor's own rule for ``table[ids]`` may gather the whole table
    (qwen3-0.6b decode_32k: 19.4 MB a device a step) for ids of a few rows.
    A split of the table's columns (FSDP) is gathered first."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    mesh = table.device_mesh
    rows = tuple(p if i in vocab else Replicate() for i, p in enumerate(table.placements))
    if tuple(table.placements) != rows:
        table = relayout(table, rows)
    (n, _), offset = local_offsets(table)
    local = ids.to_local() - offset[0]
    inside = (local >= 0) & (local < n)
    # each rank's rows get the gradient of its own ids: a partial sum over
    # the mesh dims that split the ids
    grads = tuple(p if i in vocab else Partial() if ids.placements[i].is_shard() else p
                  for i, p in enumerate(rows))
    out = table.to_local(grad_placements=grads)[local.clamp(0, n - 1)]
    out = torch.where(inside[..., None], out, out.new_zeros(()))
    return DTensor.from_local(out, mesh, tuple(Partial() if i in vocab else p
                                               for i, p in enumerate(ids.placements)),
                              run_check=False)


def _embed(params, cfg: ModelConfig, tokens: torch.Tensor,
           positions: torch.Tensor) -> torch.Tensor:
    if cfg.family == "audio":
        # tokens: (B, S, K); sum the K codebook embeddings (MusicGen).
        # Indexed, not through _lookup: F.embedding's DTensor rule compares
        # the codebook views' vocab masks by value, which fake tensors cannot.
        x = params["embed"][0][tokens[..., 0]]
        for kb in range(1, cfg.n_codebooks):
            x = x + params["embed"][kb][tokens[..., kb]]
    else:
        x = _lookup(params["embed"], tokens)
    if cfg.pos_embed == "sinusoidal":
        x = x + sinusoidal_pos_embed(positions, cfg.d_model).to(x.dtype)
    return constrain(x, "batch", "seq", "embed")


def _project_vision(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for the vision tokens ``x`` (B, N, d_vision). On a mesh each
    rank multiplies its own rows (batch and ``vision_seq`` as the rules lay
    them out, ``d_vision`` whole) by the weight whole over its FSDP split,
    and the mesh dims that split no row split the output's model width, so
    no rank computes another's share (the multi-pod microbatch's rows split
    over ``data`` alone, the 1601 tokens of an image over nothing) and the
    weight's gradient is a partial sum of each rank's own rows."""
    x = constrain(x, "batch", "vision_seq", None)
    if not is_dtensor(x):
        return dot(x, w)
    mesh = x.device_mesh
    rows = {i for i, p in enumerate(x.placements) if p.is_shard()}
    spare = [i for i, n in enumerate(mesh.mesh.shape) if n > 1 and i not in rows]
    return dot(x, relayout(w, even_placements(mesh, split_over(mesh, {1: spare}), w.shape)))


def _head(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    x = rms_norm(x, params["final_ln"])
    if cfg.family == "audio":
        d, k, v = params["lm_head"].shape
        logits = dot(x, params["lm_head"].reshape(d, k * v)).reshape(*x.shape[:-1], k, v)
        return constrain(logits, "batch", "seq", None, "act_vocab")
    logits = dot(x, params["embed"].T if cfg.tie_embeddings else params["lm_head"])
    return constrain(logits, "batch", "seq", "act_vocab")


def forward(
    params,
    cfg: ModelConfig,
    tokens: torch.Tensor,
    *,
    mode: str,
    positions: Optional[torch.Tensor] = None,
    cache_pos=None,
    caches=None,
    vision_embeds: Optional[torch.Tensor] = None,
    remat: str = "block",
):
    """Returns (logits, caches, aux); ``caches`` are written in place."""
    b, s = tokens.shape[0], tokens.shape[1]
    if positions is None:
        positions = torch.arange(s, device=tokens.device).expand(b, s)
    x = _embed(params, cfg, tokens, positions)
    vision_proj = None
    if cfg.family == "vlm" and vision_embeds is not None:
        vision_proj = constrain(_project_vision(vision_embeds, params["vision_proj"]),
                                "batch", "vision_seq", "embed")
    x, new_caches, aux = tf.apply_stages(
        x, params["stages"], cfg,
        mode=mode, positions=positions, cache_pos=cache_pos, caches=caches,
        vision_proj=vision_proj, remat=remat)
    return _head(params, cfg, x), new_caches, aux


# ---------------------------------------------------------------------------
# step functions

def loss_fn(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor], *,
            remat: str = "block") -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    logits, _, aux = forward(params, cfg, batch["inputs"], mode="train",
                             vision_embeds=batch.get("vision_embeds"), remat=remat)
    nll = cross_entropy(logits, batch["targets"])
    loss = nll + cfg.router_aux_weight * aux
    return loss, {"nll": nll, "router_aux": aux}


def prefill_fn(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor], caches):
    """Process a full prompt, fill caches; returns (last-token logits, caches)."""
    logits, new_caches, _ = forward(params, cfg, batch["inputs"], mode="prefill",
                                    caches=caches, vision_embeds=batch.get("vision_embeds"),
                                    remat="none")
    return logits[:, -1], new_caches


def decode_fn(params, cfg: ModelConfig, batch: Dict[str, Any], caches):
    """One decode step: new token at position ``pos`` (an int) against full
    caches, written in place."""
    pos = int(batch["pos"])
    b = batch["token"].shape[0]
    positions = torch.full((b, 1), pos, dtype=torch.int64, device=batch["token"].device)
    logits, new_caches, _ = forward(params, cfg, batch["token"], mode="decode",
                                    positions=positions, cache_pos=pos, caches=caches,
                                    remat="none")
    return logits[:, -1], new_caches


# ---------------------------------------------------------------------------
# caches

def make_cache_specs(cfg: ModelConfig, batch: int, s_max: int):
    return tf.cache_specs(cfg, batch, s_max)


def init_cache(cfg: ModelConfig, batch: int, s_max: int, device=None):
    """Zeros in the model dtype, the f32 state leaves (mamba ``h``, rwkv
    ``wkv``) in f32."""
    return zeros_params(make_cache_specs(cfg, batch, s_max), dtype_of(cfg),
                        _device.resolve(device))


def batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Spec]:
    """Input Spec tree for one (arch, shape) cell."""
    b, s = shape.global_batch, shape.seq_len
    tok_axes = ("batch", "seq")
    vision = {}
    if cfg.family == "vlm":
        vision["vision_embeds"] = Spec(
            (b, cfg.n_vision_tokens, cfg.d_vision),
            ("batch", "vision_seq", "vision_embed"), dtype=cfg.dtype)
    audio = cfg.family == "audio"
    tok = (b, s, cfg.n_codebooks) if audio else (b, s)
    ax = tok_axes + (None,) if audio else tok_axes
    if shape.kind == "train":
        return {"inputs": Spec(tok, ax, dtype="int32"),
                "targets": Spec(tok, ax, dtype="int32"), **vision}
    if shape.kind == "prefill":
        return {"inputs": Spec(tok, ax, dtype="int32"), **vision}
    if shape.kind == "decode":
        return {
            "token": Spec((b, 1, cfg.n_codebooks) if audio else (b, 1),
                          ("batch", "seq", None) if audio else ("batch", "seq"), dtype="int32"),
            "pos": Spec((), (), dtype="int32"),
        }
    raise ValueError(shape.kind)

