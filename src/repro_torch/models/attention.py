"""GQA self- and cross-attention with padded q heads.

Counterpart of ``repro.models.attention``: the self-attention sublayer and
the vlm family's cross-attention over projected vision tokens. The layout
is the reference's, so its parameters carry across and ``n_params`` matches:

* **Q side**: projection columns are padded to ``head_pad`` whole heads --
  ``Hqp = ceil(Hq/head_pad)*head_pad`` -- and the dead pad heads are
  masked to zero after attention. The reference pads for its tensor-
  parallel mesh; the port computes the dead heads too (computing only the
  live ones is a later optimisation).
* **KV side**: K/V are projected once per kv head and each q head gathers
  its kv head through a constant index map (GQA grouping).
* **KV cache**: flat ``(B, S_max, Hkv*Dh)``. Decode writes the step's K/V
  into the cache *in place* and returns the same tensors (the reference
  returns an updated copy; a deliberate difference, ROADMAP §C).

The casts fall where the reference's do: ``q·k`` in the model dtype, the
scores cast to f32 and scaled, masked with ``NEG_INF`` (not ``-inf``),
softmax in f32, the probabilities cast back to the value dtype, then PV.
``torch.nn.functional.scaled_dot_product_attention`` keeps other
intermediates, so it is not used. For ``q_len > Q_CHUNK`` a loop over query
chunks bounds the transient score matrix at ``(chunk x S)`` per head.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import Spec, apply_rope, rms_norm
from repro_torch.parallel.sharding import batched_matmul, constrain, dot
from repro_torch.util import trips

Q_CHUNK = 512
NEG_INF = -1e30


def padded_q_heads(cfg: ModelConfig) -> int:
    pad = max(1, cfg.head_pad)
    return -(-cfg.n_heads // pad) * pad


def head_maps(cfg: ModelConfig) -> Tuple[np.ndarray, np.ndarray]:
    """(head_to_kv index map, live-head mask) over padded q heads."""
    hqp = padded_q_heads(cfg)
    g = max(1, cfg.n_heads // cfg.n_kv_heads)
    to_kv = np.asarray(
        [min(h // g, cfg.n_kv_heads - 1) for h in range(hqp)], np.int32)
    mask = np.asarray([1.0 if h < cfg.n_heads else 0.0 for h in range(hqp)],
                      np.float32)
    return to_kv, mask


@functools.lru_cache(maxsize=None)
def _head_tensors(cfg: ModelConfig, device: torch.device):
    """The head maps as tensors on ``device``, made once per config and device
    (the mask is None when every head is live)."""
    to_kv, mask = head_maps(cfg)
    live = None if mask.min() >= 1.0 else torch.from_numpy(mask).to(device)
    return torch.from_numpy(to_kv.astype(np.int64)).to(device), live


def attn_specs(cfg: ModelConfig, *, cross: bool = False) -> Dict[str, Spec]:
    """The sublayer's parameters; a cross layer (``cross=True``) has the same
    leaves as a self-attention one, as in the reference."""
    d, hkv, dh = cfg.d_model, cfg.n_kv_heads, cfg.d_head
    hqp = padded_q_heads(cfg)
    s = {
        "ln": Spec((d,), ("norm",), "ones"),
        "wq": Spec((d, hqp * dh), ("qkv_in", "q_heads")),
        "wk": Spec((d, hkv, dh), ("qkv_in", None, None)),
        "wv": Spec((d, hkv, dh), ("qkv_in", None, None)),
        "wo": Spec((hqp * dh, d), ("q_heads", "qkv_in")),
    }
    if cfg.qk_norm:
        s["q_norm"] = Spec((dh,), ("norm",), "ones")
        s["k_norm"] = Spec((dh,), ("norm",), "ones")
    return s


class KVCache(NamedTuple):
    k: torch.Tensor  # (B, S_max, H_kv * Dh)
    v: torch.Tensor


def _project_q(x, p, cfg: ModelConfig, positions, *, shard_heads: bool):
    b, sq = x.shape[0], x.shape[1]
    hqp, dh = padded_q_heads(cfg), cfg.d_head
    q = dot(x, p["wq"])
    if shard_heads:
        q = constrain(q, "batch", None, "act_heads")
    q = q.reshape(b, sq, hqp, dh)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
    if cfg.pos_embed == "rope" and positions is not None:
        q = apply_rope(q, positions, cfg.rope_theta)
    return q


def _project_kv(x, p, cfg: ModelConfig, kv_positions, seq_axis: str = "seq"):
    """K/V projection; (B, T, Hkv, Dh). The flat weights and products keep
    every kv head on each rank (``wk`` / ``wv`` split no head), and so do
    their gradients: on a mesh DTensor may lay the columns over ``model``
    otherwise, and then refuse to unflatten fewer kv heads than ranks."""
    b, t, d = x.shape
    hkv, dh = cfg.n_kv_heads, cfg.d_head
    wk = constrain(p["wk"].reshape(d, hkv * dh), "qkv_in", None)
    wv = constrain(p["wv"].reshape(d, hkv * dh), "qkv_in", None)
    k = constrain(dot(x, wk), "batch", seq_axis, None)
    v = constrain(dot(x, wv), "batch", seq_axis, None)
    k, v = k.reshape(b, t, hkv, dh), v.reshape(b, t, hkv, dh)
    if cfg.qk_norm:
        k = rms_norm(k, p["k_norm"])
    if cfg.pos_embed == "rope" and kv_positions is not None:
        k = apply_rope(k, kv_positions, cfg.rope_theta)
    return k, v


@functools.lru_cache(maxsize=None)
def _kv_runs(cfg: ModelConfig) -> Tuple[Tuple[int, int, int], ...]:
    """``head_maps``' index map as runs ``(first kv head, kv heads, copies
    of each)``: the map is non-decreasing, so each kv head's q heads are
    contiguous."""
    counts = np.bincount(head_maps(cfg)[0], minlength=cfg.n_kv_heads)
    runs = []
    for i, c in enumerate(counts.tolist()):
        if runs and runs[-1][2] == c and runs[-1][0] + runs[-1][1] == i:
            runs[-1] = (runs[-1][0], runs[-1][1] + 1, c)
        elif c:
            runs.append((i, 1, c))
    return tuple(runs)


def _expand_kv(k: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Gather each (padded) q head's kv head: (B,T,Hkv,Dh) -> (B,T,Hqp,Dh).

    Copies by ``expand`` over runs of kv heads, the values of
    ``index_select(2, to_kv)``: ``index_select``'s backward adds into a zero
    tensor in place, which DTensor's dispatch gets wrong on a sharded
    gradient (ROADMAP §C)."""
    b, t, _, dh = k.shape
    parts = [k[:, :, i:i + n, None].expand(b, t, n, c, dh).reshape(b, t, n * c, dh)
             for i, n, c in _kv_runs(cfg)]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=2)


def _mask_heads(out: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    _, live = _head_tensors(cfg, out.device)
    if live is None:
        return out
    return out * live.to(out.dtype)[None, None, :, None]


def _scores(q, ke) -> torch.Tensor:
    """``einsum("bshd,bthd->bhst")`` in the operands' dtype, then f32 and the
    ``1/sqrt(Dh)`` scale: (B, Hqp, Sq, T)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    return batched_matmul(q.transpose(1, 2), ke.permute(0, 2, 3, 1)).float() * scale


def _pv(scores, ve) -> torch.Tensor:
    """f32 softmax, cast to the values' dtype, then ``einsum("bhst,bthd->bshd")``."""
    w = torch.softmax(scores, dim=-1).to(ve.dtype)
    return batched_matmul(w, ve.transpose(1, 2)).transpose(1, 2)


def _sdpa(q, ke, ve, *, causal: bool, q_offset: int) -> torch.Tensor:
    """q, ke, ve: (B, *, Hqp, Dh) -- kv already expanded to q heads."""
    sq, t = q.shape[1], ke.shape[1]
    scores = _scores(q, ke)
    if causal:
        qpos = q_offset + torch.arange(sq, device=q.device)
        kpos = torch.arange(t, device=q.device)
        mask = kpos[None, :] <= qpos[:, None]            # (sq, t)
        scores = torch.where(mask[None, None], scores, NEG_INF)
    return _pv(scores, ve)


def _sdpa_chunked(q, ke, ve, *, causal: bool) -> torch.Tensor:
    """A loop over query chunks; transient score memory = chunk x T. Every
    chunk costs the same (the whole T, masked), so a cost recording runs
    three (:func:`repro_torch.util.trips.scan`)."""
    sq = q.shape[1]
    if sq % Q_CHUNK:
        raise ValueError(f"seq {sq} not divisible by q-chunk {Q_CHUNK}")

    def chunk(_, c):
        i = c * Q_CHUNK
        return None, _sdpa(q[:, i:i + Q_CHUNK], ke, ve, causal=causal, q_offset=i)

    return trips.scan(chunk, None, sq // Q_CHUNK, dim=1)[1]


def _decode_sdpa(q, ke, ve, valid) -> torch.Tensor:
    """q: (B, q_len, Hqp, Dh) against the expanded cache; valid: (B, T)."""
    scores = torch.where(valid[:, None, None, :], _scores(q, ke), NEG_INF)
    return _pv(scores, ve)


def self_attention(
    x: torch.Tensor,
    p: Dict[str, torch.Tensor],
    cfg: ModelConfig,
    *,
    positions: torch.Tensor,
    cache: Optional[KVCache] = None,
    cache_pos=None,
) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """Pre-norm residual self-attention sublayer.

    Train/prefill: ``cache is None`` -> causal attention over x itself
    (returns fresh flat K/V as a cache when ``cache_pos == 'prefill'``).
    Decode: ``cache`` given, x is (B, q_len, D) at the integer position
    ``cache_pos``; the new K/V are written into ``cache`` in place, and the
    returned cache holds the same tensors.
    """
    b = x.shape[0]
    hkv, dh = cfg.n_kv_heads, cfg.d_head
    hqp = padded_q_heads(cfg)
    h = constrain(rms_norm(x, p["ln"]), "batch", "seq", "embed")

    if cache is None or cache_pos == "prefill":
        q = _project_q(h, p, cfg, positions, shard_heads=True)
        k, v = _project_kv(h, p, cfg, positions)
        ke, ve = _expand_kv(k, cfg), _expand_kv(v, cfg)
        sq = q.shape[1]
        if sq > Q_CHUNK:
            out = _sdpa_chunked(q, ke, ve, causal=True)
        else:
            out = _sdpa(q, ke, ve, causal=True, q_offset=0)
        new_cache = None
        if cache_pos == "prefill":
            new_cache = KVCache(k=constrain(k.reshape(b, sq, hkv * dh), "batch", "kv_seq", None),
                                v=constrain(v.reshape(b, sq, hkv * dh), "batch", "kv_seq", None))
    else:
        # Decode: q is tiny -> replicated over model; the cache is kv_seq-sharded.
        q = _project_q(h, p, cfg, positions, shard_heads=False)
        k_new, v_new = _project_kv(h, p, cfg, positions)
        q_len, t = q.shape[1], cache.k.shape[1]
        pos = int(cache_pos)
        start = min(max(pos, 0), t - q_len)   # dynamic_update_slice clamps the start
        cache.k[:, start:start + q_len] = k_new.reshape(b, q_len, hkv * dh)
        cache.v[:, start:start + q_len] = v_new.reshape(b, q_len, hkv * dh)
        k_flat = constrain(cache.k, "batch", "kv_seq", None)
        v_flat = constrain(cache.v, "batch", "kv_seq", None)
        ke = _expand_kv(k_flat.reshape(b, t, hkv, dh), cfg)
        ve = _expand_kv(v_flat.reshape(b, t, hkv, dh), cfg)
        kpos = torch.arange(t, device=x.device)
        valid = (kpos[None, :] <= pos + q_len - 1).expand(b, t)
        out = _decode_sdpa(q, ke, ve, valid)
        new_cache = cache

    out = _mask_heads(out, cfg)
    out = out.reshape(b, -1, hqp * dh)
    if cache is None or cache_pos == "prefill":
        out = constrain(out, "batch", None, "act_heads")
    y = constrain(dot(out, p["wo"]), "batch", "seq", "embed")
    return x + y, new_cache


def cross_attention(
    x: torch.Tensor,
    p: Dict[str, torch.Tensor],
    cfg: ModelConfig,
    *,
    kv_cache: KVCache,
) -> torch.Tensor:
    """Cross-attention over precomputed (cached) flat vision K/V: no rope on
    q (positions None), non-causal over the vision tokens."""
    b, sq = x.shape[0], x.shape[1]
    hkv, dh = cfg.n_kv_heads, cfg.d_head
    hqp = padded_q_heads(cfg)
    h = rms_norm(x, p["ln"])
    q = _project_q(h, p, cfg, None, shard_heads=True)
    t = kv_cache.k.shape[1]
    ke = _expand_kv(kv_cache.k.reshape(b, t, hkv, dh), cfg)
    ve = _expand_kv(kv_cache.v.reshape(b, t, hkv, dh), cfg)
    out = _mask_heads(_sdpa(q, ke, ve, causal=False, q_offset=0), cfg)
    return x + dot(out.reshape(b, sq, hqp * dh), p["wo"])


def project_vision_kv(vision_proj: torch.Tensor, p: Dict[str, torch.Tensor],
                      cfg: ModelConfig) -> KVCache:
    """Project (already d_model-projected) vision tokens to flat K/V (no
    rope: positions None)."""
    b, t = vision_proj.shape[0], vision_proj.shape[1]
    hkv, dh = cfg.n_kv_heads, cfg.d_head
    k, v = _project_kv(vision_proj, p, cfg, None, seq_axis="vision_seq")
    return KVCache(k=k.reshape(b, t, hkv * dh), v=v.reshape(b, t, hkv * dh))
