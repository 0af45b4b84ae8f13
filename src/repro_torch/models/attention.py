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

On a ``DeviceMesh`` (DTensor operands) the layout is the reference's under
GSPMD. Train, prefill and cross-attention keep q's heads split over
``model`` (and its batch over ``data``): each rank takes its own q heads'
kv heads from the K/V that every ``model`` rank holds whole (a local slice,
no communication) and runs the core on its own (batch, heads) block, each of
the two products one DTensor ``bmm`` of the folded block (:func:`folded_bmm`),
so nothing is gathered and a cost recording sees each product at its global
shapes. Prefill projects K/V over ``kv_seq``, the cache's split, and gathers
them once for the core. Decode writes the step's row into the rank that
holds it, and each rank attends over its own ``kv_seq`` shard of the cache;
the ranks combine the softmax by all-reduces of its max, its sum and the
weighted values (the reference's partitioned softmax). Plain tensors take
the plain ops, unchanged.

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
from repro_torch.parallel.sharding import (constrain, dot, folded_bmm, is_dtensor,
                                           local_offsets, relayout)
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
    """K/V projection; (B, T, Hkv, Dh). The input is laid out over
    ``seq_axis`` first, so each rank projects only the positions it keeps
    (prefill's ``kv_seq``: the cache's split). The flat weights and products
    keep every kv head on each rank (``wk`` / ``wv`` split no head), and so
    do their gradients: on a mesh DTensor may lay the columns over ``model``
    otherwise, and then refuse to unflatten fewer kv heads than ranks."""
    b, t, d = x.shape
    hkv, dh = cfg.n_kv_heads, cfg.d_head
    x = constrain(x, "batch", seq_axis, "embed")
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
def _kv_runs(cfg: ModelConfig, h0: int = 0,
             h1: Optional[int] = None) -> Tuple[Tuple[int, int, int], ...]:
    """``head_maps``' index map over the q heads ``[h0, h1)`` as runs
    ``(first kv head, kv heads, copies of each)``: the map is
    non-decreasing, so each kv head's q heads are contiguous."""
    counts = np.bincount(head_maps(cfg)[0][h0:h1], minlength=cfg.n_kv_heads)
    runs = []
    for i, c in enumerate(counts.tolist()):
        if runs and runs[-1][2] == c and runs[-1][0] + runs[-1][1] == i:
            runs[-1] = (runs[-1][0], runs[-1][1] + 1, c)
        elif c:
            runs.append((i, 1, c))
    return tuple(runs)


def _expand_kv(k: torch.Tensor, cfg: ModelConfig, heads=(0, None)) -> torch.Tensor:
    """Gather each (padded) q head's kv head: (B,T,Hkv,Dh) -> (B,T,Hqp,Dh),
    or only the q heads ``heads = (h0, h1)`` (a rank's own).

    Copies by ``expand`` over runs of kv heads, the values of
    ``index_select(2, to_kv)``: ``index_select``'s backward adds into a zero
    tensor in place, which DTensor's dispatch gets wrong on a sharded
    gradient (ROADMAP §C)."""
    b, t, _, dh = k.shape
    parts = [k[:, :, i:i + n, None].expand(b, t, n, c, dh).reshape(b, t, n * c, dh)
             for i, n, c in _kv_runs(cfg, *heads)]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=2)


def _mask_heads(out: torch.Tensor, cfg: ModelConfig, h0: int = 0) -> torch.Tensor:
    """Zero the dead pad heads of ``out`` (B, S, H, Dh), whose heads are the
    q heads from ``h0`` on."""
    _, live = _head_tensors(cfg, out.device)
    if live is None:
        return out
    return out * live[h0:h0 + out.shape[2]].to(out.dtype)[None, None, :, None]


class _Fold(NamedTuple):
    """A rank's block of the attention core on a mesh: per mesh dim, the
    placements of the folded ``(groups, m, k)`` operands of
    :func:`folded_bmm` -- the rows (q, its output and the softmax's
    statistics), ``ke^T`` (groups, Dh, T), the scores (groups, Sq, T) and
    ``ve`` (groups, T, Dh) -- and the mesh dims that split T (decode's
    ``kv_seq``), over which the softmax is combined."""
    mesh: object
    rows: tuple
    k: tuple
    s: tuple
    v: tuple
    t_dims: tuple


def _scores(q, ke, fold: Optional[_Fold] = None) -> torch.Tensor:
    """``einsum("bshd,bthd->bhst")`` in the operands' dtype, then f32 and the
    ``1/sqrt(Dh)`` scale: (B, Hqp, Sq, T)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    a, b = q.transpose(1, 2), ke.permute(0, 2, 3, 1)
    if fold is None:
        s = a @ b
    else:
        s = folded_bmm(a, b, fold.mesh, fold.rows, fold.k).to_local()
        s = s.reshape(a.shape[0], a.shape[1], a.shape[2], b.shape[3])
    return s.float() * scale


def _weighted(w, ve, fold: Optional[_Fold] = None) -> torch.Tensor:
    """``einsum("bhst,bthd->bshd")``; over a split T, the ranks' partial
    sums all-reduced."""
    b = ve.transpose(1, 2)
    if fold is None:
        return (w @ b).transpose(1, 2)
    o = folded_bmm(w, b, fold.mesh, fold.s, fold.v)
    if fold.t_dims:
        o = o.redistribute(fold.mesh, fold.rows)
    o = o.to_local().reshape(w.shape[0], w.shape[1], w.shape[2], b.shape[3])
    return o.transpose(1, 2)


def _pv(scores, ve, fold: Optional[_Fold] = None) -> torch.Tensor:
    """f32 softmax, cast to the values' dtype, then ``einsum("bhst,bthd->bshd")``."""
    w = torch.softmax(scores, dim=-1).to(ve.dtype)
    return _weighted(w, ve, fold)


def _sdpa(q, ke, ve, *, causal: bool, q_offset: int,
          fold: Optional[_Fold] = None) -> torch.Tensor:
    """q, ke, ve: (B, *, Hqp, Dh) -- kv already expanded to q heads."""
    sq, t = q.shape[1], ke.shape[1]
    scores = _scores(q, ke, fold)
    if causal:
        qpos = q_offset + torch.arange(sq, device=q.device)
        kpos = torch.arange(t, device=q.device)
        mask = kpos[None, :] <= qpos[:, None]            # (sq, t)
        scores = torch.where(mask[None, None], scores, NEG_INF)
    return _pv(scores, ve, fold)


def _sdpa_chunked(q, ke, ve, *, causal: bool, fold: Optional[_Fold] = None) -> torch.Tensor:
    """A loop over query chunks; transient score memory = chunk x T. Every
    chunk costs the same (the whole T, masked), so a cost recording runs
    three (:func:`repro_torch.util.trips.scan`)."""
    sq = q.shape[1]
    if sq % Q_CHUNK:
        raise ValueError(f"seq {sq} not divisible by q-chunk {Q_CHUNK}")

    def chunk(_, c):
        i = c * Q_CHUNK
        return None, _sdpa(q[:, i:i + Q_CHUNK], ke, ve, causal=causal, q_offset=i, fold=fold)

    return trips.scan(chunk, None, sq // Q_CHUNK, dim=1)[1]


def _split_softmax(scores, fold: _Fold) -> torch.Tensor:
    """The softmax over a T that ``fold.t_dims`` split: each rank's max,
    then its sum of exponentials, all-reduced over those mesh dims (the
    reference's partitioned softmax; the scores are never gathered)."""
    def reduce(x, op):
        from torch.distributed.tensor import DTensor, Partial

        src = tuple(Partial(op) if i in fold.t_dims else p for i, p in enumerate(fold.rows))
        x = DTensor.from_local(x, fold.mesh, src, run_check=False)
        return x.redistribute(fold.mesh, fold.rows).to_local()

    e = torch.exp(scores - reduce(scores.amax(dim=-1, keepdim=True), "max"))
    return e / reduce(e.sum(dim=-1, keepdim=True), "sum")


def _decode_sdpa(q, ke, ve, valid, fold: Optional[_Fold] = None) -> torch.Tensor:
    """q: (B, q_len, Hqp, Dh) against the expanded cache; valid: (B, T)."""
    scores = torch.where(valid[:, None, None, :], _scores(q, ke, fold), NEG_INF)
    if fold is None or not fold.t_dims:
        return _pv(scores, ve, fold)
    return _weighted(_split_softmax(scores, fold).to(ve.dtype), ve, fold)


def _on_mesh(x, mesh):
    """``x`` as a DTensor on ``mesh``: a plain tensor is whole on every rank."""
    if is_dtensor(x):
        return x
    from torch.distributed.tensor import DTensor, Replicate

    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim, run_check=False)


def _core(q, k, v, cfg: ModelConfig, *, causal: bool, chunked: bool, heads=(0, None),
          fold: Optional[_Fold] = None) -> torch.Tensor:
    """Plain tensors: q (B, Sq, H, Dh) for the q heads ``heads`` against the
    kv heads k, v (B, T, Hkv, Dh); (B, Sq, H*Dh), dead heads zero."""
    ke, ve = _expand_kv(k, cfg, heads), _expand_kv(v, cfg, heads)
    if chunked and q.shape[1] > Q_CHUNK:
        out = _sdpa_chunked(q, ke, ve, causal=causal, fold=fold)
    else:
        out = _sdpa(q, ke, ve, causal=causal, q_offset=0, fold=fold)
    out = _mask_heads(out, cfg, heads[0])
    return out.reshape(out.shape[0], out.shape[1], -1)


def _attend(q, k, v, cfg: ModelConfig, *, causal: bool, chunked: bool) -> torch.Tensor:
    """The attention core of train, prefill and cross-attention: q (B, Sq,
    Hqp, Dh) against the kv heads k, v (B, T, Hkv, Dh); (B, Sq, Hqp*Dh).

    On a mesh q keeps its batch and heads split as they come (any other
    split is gathered), K/V are brought to q's batch split and whole
    elsewhere (one all-gather where prefill split them over ``kv_seq``),
    and each rank runs :func:`_core` on its own block: its q heads' kv heads
    are a local slice, so the gradient of K/V is a partial sum over the
    mesh dims that split the heads. The output lies as q does."""
    if not is_dtensor(q):
        return _core(q, k, v, cfg, causal=causal, chunked=chunked)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = q.device_mesh
    qp = tuple(p if p.is_shard(0) or p.is_shard(2) else Replicate() for p in q.placements)
    if tuple(q.placements) != qp:
        q = relayout(q, qp)
    kvp = tuple(Shard(0) if p.is_shard(0) else Replicate() for p in qp)
    grads = tuple(Partial() if p.is_shard(2) else r for p, r in zip(qp, kvp))
    k, v = (_on_mesh(x, mesh) for x in (k, v))
    k, v = (x if tuple(x.placements) == kvp else relayout(x, kvp) for x in (k, v))
    (_, _, hl, _), off = local_offsets(q)
    groups = tuple(Shard(0) if p.is_shard() else Replicate() for p in qp)
    fold = _Fold(mesh, groups, groups, groups, groups, ())
    out = _core(q.to_local(), k.to_local(grad_placements=grads),
                v.to_local(grad_placements=grads), cfg, causal=causal, chunked=chunked,
                heads=(off[2], off[2] + hl), fold=fold)
    return DTensor.from_local(out, mesh, qp, run_check=False)


def _attend_cache(q, k_flat, v_flat, cfg: ModelConfig, pos: int) -> torch.Tensor:
    """Decode's core: q (B, q_len, Hqp, Dh) against the flat caches (B, T,
    Hkv*Dh), every row up to ``pos + q_len - 1`` valid; (B, q_len, Hqp*Dh).

    On a mesh each rank attends with every head over its own shard of the
    cache (its batch rows and its ``kv_seq`` positions), q brought to the
    cache's batch split, and the ranks that split T combine the softmax
    (:func:`_split_softmax`) and the weighted values by all-reduces."""
    hkv, dh = cfg.n_kv_heads, cfg.d_head
    q_len = q.shape[1]
    if not is_dtensor(k_flat):
        b, t = k_flat.shape[0], k_flat.shape[1]
        ke = _expand_kv(k_flat.reshape(b, t, hkv, dh), cfg)
        ve = _expand_kv(v_flat.reshape(b, t, hkv, dh), cfg)
        kpos = torch.arange(t, device=q.device)
        valid = (kpos[None, :] <= pos + q_len - 1).expand(b, t)
        out = _mask_heads(_decode_sdpa(q, ke, ve, valid), cfg)
        return out.reshape(b, q_len, -1)
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh, cp = k_flat.device_mesh, tuple(k_flat.placements)
    rows = tuple(Shard(0) if p.is_shard(0) else Replicate() for p in cp)

    def t_at(d):
        return tuple(Shard(0) if p.is_shard(0) else Shard(d) if p.is_shard(1) else Replicate()
                     for p in cp)

    fold = _Fold(mesh, rows, t_at(2), t_at(2), t_at(1),
                 tuple(i for i, p in enumerate(cp) if p.is_shard(1)))
    (bl, tl, _), off = local_offsets(k_flat)
    q = _on_mesh(q, mesh)
    ql = (q if tuple(q.placements) == rows else q.redistribute(mesh, rows)).to_local()
    ke = _expand_kv(k_flat.to_local().reshape(bl, tl, hkv, dh), cfg)
    ve = _expand_kv(v_flat.to_local().reshape(bl, tl, hkv, dh), cfg)
    kpos = off[1] + torch.arange(tl, device=ql.device)
    valid = (kpos[None, :] <= pos + q_len - 1).expand(bl, tl)
    out = _mask_heads(_decode_sdpa(ql, ke, ve, valid, fold), cfg)
    return DTensor.from_local(out.reshape(bl, q_len, -1), mesh, rows, run_check=False)


def write_rows(cache: torch.Tensor, new: torch.Tensor, start: int) -> None:
    """``cache[:, start:start + n] = new`` in place, for ``new`` (B, n, F).

    On a DTensor cache each rank writes only where ``[start, start + n)``
    meets its own ``kv_seq`` shard, into its local tensor (the reference's
    ``dynamic_update_slice`` on the owning shard); no collective moves the
    cache. ``new`` comes whole over the cache's sequence split (gathered if
    it is split otherwise, as a prefill shorter than the cache is), unless
    it is laid out as the cache itself."""
    n = new.shape[1]
    if not is_dtensor(cache):
        cache[:, start:start + n] = new
        return
    from torch.distributed.tensor import Replicate

    mesh, cp = cache.device_mesh, tuple(cache.placements)
    local = cache.to_local()
    new = _on_mesh(new, mesh)
    if start == 0 and tuple(new.shape) == tuple(cache.shape) and tuple(new.placements) == cp:
        local.copy_(new.to_local())
        return
    rows = tuple(p if p.is_shard(0) else Replicate() for p in cp)
    new = (new if tuple(new.placements) == rows else new.redistribute(mesh, rows)).to_local()
    (_, tl, _), off = local_offsets(cache)
    lo, hi = max(start, off[1]), min(start + n, off[1] + tl)
    if lo < hi:
        local[:, lo - off[1]:hi - off[1]] = new[:, lo - start:hi - start]


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
    h = constrain(rms_norm(x, p["ln"]), "batch", "seq", "embed")

    if cache is None or cache_pos == "prefill":
        q = _project_q(h, p, cfg, positions, shard_heads=True)
        # prefill projects K/V over the cache's split (kv_seq)
        k, v = _project_kv(h, p, cfg, positions,
                           seq_axis="kv_seq" if cache_pos == "prefill" else "seq")
        out = _attend(q, k, v, cfg, causal=True, chunked=True)
        new_cache = None
        if cache_pos == "prefill":
            sq = q.shape[1]
            new_cache = KVCache(k=constrain(k.reshape(b, sq, hkv * dh), "batch", "kv_seq", None),
                                v=constrain(v.reshape(b, sq, hkv * dh), "batch", "kv_seq", None))
        out = constrain(out, "batch", None, "act_heads")
    else:
        # Decode: q is tiny -> replicated over model; the cache is kv_seq-sharded.
        q = _project_q(h, p, cfg, positions, shard_heads=False)
        k_new, v_new = _project_kv(h, p, cfg, positions)
        q_len, t = q.shape[1], cache.k.shape[1]
        pos = int(cache_pos)
        start = min(max(pos, 0), t - q_len)   # dynamic_update_slice clamps the start
        write_rows(cache.k, k_new.reshape(b, q_len, hkv * dh), start)
        write_rows(cache.v, v_new.reshape(b, q_len, hkv * dh), start)
        out = _attend_cache(q, constrain(cache.k, "batch", "kv_seq", None),
                            constrain(cache.v, "batch", "kv_seq", None), cfg, pos)
        new_cache = cache

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
    b = x.shape[0]
    hkv, dh = cfg.n_kv_heads, cfg.d_head
    h = rms_norm(x, p["ln"])
    q = _project_q(h, p, cfg, None, shard_heads=True)
    t = kv_cache.k.shape[1]
    out = _attend(q, kv_cache.k.reshape(b, t, hkv, dh), kv_cache.v.reshape(b, t, hkv, dh),
                  cfg, causal=False, chunked=False)
    # laid out as the residual stream (the reference's GSPMD infers it): else
    # DTensor's backward of the product gathers the heads of ``out``
    return x + constrain(dot(out, p["wo"]), "batch", "seq", "embed")


def project_vision_kv(vision_proj: torch.Tensor, p: Dict[str, torch.Tensor],
                      cfg: ModelConfig) -> KVCache:
    """Project (already d_model-projected) vision tokens to flat K/V (no
    rope: positions None)."""
    b, t = vision_proj.shape[0], vision_proj.shape[1]
    hkv, dh = cfg.n_kv_heads, cfg.d_head
    k, v = _project_kv(vision_proj, p, cfg, None, seq_axis="vision_seq")
    return KVCache(k=k.reshape(b, t, hkv * dh), v=v.reshape(b, t, hkv * dh))
