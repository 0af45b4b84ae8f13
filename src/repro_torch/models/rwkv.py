"""RWKV6 ("Finch") block: data-dependent-decay linear attention.

Counterpart of ``repro.models.rwkv``. The WKV recurrence ``S_t =
diag(w_t) S_{t-1} + k_t^T v_t`` is an input-conditioned leaky integrator,
the closest LM-scale analogue of the paper's LIF membrane dynamics (the
learned decay ``w_t`` plays the leak).

Follows arXiv:2404.05892 as the reference does: token-shift with LoRA
data-dependent mixing for (r, k, v, w, g), LoRA decay, per-head bonus ``u``,
group-norm over heads. The reference's chunked ``lax.scan`` over time is a
plain Python loop over steps here (a deliberate difference, ROADMAP §C);
it keeps the reference's chunk assert, and when a gradient is being
recorded each chunk of ``WKV_CHUNK`` steps runs under
``torch.utils.checkpoint``, as the reference checkpoints its chunk body.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import Spec, rms_norm, silu
from repro_torch.parallel.sharding import constrain, dot
from repro_torch.util import trips
from repro_torch.util.trips import checkpoint

WKV_CHUNK = 256
N_MIX = 5  # r, k, v, w, g


def rwkv_heads(cfg: ModelConfig) -> int:
    return cfg.d_model // cfg.rwkv_head_dim


def rwkv_att_specs(cfg: ModelConfig) -> Dict[str, Spec]:
    d = cfg.d_model
    h, dk = rwkv_heads(cfg), cfg.rwkv_head_dim
    mix, dec = cfg.rwkv_lora_mix, cfg.rwkv_lora_decay
    return {
        "ln": Spec((d,), ("norm",), "ones"),
        "mu_x": Spec((d,), ("norm",), "small"),
        "mu_base": Spec((N_MIX, d), (None, "norm"), "small"),
        "w1": Spec((d, N_MIX * mix), ("mlp_in", "rwkv_lora"), "small"),
        "w2": Spec((N_MIX, mix, d), (None, "rwkv_lora", "norm"), "small"),
        "w0_decay": Spec((d,), ("norm",), "zeros"),
        "wd1": Spec((d, dec), ("mlp_in", "rwkv_lora"), "small"),
        "wd2": Spec((dec, d), ("rwkv_lora", "norm"), "small"),
        "u": Spec((h, dk), ("rwkv_heads", "rwkv_key"), "small"),
        "wr": Spec((d, d), ("mlp_in", "d_inner")),
        "wk": Spec((d, d), ("mlp_in", "d_inner")),
        "wv": Spec((d, d), ("mlp_in", "d_inner")),
        "wg": Spec((d, d), ("mlp_in", "d_inner")),
        "gn_gamma": Spec((d,), ("norm",), "ones"),
        "gn_beta": Spec((d,), ("norm",), "zeros"),
        "wo": Spec((d, d), ("d_inner", "mlp_in")),
    }


def rwkv_ffn_specs(cfg: ModelConfig) -> Dict[str, Spec]:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "ln": Spec((d,), ("norm",), "ones"),
        "mu_k": Spec((d,), ("norm",), "small"),
        "mu_r": Spec((d,), ("norm",), "small"),
        "wk": Spec((d, f), ("mlp_in", "mlp")),
        "wv": Spec((f, d), ("mlp", "mlp_in")),
        "wr": Spec((d, d), ("mlp_in", "mlp_in")),
    }


class RWKVState(NamedTuple):
    att_x: torch.Tensor  # (B, D) last normed token fed to time-mix
    ffn_x: torch.Tensor  # (B, D) last normed token fed to channel-mix
    wkv: torch.Tensor    # (B, H, dk, dv) f32 state


def init_rwkv_state(batch: int, cfg: ModelConfig, dtype, device=None) -> RWKVState:
    h, dk = rwkv_heads(cfg), cfg.rwkv_head_dim
    return RWKVState(
        att_x=torch.zeros((batch, cfg.d_model), dtype=dtype, device=device),
        ffn_x=torch.zeros((batch, cfg.d_model), dtype=dtype, device=device),
        wkv=torch.zeros((batch, h, dk, dk), dtype=torch.float32, device=device),
    )


def _shift(x: torch.Tensor, prev: Optional[torch.Tensor]) -> torch.Tensor:
    """Token shift: x_{t-1} (zeros / carried state at t=0). x: (B,S,D)."""
    first = prev[:, None, :] if prev is not None else torch.zeros_like(x[:, :1])
    return torch.cat([first, x[:, :-1]], dim=1)


def _wkv_steps(s, r, k, v, w, u):
    def step(s, t):
        kv = k[t][..., None] * v[t][..., None, :]                     # (B,H,dk,dv)
        y = torch.einsum("bhi,bhij->bhj", r[t], s + u * kv)
        return w[t][..., None] * s + kv, y

    s, ys = trips.scan(step, s, r.shape[0])
    return ys, s


def _wkv_scan(s0, r, k, v, w, u) -> Tuple[torch.Tensor, torch.Tensor]:
    """Time-major WKV recurrence; returns (ys (S,B,H,dv), s_T).

    r,k,v,w: (S, B, H, dk) f32 (w already exp(-exp(.)) in (0,1));
    u: (1, H, dk, 1). Under autograd each chunk of ``WKV_CHUNK`` steps is
    checkpointed.
    """
    s_len = r.shape[0]
    chunk = min(WKV_CHUNK, s_len)
    assert s_len % chunk == 0
    if not torch.is_grad_enabled():
        return _wkv_steps(s0, r, k, v, w, u)

    def chunk_step(s, c):
        part = slice(c * chunk, (c + 1) * chunk)
        y, s = checkpoint(_wkv_steps, s, r[part], k[part], v[part], w[part], u,
                          use_reentrant=False)
        return s, y

    s, ys = trips.scan(chunk_step, s0, s_len // chunk)
    return ys.reshape((s_len,) + tuple(ys.shape[2:])), s


def _group_norm(y: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, n_heads: int,
                eps: float = 1e-5) -> torch.Tensor:
    """Per-head normalization over the head dim, in f32. y: (B, S, D). The
    variance is the population one (``ddof=0``), as ``jnp.var``'s."""
    b, s, d = y.shape
    yh = y.reshape(b, s, n_heads, d // n_heads).float()
    mu = yh.mean(-1, keepdim=True)
    var = yh.var(-1, keepdim=True, correction=0)
    yh = (yh - mu) * torch.rsqrt(var + eps)
    return yh.reshape(b, s, d) * gamma.float() + beta.float()


def rwkv_time_mix(
    x: torch.Tensor,
    p: Dict[str, torch.Tensor],
    cfg: ModelConfig,
    *,
    state: Optional[RWKVState] = None,
    return_state: bool = False,
) -> Tuple[torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Returns (x + out, new_att_x, new_wkv)."""
    b, s, d = x.shape
    h_n, dk = rwkv_heads(cfg), cfg.rwkv_head_dim
    xn = constrain(rms_norm(x, p["ln"]), "batch", "seq", "embed")

    xx = _shift(xn, state.att_x if state is not None else None)
    dx = xx - xn
    # Data-dependent mixing (ddlerp): 5 interpolation targets via LoRA.
    lora = torch.tanh(dot(xn + dx * p["mu_x"], p["w1"])).reshape(b, s, N_MIX, -1)
    deltas = torch.einsum("bsfm,fmd->bsfd", lora, p["w2"])
    m = xn[:, :, None, :] + dx[:, :, None, :] * (p["mu_base"] + deltas)
    m_r, m_k, m_v, m_w, m_g = [m[:, :, i, :] for i in range(N_MIX)]

    r = dot(m_r, p["wr"])
    k = dot(m_k, p["wk"])
    v = dot(m_v, p["wv"])
    g = silu(dot(m_g, p["wg"]))
    # Data-dependent decay (the learned leak): w in (0,1). On a mesh the
    # LoRA's up-projection computes each rank's own d_inner columns (its
    # heads), as the reference's does.
    wd2 = constrain(p["wd2"], "rwkv_lora", "d_inner")
    w_raw = p["w0_decay"] + dot(torch.tanh(dot(m_w, p["wd1"])), wd2)
    w = torch.exp(-torch.exp(w_raw.float()))

    # The recurrence runs on each rank's own heads over the whole sequence,
    # as the reference's: a Megatron-SP step's sequence split ends here.
    r, k, v, w = (constrain(t, "batch", None, "d_inner") for t in (r, k, v, w))
    hd = lambda t: t.reshape(b, s, h_n, dk)
    rf, kf, vf, wf = hd(r).float(), hd(k).float(), hd(v).float(), hd(w)
    u = p["u"].float()                                                 # (H, dk)

    s0 = state.wkv if state is not None else torch.zeros(
        (b, h_n, dk, dk), dtype=torch.float32, device=x.device)
    if s == 1:
        kv = kf[:, 0, :, :, None] * vf[:, 0, :, None, :]
        y = torch.einsum("bhi,bhij->bhj", rf[:, 0], s0 + u[None, :, :, None] * kv)
        sT = wf[:, 0, ..., None] * s0 + kv
        ys = y[:, None]                                                # (B,1,H,dv)
    else:
        tm = lambda t: t.transpose(0, 1)
        ys_t, sT = _wkv_scan(s0, tm(rf), tm(kf), tm(vf), tm(wf), u[None, :, :, None])
        ys = ys_t.transpose(0, 1)

    y = _group_norm(ys.reshape(b, s, d), p["gn_gamma"], p["gn_beta"], h_n)
    y = (y * g.float()).to(x.dtype)
    out = constrain(dot(y, p["wo"]), "batch", "seq", "embed")

    new_att_x = xn[:, -1] if return_state else None
    new_wkv = sT if return_state else None
    return x + out, new_att_x, new_wkv


def rwkv_channel_mix(
    x: torch.Tensor,
    p: Dict[str, torch.Tensor],
    cfg: ModelConfig,
    *,
    state_x: Optional[torch.Tensor] = None,
    return_state: bool = False,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    xn = rms_norm(x, p["ln"])
    dx = _shift(xn, state_x) - xn
    k_in = xn + dx * p["mu_k"]
    r_in = xn + dx * p["mu_r"]
    k = torch.square(torch.relu(dot(k_in, p["wk"])))
    kv = dot(k, p["wv"])
    out = torch.sigmoid(dot(r_in, p["wr"])) * kv
    new_x = xn[:, -1] if return_state else None
    return x + out, new_x
