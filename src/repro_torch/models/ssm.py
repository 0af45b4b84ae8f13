"""Mamba-1 block (Jamba's SSM layer): selective scan over time.

Counterpart of ``repro.models.ssm``. The selective state update
``h' = exp(dt*A) h + dt*B*x`` is the same shape of computation as the
paper's LIF membrane update (input-conditioned decay + drive).

The reference nests a ``lax.scan`` over chunks of ``SSM_CHUNK`` steps with
the chunk body checkpointed; that bounds the memory of its backward pass.
Here the time loop is a plain Python loop over steps (a deliberate
difference, ROADMAP §C) that keeps the reference's chunk assert; when a
gradient is being recorded, each chunk of ``SSM_CHUNK`` steps runs under
``torch.utils.checkpoint``, so the backward keeps only the carry at each
chunk boundary (whatever the group's ``remat``, as the reference's). Decode
carries ``(conv, h)`` explicitly.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import Spec, rms_norm, silu
from repro_torch.parallel.sharding import constrain, dot
from repro_torch.util import trips
from repro_torch.util.trips import checkpoint

SSM_CHUNK = 256


def dt_rank(cfg: ModelConfig) -> int:
    return max(1, math.ceil(cfg.d_model / 16))


def mamba_specs(cfg: ModelConfig) -> Dict[str, Spec]:
    d, di, n, k = cfg.d_model, cfg.d_inner, cfg.d_state, cfg.d_conv
    r = dt_rank(cfg)
    return {
        "ln": Spec((d,), ("norm",), "ones"),
        "in_proj_x": Spec((d, di), ("mlp_in", "d_inner")),
        "in_proj_z": Spec((d, di), ("mlp_in", "d_inner")),
        "conv_w": Spec((k, di), ("d_conv", "d_inner")),
        "conv_b": Spec((di,), ("d_inner",), "zeros"),
        "x_proj_dt": Spec((di, r), ("d_inner", None)),
        "x_proj_b": Spec((di, n), ("d_inner", "d_state")),
        "x_proj_c": Spec((di, n), ("d_inner", "d_state")),
        "dt_proj": Spec((r, di), (None, "d_inner")),
        "dt_bias": Spec((di,), ("d_inner",), "zeros"),
        "a_log": Spec((di, n), ("d_inner", "d_state"), "ones"),
        "d_skip": Spec((di,), ("d_inner",), "ones"),
        "out_proj": Spec((di, d), ("d_inner", "mlp_in")),
    }


class MambaState(NamedTuple):
    conv: torch.Tensor  # (B, d_conv-1, d_inner) trailing inputs
    h: torch.Tensor     # (B, d_inner, d_state) f32


def init_mamba_state(batch: int, cfg: ModelConfig, dtype, device=None) -> MambaState:
    return MambaState(
        conv=torch.zeros((batch, cfg.d_conv - 1, cfg.d_inner), dtype=dtype, device=device),
        h=torch.zeros((batch, cfg.d_inner, cfg.d_state), dtype=torch.float32, device=device),
    )


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 prepend: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv1d. x: (B, S, di); w: (k, di). The taps are
    summed in the reference's order."""
    k, s = w.shape[0], x.shape[1]
    pad = prepend if prepend is not None else x.new_zeros((x.shape[0], k - 1, x.shape[2]))
    xp = torch.cat([pad, x], dim=1)                   # (B, S+k-1, di)
    out = xp[:, 0:s] * w[0]
    for i in range(1, k):
        out = out + xp[:, i:i + s] * w[i]
    return out + b


def _scan_steps(h, dt, bmat, cmat, xc, a):
    def step(h, t):
        decay = torch.exp(dt[t][..., None] * a)
        h = decay * h + (dt[t] * xc[t])[..., None] * bmat[t][:, None, :]
        return h, torch.einsum("ben,bn->be", h, cmat[t])

    h, ys = trips.scan(step, h, dt.shape[0])
    return ys, h


def _selective_scan(
    h0: torch.Tensor, dt: torch.Tensor, bmat: torch.Tensor, cmat: torch.Tensor,
    xc: torch.Tensor, a: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Selective scan; never materializes (B, S, di, n).

    Per step: ``h = exp(dt*A) h + (dt*x) B_t``; ``y = <h, C_t>``.
    Args (time-major f32): dt, xc: (S, B, di); bmat, cmat: (S, B, n);
    a: (di, n); h0: (B, di, n). Returns (ys (S, B, di) f32, h_T). Under
    autograd each chunk of ``SSM_CHUNK`` steps is checkpointed.
    """
    s = dt.shape[0]
    chunk = min(SSM_CHUNK, s)
    assert s % chunk == 0, f"seq {s} % chunk {chunk} != 0"
    if not torch.is_grad_enabled():
        return _scan_steps(h0, dt, bmat, cmat, xc, a)

    def chunk_step(h, c):
        part = slice(c * chunk, (c + 1) * chunk)
        y, h = checkpoint(_scan_steps, h, dt[part], bmat[part], cmat[part], xc[part], a,
                          use_reentrant=False)
        return h, y

    h, ys = trips.scan(chunk_step, h0, s // chunk)
    return ys.reshape((s,) + tuple(ys.shape[2:])), h


def mamba_block(
    x: torch.Tensor,
    p: Dict[str, torch.Tensor],
    cfg: ModelConfig,
    *,
    state: Optional[MambaState] = None,
    return_state: bool = False,
) -> Tuple[torch.Tensor, Optional[MambaState]]:
    """Pre-norm residual Mamba sublayer.

    Train/prefill: state None (zeros) unless resuming; full-sequence scan.
    Decode: x is (B, 1, D) and ``state`` carries (conv, h).
    """
    bsz, s, d = x.shape
    h_in = constrain(rms_norm(x, p["ln"]), "batch", "seq", "embed")
    xi = dot(h_in, p["in_proj_x"])
    z = dot(h_in, p["in_proj_z"])
    xi = constrain(xi, "batch", None, "d_inner")

    prepend = state.conv if state is not None else None
    xc = silu(_causal_conv(xi, p["conv_w"], p["conv_b"], prepend))

    # dt's rank and B / C's d_state columns contract the split d_inner: on a
    # mesh their partial sums are reduced first (the reference's all-reduce)
    # and dt_proj multiplies by each rank's own d_inner columns, laid out as
    # xi so that its gradient, which takes the time-major scan's strides,
    # comes back with the contiguous local shard the product's view needs.
    # softplus in the model dtype, as the reference's. torch returns x above
    # its threshold of 20 where JAX takes logaddexp(x, 0): they agree to the
    # f32 ulp there.
    dt = constrain(dot(xc, p["x_proj_dt"]), "batch", None, None)
    dt = F.softplus(constrain(dot(dt, p["dt_proj"]), "batch", None, "d_inner") + p["dt_bias"])
    bmat = constrain(dot(xc, p["x_proj_b"]), "batch", None, "d_state").float()
    cmat = constrain(dot(xc, p["x_proj_c"]), "batch", None, "d_state").float()
    a = -torch.exp(p["a_log"].float())                                 # (di, n)

    dtf = dt.float()
    xcf = xc.float()

    h0 = state.h if state is not None else torch.zeros(
        (bsz, cfg.d_inner, cfg.d_state), dtype=torch.float32, device=x.device)

    if s == 1:
        decay0 = torch.exp(dtf[:, 0, :, None] * a)
        hT = decay0 * h0 + (dtf[:, 0] * xcf[:, 0])[..., None] * bmat[:, 0, None, :]
        y = torch.einsum("ben,bn->be", hT, cmat[:, 0])[:, None]       # (B,1,di)
    else:
        ys, hT = _selective_scan(
            h0, dtf.transpose(0, 1), bmat.transpose(0, 1),
            cmat.transpose(0, 1), xcf.transpose(0, 1), a)
        y = ys.transpose(0, 1)                                         # (B,S,di)
    y = y.to(x.dtype) + p["d_skip"] * xc
    y = y * silu(z)
    out = constrain(dot(y, p["out_proj"]), "batch", "seq", "embed")

    new_state = None
    if return_state:
        conv_tail_src = torch.cat([state.conv, xi], dim=1) if state is not None else xi
        pad = cfg.d_conv - 1
        if conv_tail_src.shape[1] < pad:
            conv_tail_src = torch.cat(
                [xi.new_zeros((bsz, pad - conv_tail_src.shape[1], cfg.d_inner)),
                 conv_tail_src], dim=1)
        new_state = MambaState(conv=conv_tail_src[:, -pad:], h=hT)
    return x + out, new_state
