"""FFN sublayers: SwiGLU dense + top-k MoE with capacity-based dispatch.

Counterpart of ``repro.models.ffn``. The MoE dispatch follows the
reference's GShard/MaxText form exactly: tokens are split batch-major into
groups of ``min(MOE_GROUP_TOKENS, B*S)``; each expert accepts ``capacity =
max(ceil(top_k * group_tokens * capacity_factor / n_experts), top_k)``
tokens per group, in token order, and the overflow is dropped. The one-hot
dispatch and combine tensors ``(G, T_g, E, C)`` are in the model dtype, and
every expert's weights take part in the products (the dense dispatch; a
grouped-expert kernel that reads only the routed experts is later work).

Two places where PyTorch differs from JAX are pinned:

* ``jax.lax.top_k`` puts the lower index first on equal values and
  ``torch.topk`` promises no order, so the top k come from a stable
  descending sort (bf16 router logits tie often);
* ``jax.nn.one_hot`` of a slot ``>= capacity`` is all zeros where
  ``torch.nn.functional.one_hot`` raises, so the slots are built by
  comparison with ``arange(capacity)``.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import Spec, gelu, rms_norm, silu
from repro_torch.parallel.sharding import constrain, dot, fit_rows

MOE_GROUP_TOKENS = 512
DECODE_CAPACITY_FACTOR = 4.0  # serving headroom (the reference's; not dropless for every arch)


def dense_ffn_specs(cfg: ModelConfig, d_ff: Optional[int] = None) -> Dict[str, Spec]:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    s = {
        "ln": Spec((d,), ("norm",), "ones"),
        "w_up": Spec((d, f), ("mlp_in", "mlp")),
        "w_down": Spec((f, d), ("mlp", "mlp_in")),
    }
    if cfg.ffn_act == "swiglu":
        s["w_gate"] = Spec((d, f), ("mlp_in", "mlp"))
    return s


def dense_ffn(x: torch.Tensor, p: Dict[str, torch.Tensor]) -> torch.Tensor:
    h = constrain(rms_norm(x, p["ln"]), "batch", "seq", "embed")
    u = dot(h, p["w_up"])
    if "w_gate" in p:  # SwiGLU
        a = silu(dot(h, p["w_gate"])) * u
    else:              # non-gated GELU (starcoder2)
        a = gelu(u)
    a = constrain(a, "batch", None, "act_mlp")
    return x + constrain(dot(a, p["w_down"]), "batch", "seq", "embed")


def moe_ffn_specs(cfg: ModelConfig) -> Dict[str, Spec]:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    s = {
        "ln": Spec((d,), ("norm",), "ones"),
        "router": Spec((d, e), (None, "experts"), "small"),
        "w_gate": Spec((e, d, f), ("experts", "expert_in", "expert_mlp")),
        "w_up": Spec((e, d, f), ("experts", "expert_in", "expert_mlp")),
        "w_down": Spec((e, f, d), ("experts", "expert_mlp", "expert_in")),
    }
    if cfg.n_shared_experts:
        fs = cfg.n_shared_experts * f
        s["shared"] = {
            "w_gate": Spec((d, fs), ("mlp_in", "mlp")),
            "w_up": Spec((d, fs), ("mlp_in", "mlp")),
            "w_down": Spec((fs, d), ("mlp", "mlp_in")),
        }
    return s


def _capacity(cfg: ModelConfig, group_tokens: int, cap_factor: float) -> int:
    c = int(math.ceil(cfg.top_k * group_tokens * cap_factor / cfg.n_experts))
    return max(c, cfg.top_k)


class Routing(NamedTuple):
    """One MoE layer's routing of ``G`` groups of ``T`` tokens."""
    probs: torch.Tensor        # (G, T, E) f32 router softmax
    expert_idx: torch.Tensor   # (G, T, K) the top-k experts, best first
    expert_mask: torch.Tensor  # (G, T, E) f32 in {0, 1}
    gate_e: torch.Tensor       # (G, T, E) f32 gate per (token, expert)
    pos: torch.Tensor          # (G, T, E) f32 slot in the expert's buffer
    capacity: int

    def dropped(self) -> torch.Tensor:
        """The (token, expert) claims past capacity: (G, T, E) bool."""
        return (self.expert_mask > 0) & (self.pos >= self.capacity)


def route(ht: torch.Tensor, router: torch.Tensor, cfg: ModelConfig, cap: int) -> Routing:
    """The router over normed tokens ``ht`` (G, T, D): logits in the model
    dtype, softmax in f32, top-k by a stable descending sort (lower expert
    first on equal probabilities, as ``jax.lax.top_k``), the top-k gates
    renormalised with a floor of 1e-9 and summed per expert, and each
    claim's slot in token order."""
    logits = dot(ht, router).float()
    probs = torch.softmax(logits, dim=-1)
    order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals = order.values[..., :cfg.top_k]
    expert_idx = order.indices[..., :cfg.top_k]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)
    # Reduce the K claims to per-(token, expert) masks first (a token picks
    # each expert at most once) so no (T, K, E, C) tensor ever exists.
    onehot_k = F.one_hot(expert_idx, cfg.n_experts).float()          # (G, T, K, E)
    expert_mask = onehot_k.sum(dim=2)
    gate_e = (onehot_k * gate_vals[..., None]).sum(dim=2)
    pos = torch.cumsum(expert_mask, dim=1) - expert_mask               # token order
    return Routing(probs, expert_idx, expert_mask, gate_e, pos, cap)


def _combine(combine: torch.Tensor, ye: torch.Tensor) -> torch.Tensor:
    """``einsum("gtec,gecd->gtd", combine, ye)`` as a product batched over
    the groups with ``(E, C)`` folded experts first: einsum folds them
    capacity first, and DTensor refuses to fold the split expert dim behind
    another (the card's torch; newer ones make a strided shard)."""
    g, t, e, c = combine.shape
    return torch.bmm(combine.reshape(g, t, e * c), ye.reshape(g, e * c, ye.shape[-1]))


def moe_ffn(
    x: torch.Tensor, p: Dict[str, torch.Tensor], cfg: ModelConfig,
    cap_factor: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (x + output, aux load-balance loss)."""
    b, s, d = x.shape
    h = rms_norm(x, p["ln"])

    t_total = b * s
    g_tok = min(MOE_GROUP_TOKENS, t_total)
    assert t_total % g_tok == 0, f"tokens {t_total} not divisible by group {g_tok}"
    n_groups = t_total // g_tok
    e = cfg.n_experts
    cap = _capacity(cfg, g_tok, cap_factor or cfg.capacity_factor)

    ht = constrain(h.reshape(n_groups, g_tok, d), "batch", None, "embed")
    r = route(ht, p["router"], cfg, cap)
    # A slot >= cap matches no column: overflow claims drop out.
    slots = torch.arange(cap, device=x.device, dtype=r.pos.dtype)
    slot = (r.pos[..., None] == slots).to(x.dtype)                     # (G, T, E, C)
    dispatch = slot * r.expert_mask.to(x.dtype)[..., None]
    combine = dispatch * r.gate_e.to(x.dtype)[..., None]

    xe = torch.einsum("gtec,gtd->gecd", dispatch, ht)                  # (G, E, C, D)
    xe = constrain(xe, "batch", "experts", None, "embed")
    # The expert FFN as products batched over the experts, each expert's
    # (G*C, D) tokens in one matrix: the products einsum("gecd,edf->gecf")
    # and einsum("gecf,efd->gecd") make. Written out, the activations stay
    # expert-major between them (DTensor mislays the strides of einsum's
    # own permuted views in the backward).
    g_n, _, c_n, _ = xe.shape
    xm = xe.transpose(0, 1).reshape(e, g_n * c_n, d)                   # (E, G*C, D)
    a = silu(torch.bmm(xm, p["w_gate"])) * torch.bmm(xm, p["w_up"])    # (E, G*C, F)
    ye = torch.bmm(a, p["w_down"]).reshape(e, g_n, c_n, d).transpose(0, 1)
    ye = constrain(ye, "batch", "experts", None, "embed")
    y = fit_rows(_combine(combine, ye), b).reshape(b, s, d)

    if "shared" in p:
        sh = p["shared"]
        y = y + dot(silu(dot(h, sh["w_gate"])) * dot(h, sh["w_up"]), sh["w_down"])

    # Load-balance aux (Switch): E * sum_e f_e * p_e.
    frac = r.expert_mask.mean(dim=(0, 1))                              # fraction routed
    prob = r.probs.mean(dim=(0, 1))
    aux = e * torch.sum(frac * prob)
    return x + constrain(y, "batch", "seq", "embed"), aux
