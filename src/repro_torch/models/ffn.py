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

On a ``DeviceMesh`` (DTensor tokens) the layout is the reference's under
GSPMD: each rank runs the router, the dispatch, the three expert products
and the combine on its own block of (groups, experts), the groups over the
``batch`` mesh dims and the experts over ``model`` (:class:`_Block`). The
router computes the rank's own expert columns and one all-gather makes the
f32 logits whole for the softmax and the top-k; the combine contracts over
the split experts, a partial sum reduced where the output is constrained
to the residual stream. Each product is one DTensor ``mm`` / ``bmm`` of the
local blocks, so nothing is gathered and a cost recording sees it at its
global shapes. Where the groups split over fewer mesh dims than the batch
(decode's one group), the spare mesh dims split the model width instead
(a deliberate difference, ROADMAP §C: the reference pads the group and
computes it on every rank). Plain tensors take the plain ops, unchanged.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import Spec, gelu, rms_norm, silu
from repro_torch.parallel.sharding import (constrain, current_rules, dot, even_placements,
                                           fit_rows, is_dtensor, relayout, split_over)

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


class _Block(NamedTuple):
    """A rank's block of the MoE FFN on a mesh: the mesh dims that split the
    token groups (``groups``, the ``batch`` dims that divide them), the
    experts (``experts``) and, of the other mesh dims, those that split the
    model width (``embed``: decode's one group splits over no ``batch``
    dim, so those dims split D rather than compute the group whole)."""
    mesh: object
    groups: tuple
    experts: tuple
    embed: tuple

    def at(self, dims) -> tuple:
        """Placements with tensor dim ``d`` split over the block's mesh dims
        named ``dims[d]`` ("groups", "experts" or "embed")."""
        return split_over(self.mesh, {d: getattr(self, n) for d, n in dims.items()})


def _block(ht, n_experts: int) -> Optional[_Block]:
    """The block of the tokens ``ht`` (G, T, D); None off a mesh."""
    if not is_dtensor(ht):
        return None
    mesh = ht.device_mesh
    g, _, d = ht.shape
    want = even_placements(mesh, current_rules().placements(("batch", "experts")),
                           (g, n_experts))
    groups = tuple(i for i, p in enumerate(want) if p.is_shard(0))
    experts = tuple(i for i, p in enumerate(want) if p.is_shard(1))
    spare = [i for i, n in enumerate(mesh.mesh.shape) if n > 1 and i not in groups + experts]
    embed = even_placements(mesh, split_over(mesh, {0: spare}), (d,))
    return _Block(mesh, groups, experts, tuple(i for i in spare if embed[i].is_shard()))


def _logits(ht, router, blk: Optional[_Block]) -> torch.Tensor:
    """``ht @ router`` cast to f32. On a mesh each rank computes its own
    rows and expert columns (a partial sum over the ``embed`` dims, reduced
    in the model dtype), and the f32 logits are made whole over the experts
    by one all-gather."""
    if blk is None:
        return dot(ht, router).float()
    g, t, d = ht.shape
    w = relayout(router, blk.at({0: "embed", 1: "experts"}))
    logits = relayout(torch.mm(ht.reshape(g * t, d), w), blk.at({0: "groups", 1: "experts"}))
    return relayout(logits.float(), blk.at({0: "groups"})).reshape(g, t, -1)


def route(ht: torch.Tensor, router: torch.Tensor, cfg: ModelConfig, cap: int,
          block: Optional[_Block] = None) -> Routing:
    """The router over normed tokens ``ht`` (G, T, D): logits in the model
    dtype, softmax in f32, top-k by a stable descending sort (lower expert
    first on equal probabilities, as ``jax.lax.top_k``), the top-k gates
    renormalised with a floor of 1e-9 and summed per expert, and each
    claim's slot in token order. On a mesh ``block`` is the tokens' block
    (:func:`_logits`)."""
    logits = _logits(ht, router, block)
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


def _masks(pos, mask, gate, cap: int, dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """The one-hot dispatch and combine tensors (G, T, E, C) in ``dtype``
    from the routing's (G, T, E) slots, claims and gates. A slot >= cap
    matches no column: overflow claims drop out."""
    slots = torch.arange(cap, device=pos.device, dtype=pos.dtype)
    dispatch = (pos[..., None] == slots).to(dtype) * mask.to(dtype)[..., None]
    return dispatch, dispatch * gate.to(dtype)[..., None]


def _combine(combine: torch.Tensor, ye: torch.Tensor) -> torch.Tensor:
    """``einsum("gtec,gecd->gtd", combine, ye)`` as a product batched over
    the groups with ``(E, C)`` folded experts first."""
    g, t, e, c = combine.shape
    return torch.bmm(combine.reshape(g, t, e * c), ye.reshape(g, e * c, ye.shape[-1]))


def _experts(xe: torch.Tensor, p: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The expert FFN as products batched over the experts, each expert's
    (G*C, D) tokens in one matrix: ``xe`` (G, E, C, D) to ``ye`` alike, the
    products ``einsum("gecd,edf->gecf")`` and ``einsum("gecf,efd->gecd")``
    make. The activations stay expert-major between them."""
    g, e, c, d = xe.shape
    xm = xe.transpose(0, 1).reshape(e, g * c, d)                       # (E, G*C, D)
    a = silu(torch.bmm(xm, p["w_gate"])) * torch.bmm(xm, p["w_up"])    # (E, G*C, F)
    return torch.bmm(a, p["w_down"]).reshape(e, g, c, d).transpose(0, 1)


def _on_block(ht, r: Routing, p: Dict[str, torch.Tensor], blk: _Block, dtype) -> torch.Tensor:
    """The dispatch, the expert FFN and the combine on the rank's own block
    of (groups, experts): the tokens ``ht`` (G, T, D) laid out by ``blk``,
    the routing whole over the experts. Returns ``y`` (G, T, D), a partial
    sum over the ``experts`` mesh dims.

    The dispatch and combine tensors are built from the rank's own expert
    columns of the routing, element for element the plain path's. Each
    product is one DTensor ``mm`` / ``bmm`` whose operands are the local
    blocks laid out as shards of the global ``(G, E*C, T) x (G, T, D)``,
    ``(E, G*C, D) x (E, D, F)``, ``(E, G*C, F) x (E, F, D)`` and ``(G, T,
    E*C) x (G, E*C, D)`` (experts folded before capacity, groups before
    capacity), so no operand is gathered but the expert weights' FSDP
    split; the ``embed`` dims split D (the gate and up products' partial
    sums are reduced before the SwiGLU)."""
    from torch.distributed.tensor import DTensor

    mesh = blk.mesh

    def block(x, dims):
        return DTensor.from_local(x.contiguous(), mesh, blk.at(dims), run_check=False)

    dispatch, combine = _masks(*(relayout(x, blk.at({0: "groups", 2: "experts"})).to_local()
                                 for x in (r.pos, r.expert_mask, r.gate_e)), r.capacity, dtype)
    gl, t, el, c = dispatch.shape                                       # (Gl, T, El, C)

    xe = torch.bmm(block(dispatch.reshape(gl, t, el * c).transpose(1, 2),
                         {0: "groups", 1: "experts"}), ht)               # (G, E*C, D)
    xm = xe.to_local().reshape(gl, el, c, -1).transpose(0, 1).reshape(el, gl * c, -1)
    xm = block(xm, {0: "experts", 1: "groups", 2: "embed"})             # (E, G*C, D)
    rows = blk.at({0: "experts", 1: "groups"})
    gu = [relayout(torch.bmm(xm, relayout(p[k], blk.at({0: "experts", 1: "embed"}))), rows)
          for k in ("w_gate", "w_up")]
    a = silu(gu[0]) * gu[1]                                             # (E, G*C, F)
    ye = torch.bmm(a, relayout(p["w_down"], blk.at({0: "experts", 2: "embed"}))).to_local()
    ye = ye.reshape(el, gl, c, -1).transpose(0, 1).reshape(gl, el * c, -1)
    return torch.bmm(block(combine.reshape(gl, t, el * c), {0: "groups", 2: "experts"}),
                     block(ye, {0: "groups", 1: "experts", 2: "embed"}))   # (G, T, D)


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
    blk = _block(ht, e)
    if blk is not None:
        ht = relayout(ht, blk.at({0: "groups", 2: "embed"}))
    r = route(ht, p["router"], cfg, cap, blk)
    if blk is not None:
        y = _on_block(ht, r, p, blk, x.dtype)
    else:
        dispatch, combine = _masks(r.pos, r.expert_mask, r.gate_e, cap, x.dtype)
        xe = torch.einsum("gtec,gtd->gecd", dispatch, ht)              # (G, E, C, D)
        y = _combine(combine, _experts(xe, p))
    y = fit_rows(y, b).reshape(b, s, d)

    if "shared" in p:
        sh = p["shared"]
        y = y + dot(silu(dot(h, sh["w_gate"])) * dot(h, sh["w_up"]), sh["w_down"])

    # Load-balance aux (Switch): E * sum_e f_e * p_e.
    frac = r.expert_mask.mean(dim=(0, 1))                              # fraction routed
    prob = r.probs.mean(dim=(0, 1))
    aux = e * torch.sum(frac * prob)
    return x + constrain(y, "batch", "seq", "embed"), aux
