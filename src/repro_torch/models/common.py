"""Shared model machinery: param specs, init, norms, rotary embeddings.

Counterpart of ``repro.models.common``. Parameters are plain trees (nested
dicts and lists of tensors). Each leaf is described once by a :class:`Spec`
carrying shape, logical axes and init style; ``init_params``,
``zeros_params``, ``param_count``, ``logical_axes`` and ``shape_structs``
all derive from the same spec tree, so sharding annotations can never drift
from the parameter structure.

The draws are the port's own, from a ``torch.Generator`` (a deliberate
difference, ROADMAP §C): the shapes, dtypes and std rule are the
reference's, the random numbers are not. Parity tests carry the reference's
draws across with :func:`repro_torch.interop.lm_params_from_numpy`.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import device as _device
from repro_torch.parallel.sharding import is_dtensor, local_offsets

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "int32": torch.int32}


def torch_dtype(name) -> torch.dtype:
    """A dtype name of the configs (``"bfloat16"``, ...) as a torch dtype."""
    return name if isinstance(name, torch.dtype) else DTYPES[name]


@dataclasses.dataclass(frozen=True)
class Spec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"       # normal | zeros | ones | small
    scale: float = 1.0         # fan-in override multiplier
    dtype: Optional[str] = None  # override model dtype (e.g. f32 SSM states)

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape/axes rank mismatch: {self.shape} vs {self.axes}")


def map_specs(fn: Callable[[Spec], object], tree):
    """``fn`` applied to every :class:`Spec` of a tree of dicts and lists."""
    if isinstance(tree, Spec):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_specs(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_specs(fn, v) for v in tree)
    raise TypeError(f"not a spec tree: {type(tree).__name__}")


def init_params(specs, gen: torch.Generator, dtype="bfloat16", device=None):
    """Materialize a spec tree on ``device`` from ``gen``: normal draws in f32
    times the reference's std (``scale / sqrt(fan_in)``, fan_in the product
    of every dim but the last, a stacked leaf's groups axis included; ``0.02
    * scale`` for ``small``), cast to the leaf's dtype. A stacked leaf
    (leading ``groups`` axis) is drawn slab by slab into its buffer, so the
    transient f32 draw is one slab and the peak stays near the parameters'
    bytes."""
    dev = _device.resolve(device)

    def draw(spec: Spec) -> torch.Tensor:
        leaf_dtype = torch_dtype(spec.dtype or dtype)
        if spec.init == "zeros":
            return torch.zeros(spec.shape, dtype=leaf_dtype, device=dev)
        if spec.init == "ones":
            return torch.ones(spec.shape, dtype=leaf_dtype, device=dev)
        fan_in = max(1, math.prod(spec.shape[:-1]) if len(spec.shape) > 1 else spec.shape[0])
        std = spec.scale * 0.02 if spec.init == "small" else spec.scale / math.sqrt(fan_in)
        if spec.axes[:1] != ("groups",):
            a = torch.randn(spec.shape, generator=gen, dtype=torch.float32, device=dev)
            return (a * std).to(leaf_dtype)
        out = torch.empty(spec.shape, dtype=leaf_dtype, device=dev)
        for g in range(spec.shape[0]):
            a = torch.randn(spec.shape[1:], generator=gen, dtype=torch.float32, device=dev)
            out[g] = a * std
        return out

    return map_specs(draw, specs)


def zeros_params(specs, dtype="bfloat16", device=None):
    """All-zeros materialization (cache init)."""
    dev = _device.resolve(device)
    return map_specs(lambda s: torch.zeros(s.shape, dtype=torch_dtype(s.dtype or dtype),
                                           device=dev), specs)


def stack_specs(specs, n: int, axis_name: Optional[str] = "groups"):
    """Prepend a stacking dim (the loop over groups) to every leaf spec."""
    return map_specs(
        lambda s: Spec((n,) + s.shape, (axis_name,) + s.axes, s.init, s.scale, s.dtype), specs)


@dataclasses.dataclass(frozen=True)
class ShapeDtypeStruct:
    """A leaf's shape, dtype and sharding, allocating nothing: the
    reference's ``jax.ShapeDtypeStruct``. A frozen record, not a NamedTuple,
    so that trees of them (``repro_torch.util.tree``) keep it as a leaf."""

    shape: Tuple[int, ...]
    dtype: torch.dtype
    sharding: Optional[object] = None   # parallel.sharding.NamedSharding


def shape_structs(specs, dtype="bfloat16", rules=None):
    """ShapeDtypeStructs (+ shardings if rules given) of a spec tree."""
    def mk(s: Spec):
        sharding = rules.sharding(s.axes) if rules is not None else None
        return ShapeDtypeStruct(tuple(s.shape), torch_dtype(s.dtype or dtype), sharding)
    return map_specs(mk, specs)


def logical_axes(specs):
    return map_specs(lambda s: s.axes, specs)


def shapes_of(specs):
    return map_specs(lambda s: s.shape, specs)


def param_count(specs) -> int:
    sizes = []
    map_specs(lambda s: sizes.append(math.prod(s.shape)), specs)
    return sum(sizes)


# ---------------------------------------------------------------------------
# numerics


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * gamma.float()).to(x.dtype)


def rope_freqs(d_head: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, d_head, 2, dtype=torch.float32, device=device) / d_head
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., seq, heads, d_head); positions: (..., seq) integers. The
    split-half rotation, in f32."""
    d_head = x.shape[-1]
    freqs = rope_freqs(d_head, theta, x.device)             # (d_head/2,)
    angles = positions[..., None].float() * freqs            # (..., seq, d/2)
    cos = torch.cos(angles)[..., None, :]                    # (..., seq, 1, d/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def sinusoidal_pos_embed(positions: torch.Tensor, d_model: int) -> torch.Tensor:
    """MusicGen-style absolute sinusoidal embedding; positions (..., seq)."""
    half = d_model // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, dtype=torch.float32, device=positions.device) / half)
    ang = positions[..., None].float() * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean token NLL; logits in any float dtype (softmax in f32). On a mesh
    whose ranks split the vocab, each rank's own vocab shard
    (:func:`_split_nll`)."""
    if is_dtensor(logits) and any(p.is_shard(logits.ndim - 1) for p in logits.placements):
        return _split_nll(logits, labels).mean()
    lp = torch.log_softmax(logits.float(), dim=-1)
    if is_dtensor(lp):
        return (-_picked(lp, labels)).mean()
    nll = -torch.gather(lp, -1, labels[..., None].long())[..., 0]
    return nll.mean()


def _picked(lp: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``lp[..., labels]`` of a DTensor ``lp`` (the vocab whole on every
    rank, as DTensor's softmax leaves it), each rank picking from its own
    rows with their labels. ``torch.gather`` on the DTensor would do the
    same in the forward, but its backward makes its zeros (``new_zeros``)
    at the global shape of ``lp`` on every rank: the whole (B, T, V) f32
    gradient of the logits."""
    from torch.distributed.tensor import DTensor

    if is_dtensor(labels):
        labels = labels.redistribute(lp.device_mesh, lp.placements).to_local()
    else:
        shape, off = local_offsets(lp)
        labels = labels[tuple(slice(o, o + n) for o, n in zip(off[:-1], shape[:-1]))]
    out = torch.gather(lp.to_local(), -1, labels[..., None].long())[..., 0]
    return DTensor.from_local(out, lp.device_mesh, lp.placements, run_check=False)


def _split_nll(logits, labels):
    """The NLL of each token of the DTensor ``logits``, whose vocab (last
    dim) some mesh dims split, as the reference's partitioned
    ``log_softmax`` computes it: each rank's max of its own vocab shard,
    then the max all-reduced over those mesh dims; its sum of
    ``exp(x - max)``, then that sum all-reduced; the label's logit from the
    rank that holds it, summed over them. The backward is each rank's own
    ``softmax - onehot`` shard. No rank holds a row of the whole vocab. The
    NLL lies as the logits' rows do, whole over the vocab's mesh dims."""
    from torch.distributed.tensor import DTensor, Replicate

    mesh, v = logits.device_mesh, logits.ndim - 1
    split = tuple(i for i, p in enumerate(logits.placements) if p.is_shard(v))
    rows = tuple(Replicate() if p.is_shard(v) else p for p in logits.placements)
    shape, off = local_offsets(logits)
    if is_dtensor(labels):
        labels = labels.redistribute(mesh, rows).to_local()
    else:
        labels = labels[tuple(slice(o, o + n) for o, n in zip(off[:-1], shape[:-1]))]
    nll = _VocabNLL.apply(logits.to_local(), labels, off[-1], mesh, split)
    return DTensor.from_local(nll, mesh, rows, run_check=False, shape=logits.shape[:-1],
                              stride=torch.empty(logits.shape[:-1], device="meta").stride())


class _VocabNLL(torch.autograd.Function):
    """``-log_softmax(x)[label]`` of each row of a local vocab shard ``x``
    (its first column ``v0`` of the vocab), the softmax's max and sum and
    the picked logit all-reduced over the mesh dims ``split``; in float32,
    with one float32 temporary of ``x``'s size each way."""

    @staticmethod
    def forward(ctx, x, labels, v0: int, mesh, split):
        from torch.distributed import _functional_collectives as funcol

        def reduce(t, op):
            for i in split:
                t = funcol.all_reduce(t, op, (mesh, i))
            return t.wait() if isinstance(t, funcol.AsyncCollectiveTensor) else t

        m = reduce(x.amax(dim=-1, keepdim=True).float(), "max")
        e = x - m
        s = reduce(e.exp_().sum(dim=-1, keepdim=True), "sum")
        del e
        at = labels.long()[..., None] - v0
        hit = (at >= 0) & (at < x.shape[-1])
        at = at.clamp(0, x.shape[-1] - 1)
        picked = reduce(torch.where(hit, torch.gather(x, -1, at).float(), 0.0), "sum")
        ctx.save_for_backward(x, m, s, at, hit)
        return -((picked - m) - torch.log(s))[..., 0]

    @staticmethod
    def backward(ctx, g):
        x, m, s, at, hit = ctx.saved_tensors
        p = x - m
        p.exp_().div_(s)
        p.scatter_add_(-1, at, -hit.to(p.dtype))
        p.mul_(g[..., None])
        return p.to(x.dtype), None, None, None, None


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def silu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x)
