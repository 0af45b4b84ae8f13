"""Logical-axis sharding rules (MaxText-style), on ``torch.distributed`` meshes.

Counterpart of ``repro.parallel.sharding``. Every parameter and activation
in the model code is annotated with *logical* axis names ("embed", "mlp",
"q_heads", ...). A rules table maps logical names to mesh axes; changing the
table lays the same model over a mesh differently, and sharding choices never
leak into model code.

A spec is what the reference's ``PartitionSpec`` holds: one entry per tensor
dim, each ``None``, a mesh-axis name or a tuple of them. On a
``torch.distributed.device_mesh.DeviceMesh`` (named dims) a spec becomes
DTensor placements, one per mesh dim: ``Shard(d)`` where tensor dim ``d``'s
entry names that mesh dim, ``Replicate()`` elsewhere and on a mesh dim of
size 1 (which splits nothing, as in JAX; it also spares older DTensor
releases the reshapes of a "sharded" dim they refuse). A tensor dim over
several mesh dims, as ``("pod", "data")`` for ``batch``, is split over them
in mesh-dim order (major first), so the rank at mesh coordinate ``(p, d)``
holds chunk ``p * |data| + d``: the slice JAX gives the device at the same
place of a row-major ``jax.make_mesh``. An entry that names mesh dims out of
the mesh's order would need DTensor's strided shards and is refused.

Where the reference has ``jax.lax.with_sharding_constraint`` and GSPMD
propagates layouts through ``jit``, the port has DTensor: :func:`constrain`
redistributes a DTensor, and :func:`place` lays a global tensor over a mesh
(``distribute_tensor``), which the step's state and batch builders use.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Dict, Mapping, Optional, Sequence, Tuple, Union

import torch

MeshAxes = Union[None, str, Tuple[str, ...]]
PartitionSpec = Tuple[MeshAxes, ...]   # one entry per tensor dim


# Baseline logical->mesh mapping for a (data, model) mesh; make_rules swaps
# "batch" to ("pod","data") on the multi-pod mesh and per-arch/per-shape
# overrides are applied on top (see configs + launch/mesh.make_rules).
BASE_RULES: Dict[str, MeshAxes] = {
    # activations
    "batch": "data",
    "seq": None,
    "kv_seq": None,
    "embed": None,
    "act_mlp": "model",
    "act_heads": "model",
    "act_vocab": "model",
    # params -- dense
    "embed_param": None,      # fsdp: "data"
    "vocab": "model",
    "mlp": "model",
    "q_heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "qkv_in": None,           # fsdp: "data"
    "mlp_in": None,           # fsdp: "data"
    "norm": None,
    # params -- moe
    "experts": "model",
    "expert_in": None,        # fsdp: "data"
    "expert_mlp": None,
    # params -- ssm / rwkv
    "d_inner": "model",
    "d_state": None,
    "d_conv": None,
    "rwkv_heads": "model",
    "rwkv_key": None,
    "rwkv_value": None,
    "rwkv_lora": None,
    # vlm / audio
    "vision_seq": None,
    "vision_embed": None,
    "codebooks": None,
    # stacking
    "layers": None,
    "groups": None,
    # snn -- destination (fan-in/column) sharding: postsynaptic columns
    # shard, the presynaptic axis replicates, so every output column is
    # reduced over its full fan-in on one rank (bit-exact; see
    # repro_torch.parallel.snn_sharding and DESIGN.md §15).
    "neurons_pre": None,
    "neurons_post": "model",
    "inputs": None,
    "time": None,
    "delay": None,
}


def _flat(entry: MeshAxes) -> Tuple[str, ...]:
    return (entry,) if isinstance(entry, str) else tuple(entry or ())


def placements_of(mesh, spec: Sequence[MeshAxes]) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: for each mesh dim,
    ``Shard(d)`` if tensor dim ``d``'s entry names it and the mesh dim has
    more than one rank, else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names or ())
    sizes = tuple(mesh.mesh.shape)
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        axes = _flat(entry)
        idx = []
        for a in axes:
            if a not in names:
                raise ValueError(f"spec entry {entry!r} names mesh axis {a!r}; "
                                 f"the mesh has {names}")
            idx.append(names.index(a))
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry!r} names mesh axes out of the mesh's order "
                             f"{names}: DTensor would split it minor-first")
        for i in idx:
            if sizes[i] > 1:
                out[i] = Shard(d)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh: the reference's ``jax.sharding.NamedSharding``."""

    mesh: object   # torch.distributed.device_mesh.DeviceMesh
    spec: PartitionSpec

    @property
    def placements(self) -> tuple:
        return placements_of(self.mesh, self.spec)


@dataclasses.dataclass(frozen=True)
class AxisRules:
    mapping: Mapping[str, MeshAxes]
    mesh: Optional[object] = None   # torch.distributed.device_mesh.DeviceMesh

    def spec(self, axes: Sequence[Optional[str]]) -> PartitionSpec:
        entries = []
        used = set()
        for a in axes:
            if a is None:
                entries.append(None)
                continue
            if a not in self.mapping:
                raise KeyError(f"unknown logical axis {a!r}")
            e = self.mapping[a]
            # A mesh axis may appear at most once per spec; when rule
            # overrides collide (e.g. Megatron-SP seq="model" meeting an
            # interior heads="model" constraint), earlier dims win.
            flat = _flat(e)
            if any(f in used for f in flat):
                entries.append(None)
                continue
            used.update(flat)
            entries.append(e)
        return tuple(entries)

    def sharding(self, axes: Sequence[Optional[str]]) -> Optional[NamedSharding]:
        """None without a mesh; else the spec of ``axes`` on the mesh, whose
        ``placements`` are the DTensor placements."""
        if self.mesh is None:
            return None
        return NamedSharding(self.mesh, self.spec(axes))

    def placements(self, axes: Sequence[Optional[str]]) -> Optional[tuple]:
        s = self.sharding(axes)
        return None if s is None else s.placements

    def with_overrides(self, overrides: Mapping[str, MeshAxes]) -> "AxisRules":
        m = dict(self.mapping)
        m.update(overrides)
        return AxisRules(mapping=m, mesh=self.mesh)

    def with_mesh(self, mesh) -> "AxisRules":
        return AxisRules(mapping=self.mapping, mesh=mesh)


_ctx = threading.local()


def current_rules() -> Optional[AxisRules]:
    return getattr(_ctx, "rules", None)


@contextlib.contextmanager
def use_rules(rules: Optional[AxisRules]):
    prev = current_rules()
    _ctx.rules = rules
    try:
        yield rules
    finally:
        _ctx.rules = prev


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def place(x: torch.Tensor, sharding: Optional[NamedSharding]) -> torch.Tensor:
    """``x``, a global tensor that every rank holds alike, laid over
    ``sharding``'s mesh: each rank keeps its own slice (``distribute_tensor``
    with no source rank, so nothing is sent). A DTensor is redistributed.
    ``None`` returns ``x``. The reference's ``jax.device_put(x, sharding)``."""
    if sharding is None:
        return x
    from torch.distributed.tensor import distribute_tensor

    if is_dtensor(x):
        return x.redistribute(sharding.mesh, sharding.placements)
    return distribute_tensor(x.detach(), sharding.mesh, sharding.placements,
                             src_data_rank=None)


def gather(x):
    """A DTensor's full value on every rank (``full_tensor()``); any other
    value as it is."""
    return x.full_tensor() if is_dtensor(x) else x


def constrain(x: torch.Tensor, *axes: Optional[str]) -> torch.Tensor:
    """Apply a sharding constraint if rules with a mesh are active; else
    return ``x`` itself.

    Under a mesh a DTensor is redistributed to the spec's placements, which
    moves data and changes no number (a ``Partial`` sum is reduced); a dim
    that the spec's mesh axes would split unevenly is split only over those
    that divide it (:func:`even_placements`). Its gradient is laid out as
    the value is, as JAX lays out a constraint's cotangent. A plain
    tensor under a mesh is taken as replicated on every rank
    (``DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim)``: every rank
    must hold the same value, as the reference's trace-time constants are)
    and then redistributed, so it leaves as a DTensor.
    """
    rules = current_rules()
    if rules is None or rules.mesh is None:
        return x
    if len(axes) != x.ndim:
        raise ValueError(f"rank mismatch: {len(axes)} axes for shape {tuple(x.shape)}")
    from torch.distributed.tensor import DTensor, Replicate

    placements = even_placements(rules.mesh, rules.placements(axes), x.shape)
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, rules.mesh, [Replicate()] * rules.mesh.ndim,
                               run_check=False)
    return relayout(x, placements)


def relayout(x, placements: Sequence) -> torch.Tensor:
    """The DTensor ``x`` redistributed to ``placements`` (one per mesh dim),
    its gradient laid out as the value is (:class:`_GradLayout`)."""
    placements = tuple(placements)
    if tuple(x.placements) != placements:
        if not any(p.is_partial() for p in x.placements):   # a pending sum is left as it is
            x = _GradLayout.apply(x, False)
        x = x.redistribute(x.device_mesh, placements)
    return _GradLayout.apply(x, True)


def all_to_all_on_cpu() -> None:
    """Have DTensor move a split from one tensor dim to another over a mesh
    dim of CPU ranks (``Shard(a)`` to ``Shard(b)``: the head's logits from
    the vocab to the sequence, say) by one all-to-all of the local shards
    (:func:`_shard_dim_all_to_all`), as it does over NCCL on the card.
    DTensor's own CPU path gathers the whole tensor on every rank and keeps
    a chunk ("Gloo does not support alltoall"), though gloo and the fake
    process group of the dry run run ``all_to_all_single``: so the gloo
    worlds and the dry run's fake world held the whole tensor where the
    card holds its shards. Every mesh of :func:`repro_torch.launch.mesh.make_mesh`
    on the CPU installs it; a mesh of another device keeps DTensor's own
    path. Idempotent."""
    from torch.distributed.tensor import placement_types

    real = getattr(placement_types, "shard_dim_alltoall", None)
    if real is None or getattr(real, "all_to_all_on_cpu", False):
        return

    def shard_dim_alltoall(local, gather_dim, shard_dim, mesh, mesh_dim):
        if mesh.device_type != "cpu":
            return real(local, gather_dim, shard_dim, mesh, mesh_dim)
        return _shard_dim_all_to_all(local, gather_dim, shard_dim, mesh, mesh_dim)

    shard_dim_alltoall.all_to_all_on_cpu = True
    placement_types.shard_dim_alltoall = shard_dim_alltoall


def _shard_dim_all_to_all(local, a: int, b: int, mesh, i: int) -> torch.Tensor:
    """This rank's shard split along ``b`` over mesh dim ``i`` from its
    shard split along ``a`` (``local``, which DTensor has padded so that
    ``b`` splits evenly): the ``b`` chunk of each rank of the mesh dim sent
    to it, and the ``a`` chunks received laid side by side in rank order,
    in one ``all_to_all_single``. DTensor's redistribution wraps it for
    autograd (its backward is the move back) and unpads."""
    from torch.distributed import _functional_collectives as funcol

    k = mesh.size(i)
    got = funcol.all_to_all_single(local.movedim(b, 0).contiguous(), None, None, (mesh, i))
    if isinstance(got, funcol.AsyncCollectiveTensor):
        got = got.wait()
    return torch.cat([piece.movedim(0, b) for piece in got.split(local.shape[b] // k)],
                     dim=a)


def grad_laid_out(x):
    """``x`` itself; where it is a DTensor, its gradient is reduced onto
    ``x``'s own placements as soon as autograd makes it (a partial sum
    reduce-scattered), rather than when the gradient of what ``x`` was cut
    from is. A stacked parameter's groups go through it one by one, so each
    group's weight gradient is reduced as its layer's backward ends, as the
    reference's scan reduces it, and no rank holds the partial gradients of
    every group at once (16 times a group's sharded gradient on a mesh whose
    ``data`` ranks split it)."""
    return _GradLayout.apply(x, True) if is_dtensor(x) else x


class _GradLayout(torch.autograd.Function):
    """The identity on a DTensor; its backward gives the gradient a
    contiguous local shard and contiguous strides, and with ``relayout``
    lays it out as the value is laid out (the cotangent of
    ``with_sharding_constraint`` takes the same sharding in JAX). Without
    it a gradient keeps whatever layout the backward's ops chose (a
    weight's columns over ``model``, say) and a later view of it may be
    refused; and a redistribution's backward can hand back a local shard
    laid out otherwise than the strides its DTensor claims, which a later
    view of the gradient fails on."""

    @staticmethod
    def forward(ctx, x, relayout: bool):
        from torch.distributed.tensor import Replicate

        # a pending sum's gradient is whole on every rank
        ctx.layout = (x.device_mesh, tuple(Replicate() if p.is_partial() else p
                                           for p in x.placements)) if relayout else None
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if not is_dtensor(g):
            return g, None
        from torch.distributed.tensor import DTensor

        if ctx.layout is not None and tuple(g.placements) != ctx.layout[1]:
            g = g.redistribute(*ctx.layout)
        stride = torch.empty(g.shape, device="meta").stride()
        local = g.to_local()
        if local.is_contiguous() and tuple(g.stride()) == tuple(stride):
            return g, None
        return DTensor.from_local(local.contiguous(), g.device_mesh, g.placements,
                                  run_check=False, shape=g.shape, stride=stride), None


def split_over(mesh, dims: Mapping[int, Sequence[int]]) -> tuple:
    """Placements on ``mesh``, one per mesh dim: ``Shard(d)`` on the mesh
    dims ``dims[d]`` (in mesh order), ``Replicate()`` elsewhere."""
    from torch.distributed.tensor import Replicate, Shard

    out = [Replicate() for _ in range(mesh.ndim)]
    for d, idx in dims.items():
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def _ways(x) -> list:
    """How many ways each dim of the DTensor ``x`` is split."""
    sizes = x.device_mesh.mesh.shape
    ways = [1] * x.ndim
    for i, p in enumerate(x.placements):
        if p.is_shard():
            ways[p.dim] *= sizes[i]
    return ways


def even_placements(mesh, placements: Sequence, shape: Sequence[int]) -> tuple:
    """``placements`` with each tensor dim split only over mesh dims whose
    ranks divide it: of the mesh dims that shard the dim, the subset with
    the most ranks that divides it (the major ones on a tie) keeps its
    ``Shard``, the others replicate. DTensor refuses every view that moves
    an uneven shard, where the reference's GSPMD pads: one MoE token group
    of a decode step over 16 ``data`` ranks, or a microbatch of 16 rows over
    32 ``("pod", "data")`` ranks."""
    import itertools

    from torch.distributed.tensor import Replicate

    sizes = tuple(mesh.mesh.shape)
    out = list(placements)
    for d, n in enumerate(shape):
        idx = [i for i, p in enumerate(placements) if p.is_shard(d)]
        if not idx or n % math.prod(sizes[i] for i in idx) == 0:
            continue
        keep = max((c for k in range(len(idx) + 1) for c in itertools.combinations(idx, k)
                    if n % math.prod(sizes[i] for i in c) == 0),
                   key=lambda c: (math.prod(sizes[i] for i in c), [-i for i in c]))
        for i in idx:
            if i not in keep:
                out[i] = Replicate()
    return tuple(out)


def fit_rows(x: torch.Tensor, rows: int) -> torch.Tensor:
    """``x``, whose first dim is about to be reshaped into ``rows`` rows
    (the MoE's token groups back into the batch), with that dim split only
    over the mesh axes that also divide ``rows``: a microbatch of 16 rows
    splits over ``data`` alone on the multi-pod mesh, its 128 groups over
    ``("pod", "data")``, and DTensor mislays the shards of a reshape
    between the two. Plain tensors pass as they are."""
    if not is_dtensor(x):
        return x
    want = even_placements(x.device_mesh, x.placements, (rows,) + tuple(x.shape[1:]))
    if tuple(want) == tuple(x.placements):
        return x
    return x.redistribute(x.device_mesh, want)


def _flatten_refused(x) -> bool:
    """Whether flattening ``x``'s leading dims (all but the last) would move
    a shard: a leading dim past the first is sharded, or the first is split
    unevenly. DTensor refuses that view (``aten.view``; the torch of the
    card also for a dim past the first that splits evenly)."""
    ways = _ways(x)
    return any(w > 1 for w in ways[1:-1]) or x.shape[0] % ways[0] != 0


def local_offsets(x) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """``(local shape, global offset)`` of this rank's shard of the DTensor ``x``."""
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    shape, offset = compute_local_shape_and_global_offset(x.shape, x.device_mesh, x.placements)
    return tuple(shape), tuple(offset)


def folded_bmm(a: torch.Tensor, b: torch.Tensor, mesh, pa: Sequence,
               pb: Sequence) -> torch.Tensor:
    """``a @ b`` of two local 4-D blocks (a rank's batch rows and heads,
    then the matrices), dispatched as one DTensor ``bmm``: the two leading
    dims are folded locally, as ``@`` folds them, and each operand becomes
    the shard of a global ``(groups, m, k)`` tensor laid out by ``pa`` /
    ``pb`` (``Shard(0)`` on each mesh dim that splits the rank's groups;
    ``Shard(1)`` / ``Shard(2)`` where a mesh dim splits a matrix dim). The
    product is the DTensor ``(groups, m, n)``; a ``Partial`` sum where the
    split dim is contracted. Nothing is gathered, and the cost recording
    sees the product at its global shapes, as a sharded einsum's.

    The folded order of the groups is the ranks' order, not a row-major
    fold of (batch, heads): only row-wise ops may touch the product before
    :meth:`to_local` unfolds it on the rank that made it."""
    from torch.distributed.tensor import DTensor

    fa = DTensor.from_local(a.reshape((-1,) + tuple(a.shape[2:])), mesh, tuple(pa),
                            run_check=False)
    fb = DTensor.from_local(b.reshape((-1,) + tuple(b.shape[2:])), mesh, tuple(pb),
                            run_check=False)
    return torch.bmm(fa, fb)


def dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for a 3-D ``x`` (..., K) and a 2-D ``w``.

    ``@`` flattens ``x``'s leading dims into one, a view that DTensor
    refuses when it would move a shard (a sequence sharded over ``model``
    by the Megatron-SP rule, on the card's torch). On such a
    DTensor the product is a ``bmm`` over the first dim against ``w``
    broadcast to it (an ``expand``, which copies nothing), and each row's
    sum is the same dot product. Elsewhere, plain tensors included, it is
    ``x @ w`` itself."""
    if x.ndim == 3 and is_dtensor(x) and _flatten_refused(x):
        return torch.bmm(x, w.expand((x.shape[0],) + tuple(w.shape)))
    return x @ w


def fsdp_overrides() -> Dict[str, MeshAxes]:
    """ZeRO-3-style parameter sharding for >=15B archs: the non-"model"
    major axis of every large matrix also shards over "data"."""
    return {
        "embed_param": "data",
        "qkv_in": "data",
        "mlp_in": "data",
        "expert_in": "data",
    }


def multipod_overrides() -> Dict[str, MeshAxes]:
    """Batch additionally shards over the pod axis (pure-DP across pods)."""
    return {"batch": ("pod", "data")}


def seq_shard_overrides(data_axes: MeshAxes = "data") -> Dict[str, MeshAxes]:
    """long_500k (global_batch=1): shard sequence instead of batch."""
    return {"batch": None, "seq": data_axes, "kv_seq": data_axes}
