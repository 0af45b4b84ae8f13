"""Mesh partitioning of the SNN tick fabric (DESIGN.md §15).

Counterpart of ``repro.parallel.snn_sharding``. The fabric shards by
**destination** (fan-in, column sharding): rank ``i`` of the mesh owns
postsynaptic columns ``[i*n/D, (i+1)*n/D)`` of the synapse matrix ``W`` (and
``C``), the matching slices of ``w_in``, of the LIF parameters and state, its
own delay ring, ``x_post`` and ``elig``; ``x_pre`` is replicated. Each tick,
every rank

1. reads the spikes arriving at its local neurons from its local ring,
2. all-gathers them into the full presynaptic spike vector (the ONE
   collective per tick, ``B*n`` values: :meth:`SNNMesh.all_gather`),
3. computes the complete fan-in product ``s_full @ (W*C)[:, local]`` for its
   columns, on whichever backend, and
4. steps LIF and writes its local ring.

Every output column is still reduced over the full presynaptic axis on one
rank, in the single-device order, so the frozen path is bitwise the
single-device run at every D. The backends take the rectangular operands as
they are: kernel B1 is rectangular in ``(K, N)``, the event kernels B3/B4
gather whole rows of the ``(n, n/D)`` slab by global presynaptic ids, and
kernel B5 takes a full-width ``x_pre`` against a local ``x_post``.

Where the reference runs D simulated devices in one process under
``shard_map``, the port runs D processes (:mod:`repro_torch.parallel.mesh`),
and every rank holds only its own slice. So the operands of
:func:`sharded_scan` (and of the engine's entry points with
``EngineOptions.mesh`` set) are **this rank's** tensors: :func:`place` cuts
them out of a global tree by the spec trees below, and :func:`collect`
gathers a result back to the global layout, one collective a leaf. Its
outputs are this rank's too: the raster ``(T, ..., n/D)``, the carry's local
leaves, and the telemetry combined over the mesh.

Matrices that are too large for one host (``snn-64k``: 16 GiB of f32) are
made rank-local: :func:`make_sharded_dyadic_weights` builds only the rank's
columns.
"""
from __future__ import annotations

import dataclasses
import math
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.core.engine import TickCarry, TickEngine
from repro_torch.core.lif import LIFParams, LIFState
from repro_torch.core.network_types import SNNParams, SNNState
from repro_torch.kernels.ops import EventFanIn
from repro_torch.obs.telemetry import TickTelemetry
from repro_torch.plasticity.stdp import PlasticityState

# A spec is the (negative) dimension of a leaf that the mesh axis cuts, or
# None for a replicated leaf; a spec tree mirrors its tree's records.
Spec = Optional[int]


def snn_rules(axis: str = "model") -> Dict[str, Optional[str]]:
    """The SNN logical -> mesh axis table: destination columns shard over
    ``axis``, everything presynaptic, batch and time replicates."""
    return {
        "batch": None,          # one fabric, batch rides along replicated
        "time": None,
        "delay": None,
        "inputs": None,
        "neurons_pre": None,    # full presynaptic axis on every shard
        "neurons_post": axis,   # the ONE sharded dimension
    }


def _spec(rules: Dict[str, Optional[str]], logical: Tuple[Optional[str], ...]) -> Spec:
    dims = [i - len(logical) for i, name in enumerate(logical)
            if name is not None and rules.get(name)]
    return dims[0] if dims else None


def _vec(rules, a: torch.Tensor) -> Spec:
    """(..., n) -> shard the trailing neuron axis, replicate the rest."""
    return _spec(rules, (None,) * (a.dim() - 1) + ("neurons_post",))


def _mat(rules) -> Spec:
    return _spec(rules, ("neurons_pre", "neurons_post"))


def params_specs(rules, params: SNNParams) -> SNNParams:
    """Spec tree for :class:`SNNParams` (``c=None`` passes through)."""
    return SNNParams(
        w=_mat(rules),
        c=None if params.c is None else _mat(rules),
        w_in=_spec(rules, ("inputs", "neurons_post")),
        lif=LIFParams(**{f.name: _vec(rules, getattr(params.lif, f.name))
                         for f in dataclasses.fields(LIFParams)}))


def state_specs(rules, state: SNNState) -> SNNState:
    return SNNState(
        lif=LIFState(**{f: _vec(rules, getattr(state.lif, f)) for f in ("v", "r", "y")}),
        delay_buf=_vec(rules, state.delay_buf),
        tick=None)


def carry_specs(rules, carry: TickCarry) -> TickCarry:
    """Spec tree for a :class:`TickCarry`.

    ``plast.x_pre`` replicates: presynaptic traces are a function of the
    *gathered* full-width spike vector, so every rank computes the identical
    trace array. Telemetry and the knee's bit replicate (local partials are
    combined once per scan by :func:`combine_telemetry`)."""
    plast = None
    if carry.plast is not None:
        plast = PlasticityState(x_pre=None, x_post=_vec(rules, carry.plast.x_post),
                                elig=_mat(rules))
    return TickCarry(state=state_specs(rules, carry.state), plast=plast,
                     w=None if carry.w is None else _mat(rules), telem=None, policy=None)


def neighbors_specs(rules, neighbors: EventFanIn) -> EventFanIn:
    """Fan-in lists slice by destination ROW (``idx`` entries stay global
    presynaptic ids: rows of the local ``wc`` slab are the full presynaptic
    axis, so no index translation)."""
    spec = _spec(rules, ("neurons_post", None))
    return EventFanIn(idx=spec, mask=spec)


def _map(fn, tree, specs):
    """``fn(leaf, spec)`` over every tensor of ``tree`` (records, None)."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return fn(tree, specs)
    if isinstance(tree, TickTelemetry):
        if tree.buf is not None:
            return TickTelemetry.of_buffer(fn(tree.buf, None))
        return TickTelemetry(**{f: fn(getattr(tree, f), None)
                                for f in ("ticks", "spikes", "v_sum", "v_max", "ref_sum",
                                          "overflow", "policy_dense", "dw_l1", "dw_sq")})
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: _map(fn, getattr(tree, f.name),
                         None if specs is None else getattr(specs, f.name))
            for f in dataclasses.fields(tree) if f.init and f.compare})
    return tree


def place(tree, specs, mesh):
    """This rank's slice of a global tree, on the mesh's device.

    Cut leaves come back contiguous, replicated leaves on the device; a leaf
    that is already all of that is shared, not copied (the engine never
    writes its operands). Raises when a cut axis does not split evenly over
    the mesh.
    """
    def cut(x: torch.Tensor, spec: Spec) -> torch.Tensor:
        if spec is None:
            return x.to(mesh.device)
        lo, hi = mesh.columns(x.shape[spec])
        return x.narrow(spec, lo, hi - lo).to(mesh.device).contiguous()

    return _map(cut, tree, specs)


def collect(tree, specs, mesh):
    """The global tree from every rank's slice (one all-gather per cut leaf,
    so every rank must call it); replicated leaves come back as they are."""
    def gather(x: torch.Tensor, spec: Spec) -> torch.Tensor:
        if spec is None:
            return x
        return mesh.all_gather(x.movedim(spec, -1)).movedim(-1, spec)

    return _map(gather, tree, specs)


def combine_telemetry(telem_in: TickTelemetry, telem_out: TickTelemetry,
                      mesh) -> TickTelemetry:
    """Fold every rank's telemetry partials into fabric-wide totals (once per
    SCAN, not per tick).

    Only the DELTA this scan accumulated is combined: the incoming
    accumulator ``telem_in`` is replicated (the zero seed or the combined
    output of the previous chunk), so summing ``telem_out`` wholesale would
    re-sum prior chunks' totals D-fold every chunk. Sums (spikes, dw norms)
    sum their delta; the mean-based accumulators also divide by D, because
    each rank normalised by its local ``n/D``; ``v_max`` is a plain max.
    ``ticks`` / ``overflow`` / ``policy_dense`` come from replicated inputs
    (the tick counter, the gathered spikes) and agree on every rank. One
    ``all_reduce`` carries the five sums, one more the max.
    """
    o, i = telem_out, telem_in
    sums = mesh.all_reduce(torch.stack([o.spikes - i.spikes, o.v_sum - i.v_sum,
                                        o.ref_sum - i.ref_sum, o.dw_l1 - i.dw_l1,
                                        o.dw_sq - i.dw_sq]), "sum")
    v_max = mesh.all_reduce(o.v_max, "max")
    # Divide by a tensor: CUDA division by a Python number multiplies by its
    # reciprocal.
    d = torch.full((), float(mesh.size), dtype=torch.float32, device=o.spikes.device)
    out = TickTelemetry.zeros(tuple(o.ticks.shape), device=o.ticks.device)
    for f, val in (("ticks", o.ticks), ("spikes", i.spikes + sums[0]),
                   ("v_sum", i.v_sum + sums[1] / d), ("v_max", v_max),
                   ("ref_sum", i.ref_sum + sums[2] / d), ("overflow", o.overflow),
                   ("policy_dense", o.policy_dense), ("dw_l1", i.dw_l1 + sums[3]),
                   ("dw_sq", i.dw_sq + sums[4])):
        getattr(out, f).copy_(val)
    return out


def make_sharded_dyadic_weights(
    n: int,
    mesh=None,
    *,
    seed: int = 0,
    n_blocks: int = 8,
    levels: int = 8,
    device=None,
) -> torch.Tensor:
    """Dyadic-grid weights built rank-local (the 64k-safe path).

    Weights are ``uint8 levels x 2^round(log2(2/sqrt(n)))``, the grid on
    which every f32 reduction order is exact (the bitwise-parity substrate).
    Generation is seeded per COLUMN BLOCK (``n_blocks`` fixed blocks of
    ``np.random.default_rng((seed, b))``, independent of the mesh), so the
    same ``(n, seed)`` yields the reference's global matrix on any mesh.
    With ``mesh`` given, only this rank's ``(n, n/D)`` columns are built,
    block by block: the u8 levels go to the device and become f32 there, so
    the full ``(n, n)`` matrix (16 GiB at 64k) never exists on one host.
    ``device`` (without ``mesh``; None is the card) places the full matrix.
    """
    if n % n_blocks:
        raise ValueError(f"n={n} must divide into {n_blocks} gen blocks")
    scale = 2.0 ** round(math.log2(2.0 / math.sqrt(n)))
    bw = n // n_blocks
    if mesh is None:
        lo, hi, dev = 0, n, _device.resolve(device)
    else:
        (lo, hi), dev = mesh.columns(n), mesh.device
    out = torch.empty((n, hi - lo), dtype=torch.float32, device=dev)
    blocks = [b for b in range(n_blocks) if b * bw < hi and (b + 1) * bw > lo]

    def levels_of(b: int) -> np.ndarray:
        # numpy fills a block without the GIL: the blocks draw in parallel.
        return np.random.default_rng((seed, b)).integers(0, levels, size=(n, bw),
                                                         dtype=np.uint8)

    with ThreadPoolExecutor(max(1, min(len(blocks), os.cpu_count() or 1))) as pool:
        for b, u8 in zip(blocks, pool.map(levels_of, blocks)):
            a, z = max(lo, b * bw), min(hi, (b + 1) * bw)
            part = torch.from_numpy(np.ascontiguousarray(u8[:, a - b * bw:z - b * bw]))
            dst = out[:, a - lo:z - lo]
            dst.copy_(part.to(dev))     # u8 -> f32 in place: no f32 temporary
            dst.mul_(scale)
    return out


def sharded_scan(
    engine: TickEngine,
    params: SNNParams,
    carry0: TickCarry,
    ext_seq: Optional[torch.Tensor],
    n_ticks: int,
    *,
    rewards: Optional[torch.Tensor] = None,
    delays: Optional[torch.Tensor] = None,
    plastic_c: Optional[torch.Tensor] = None,
    learn_until=None,
    neighbors: Optional[EventFanIn] = None,
    wc: Optional[torch.Tensor] = None,
    w_edges: Optional[torch.Tensor] = None,
    owned: bool = False,
) -> Tuple[TickCarry, torch.Tensor]:
    """Run :meth:`TickEngine.scan` on this rank's shard of ``engine``'s mesh.

    The operands are this rank's (:func:`place`); ``ext_seq`` and
    ``rewards`` are replicated. The inner engine is the same options with
    ``mesh=None``, given the mesh as its ``gather``: its tick body
    all-gathers the arriving spikes and otherwise runs unchanged on
    ``(n, n/D)`` operands, so all four backends, plasticity, telemetry and
    the chunk contract compose exactly as on one device. A one-rank mesh
    runs the PLAIN engine (no gather, no ``pallas_fused`` remap), so "sharded
    at D=1" is the single-device run bit for bit, megakernel included. With
    telemetry, the scan's local partials are combined over the mesh once at
    the end (:func:`combine_telemetry`; skipped at D=1).
    """
    mesh = engine.options.mesh
    if mesh is None:
        raise ValueError("sharded_scan needs EngineOptions.mesh set")
    axis = engine.options.resolved_shard_axis()
    n_dev = mesh.size
    n = params.w.shape[-2]
    if n % n_dev:
        raise ValueError(
            f"n={n} neurons do not split evenly over mesh axis {axis!r} of size "
            f"{n_dev} (pad the fabric or resize the mesh)")
    n_local = carry0.state.lif.v.shape[-1]
    if n_local * n_dev != n or params.w.shape[-1] != n_local:
        raise ValueError(
            f"the operands are not one rank's shard: w {tuple(params.w.shape)}, "
            f"{n_local} local neurons, n={n} over {n_dev} ranks (cut the global "
            "tree with snn_sharding.place)")
    if delays is not None:
        raise ValueError(
            "per-synapse delay matrices don't compose with the sharded arm "
            "(the delay-plane product needs full-width spike history); use "
            "uniform rings (max_delay) or run single-device")
    learning = carry0.w is not None
    if learning and carry0.state.delay_buf.shape[-2] != 1:
        raise ValueError(
            "sharded learning requires max_delay == 1 (pair STDP reads the "
            "previous tick's spikes as the presynaptic events)")
    inner = TickEngine(dataclasses.replace(engine.options, mesh=None, shard_axis=None),
                       gather=mesh if n_dev > 1 else None)
    telem_in = None
    if engine.options.telemetry and n_dev > 1:
        # The replicated accumulator going in (the inner scan may update an
        # owned one in its buffer).
        telem_in = (carry0.telem.clone() if carry0.telem is not None else
                    TickTelemetry.zeros(tuple(carry0.state.lif.v.shape[:-1]),
                                        device=carry0.state.lif.v.device))
    carry, raster = inner.scan(params, carry0, ext_seq, n_ticks, rewards=rewards,
                               plastic_c=plastic_c, learn_until=learn_until,
                               neighbors=neighbors, wc=wc, w_edges=w_edges, owned=owned)
    if telem_in is not None:
        carry = dataclasses.replace(carry,
                                    telem=combine_telemetry(telem_in, carry.telem, mesh))
    return carry, raster

