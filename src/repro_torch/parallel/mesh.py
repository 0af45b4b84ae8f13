"""The mesh the SNN fabric shards over: a world of ``torch.distributed`` ranks.

Counterpart of ``repro.launch.mesh.make_snn_mesh``. The reference runs D
simulated devices in one process under ``shard_map``; the port runs D
processes, one rank per shard, in one SPMD world (DESIGN.md §15).
:func:`make_snn_mesh` returns the :class:`SNNMesh` of the world this process
runs in: its process group, rank, size and device, and the two collectives
the sharded engine uses (the tick's spike all-gather and the telemetry
all-reduce). A process that joined no world is a world of one rank.

NCCL serves ranks that each have a card of their own; gloo serves CPU worlds
and several ranks that share one card (NCCL refuses two ranks on one GPU).
gloo's collectives are run on host tensors: a rank on a card stages its
block through the host and back (:attr:`SNNMesh.exchange` says which path a
mesh takes). Starting a world is the launcher's: :mod:`repro_torch.launch.mesh`.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch import device as _device

AXIS = "model"


def _gather_single(out: torch.Tensor, x: torch.Tensor, group) -> None:
    """``out`` (D * x.numel(),) = every rank's flat ``x`` in rank order."""
    fn = getattr(dist, "all_gather_single", None)
    if fn is None:   # before torch 2.13
        fn = dist.all_gather_into_tensor
    fn(out, x, group=group)


@dataclasses.dataclass(frozen=True)
class SNNMesh:
    """A 1-D mesh of ``size`` ranks over the ``axis`` the fabric shards on.

    Two meshes of one world compare and hash equal (on rank, size, device,
    backend and axis; the process-group handle is left out of both), so
    :class:`~repro_torch.core.engine.EngineOptions` carrying one stays
    hash-stable across independent builds.

    Attributes:
      rank: this process's rank; it owns postsynaptic columns
        ``[rank*n/size, (rank+1)*n/size)`` (:meth:`columns`).
      size: the world's size, D.
      device: where this rank's shard lives.
      backend: ``"nccl"``, ``"gloo"``, or None for a world of one that no
        process group backs.
      group: the process group (None for a world of one).
      axis: the mesh axis name (the reference's ``"model"``).
    """

    rank: int
    size: int
    device: torch.device
    backend: Optional[str] = None
    group: Any = dataclasses.field(default=None, compare=False)
    axis: str = AXIS

    @property
    def axis_names(self) -> Tuple[str]:
        return (self.axis,)

    @property
    def staged(self) -> bool:
        """True when collectives go through the host: gloo on a card."""
        return self.backend == "gloo" and self.device.type == "cuda"

    @property
    def exchange(self) -> str:
        """How the tick's spike exchange travels, for logs."""
        if self.size == 1:
            return "none (one rank)"
        if self.staged:
            return "gloo, staged through the host"
        return f"{self.backend} on {self.device.type} tensors"

    def columns(self, n: int) -> Tuple[int, int]:
        """This rank's ``[lo, hi)`` of ``n`` postsynaptic columns."""
        if n % self.size:
            raise ValueError(f"n={n} neurons do not split evenly over mesh axis "
                             f"{self.axis!r} of size {self.size} (pad the fabric or "
                             "resize the mesh)")
        w = n // self.size
        return self.rank * w, (self.rank + 1) * w

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` concatenated along the last axis in rank order:
        ``(..., m)`` -> ``(..., size * m)``, the global column layout."""
        if self.size == 1:
            return x
        src = (x.detach().to("cpu") if self.staged else x.contiguous()).reshape(-1)
        out = torch.empty(self.size * src.numel(), dtype=src.dtype, device=src.device)
        _gather_single(out, src, self.group)
        if self.staged:
            out = out.to(x.device)
        out = out.reshape((self.size,) + tuple(x.shape)).movedim(0, -2)
        return out.reshape(tuple(x.shape[:-1]) + (self.size * x.shape[-1],))

    def all_reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """``x`` reduced over the ranks (``"sum"`` or ``"max"``), as a new tensor."""
        if self.size == 1:
            return x.clone()
        red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
        buf = x.detach().to("cpu", copy=True) if self.staged else x.clone()
        dist.all_reduce(buf, red, group=self.group)
        return buf.to(x.device) if self.staged else buf


def make_snn_mesh(n_devices: Optional[int] = None, axis: str = AXIS, *,
                  device=None) -> SNNMesh:
    """The 1-D mesh over the running world (``n_devices=None``: all of it).

    Raises ``ValueError`` when the world's size is not ``n_devices``: the
    port serves on the ranks it was started with and never simulates more.
    ``device=None`` is the card (with NCCL, the rank's ``LOCAL_RANK``-th;
    with gloo, the current one); ``"cpu"`` keeps the shard on the host.
    """
    if dist.is_available() and dist.is_initialized():
        size, rank = dist.get_world_size(), dist.get_rank()
        backend, group = dist.get_backend(), dist.group.WORLD
    else:
        size, rank, backend, group = 1, 0, None, None
    if n_devices is None:
        n_devices = size
    if n_devices != size:
        raise ValueError(
            f"n_devices={n_devices} but this world has {size} rank(s): start "
            f"{n_devices} ranks (torchrun --nproc-per-node {n_devices}, or "
            "repro_torch.launch.mesh.run_world)")
    dev = _device.resolve(device)
    if dev.type == "cuda":
        if dev.index is None:
            index = (int(os.environ.get("LOCAL_RANK", rank)) % torch.cuda.device_count()
                     if backend == "nccl" else torch.cuda.current_device())
            dev = torch.device("cuda", index)
        torch.cuda.set_device(dev)
    return SNNMesh(rank=rank, size=size, device=dev, backend=backend, group=group,
                   axis=axis)
