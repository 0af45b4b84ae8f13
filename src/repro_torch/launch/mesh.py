"""Starting worlds of ranks, the production mesh and its sharding rules.

The role that ``repro.util.env.ensure_host_device_count`` plays for the
reference's ``repro.launch.mesh.make_snn_mesh``: the reference simulates D
devices in one process, the port starts D processes, one rank per shard
(DESIGN.md §15). The mesh itself, with its collectives, is
:mod:`repro_torch.parallel.mesh`; its :func:`make_snn_mesh` and
:class:`SNNMesh` are re-exported here under the reference's module name.

* :func:`init_world` joins the world a launcher started this process in
  (``torchrun`` sets ``RANK`` / ``WORLD_SIZE`` / ``MASTER_ADDR``); a lone
  process stays a world of one.
* :func:`run_world` starts a world of D ranks itself (``spawn``, a
  ``file://`` rendezvous in a temporary directory) and runs a function,
  given by importable name, on each rank; the tests and ``chip_smoke.py``
  start their worlds with it.

The LM stack's meshes are ``torch.distributed.device_mesh.DeviceMesh``es
with named dims over the world this process is in (the reference's
``jax.make_mesh`` over its devices): :func:`make_mesh` builds any shape,
:func:`make_production_mesh` the reference's (16, 16) ``("data", "model")``
or (2, 16, 16) ``("pod", "data", "model")`` mesh, and :func:`make_rules`
assembles the logical-axis rules of one (arch, shape) cell on a mesh. A
world of 256 or 512 ranks can be faked in one process for what needs no
data (``torch.testing._internal.distributed.fake_pg.FakeStore`` with the
``"fake"`` backend): the meshes and their placements build there.
"""
from __future__ import annotations

import importlib
import math
import os
import tempfile
import time
from typing import Any, List, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch import device as _device
from repro_torch.configs.base import ModelConfig, ParallelConfig, ShapeConfig
from repro_torch.parallel.mesh import AXIS, SNNMesh, make_snn_mesh
from repro_torch.parallel.sharding import (
    AxisRules, BASE_RULES, all_to_all_on_cpu, fsdp_overrides, multipod_overrides,
)

__all__ = ["AXIS", "SNNMesh", "default_backend", "init_world", "make_mesh",
           "make_production_mesh", "make_rules", "make_snn_mesh", "run_world", "to_host"]


def default_backend(device: torch.device, size: int) -> str:
    """NCCL when every rank can have a card of its own, else gloo."""
    if device.type == "cuda" and size <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def init_world(device=None) -> int:
    """Join the world a launcher started this process in, once; return its
    size. Under ``torchrun`` (``WORLD_SIZE`` and ``MASTER_ADDR`` set) the
    process group comes up from the environment, on NCCL when each rank has
    a card; otherwise the process is a world of one and nothing starts."""
    if dist.is_initialized():
        return dist.get_world_size()
    size = int(os.environ.get("WORLD_SIZE", "1"))
    if size > 1 or "MASTER_ADDR" in os.environ:
        dev = _device.resolve(device)
        dist.init_process_group(default_backend(dev, size), init_method="env://")
        return dist.get_world_size()
    return 1


def to_host(obj):
    """``obj`` with every tensor inside dicts, lists and tuples moved to the CPU."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: to_host(v) for k, v in obj.items()}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):   # a NamedTuple
        return type(obj)(*(to_host(v) for v in obj))
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_host(v) for v in obj)
    return obj


def _rank_main(rank: int, size: int, tmp: str, target: str, args: tuple, device: str,
               backend: str, threads: Optional[int]) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(size), LOCAL_RANK=str(rank))
    if threads:
        torch.set_num_threads(threads)
    dist.init_process_group(backend, init_method=f"file://{os.path.join(tmp, 'rendezvous')}",
                            rank=rank, world_size=size)
    try:
        mesh = make_snn_mesh(size, device=device)
        module, name = target.split(":")
        result = getattr(importlib.import_module(module), name)(mesh, *args)
        torch.save(to_host(result), os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_world(target: str, size: int, *args, device=None, backend: Optional[str] = None,
              threads: Optional[int] = None, timeout: float = 900.0) -> List[Any]:
    """Start a world of ``size`` ranks and run ``target(mesh, *args)`` on each.

    ``target`` is ``"module:function"``, importable in a fresh interpreter
    (the ranks are spawned, not forked); ``args`` must pickle. Returns each
    rank's result in rank order, tensors moved to the CPU. A rank that
    raises fails the call with its traceback, and the other ranks are
    stopped; so are all of them when ``timeout`` seconds pass. ``device=None``
    is the card; ``backend=None`` picks :func:`default_backend`;
    ``threads`` sets each rank's intra-op threads.
    """
    dev = _device.resolve(device)
    backend = backend or default_backend(dev, size)
    with tempfile.TemporaryDirectory(prefix="snn_world_") as tmp:
        ctx = torch.multiprocessing.start_processes(
            _rank_main, args=(size, tmp, target, args, str(dev), backend, threads),
            nprocs=size, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=0.5):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{target} on a world of {size} ranks did not end "
                                       f"within {timeout:.0f} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                for r in range(size)]


def make_mesh(shape: Tuple[int, ...], axis_names: Tuple[str, ...], *, device=None):
    """A ``DeviceMesh`` of ``shape`` with dims named ``axis_names`` over the
    current world, ranks in row-major order (rank ``r`` at the coordinate of
    ``r`` in ``numpy.unravel_index(r, shape)``), on ``device``'s type (None:
    the card). The world must have exactly ``prod(shape)`` ranks. A process
    in no world is a world of one: a group of that one rank is started for it
    (NCCL on a card, gloo on the CPU). On the CPU, DTensor moves a split
    between tensor dims by an all-to-all
    (:func:`repro_torch.parallel.sharding.all_to_all_on_cpu`)."""
    from torch.distributed.device_mesh import init_device_mesh

    shape, axis_names = tuple(int(s) for s in shape), tuple(axis_names)
    if len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {shape} and axis names {axis_names} differ in rank")
    need = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 1
    if need != have:
        raise ValueError(f"a {shape} {axis_names} mesh needs {need} ranks; "
                         f"this world has {have}")
    dev = _device.resolve(device)
    if not dist.is_initialized():
        dist.init_process_group(default_backend(dev, 1), store=dist.HashStore(),
                                rank=0, world_size=1)
    if dev.type == "cpu":
        all_to_all_on_cpu()
    return init_device_mesh(dev.type, shape, mesh_dim_names=axis_names)


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """The reference's production mesh on the current world: (16, 16)
    ``("data", "model")``, or (2, 16, 16) ``("pod", "data", "model")`` with
    ``multi_pod``; it raises naming the 256 / 512 ranks and the world it saw
    when they differ."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device=device)


def make_rules(
    mesh,
    cfg: ModelConfig,
    shape: ShapeConfig,
    pcfg: ParallelConfig,
    *,
    multi_pod: bool = False,
) -> AxisRules:
    """BASE_RULES + multipod + fsdp + shape-driven + per-cell overrides."""
    rules = AxisRules(BASE_RULES, mesh=mesh)
    over = {}
    if multi_pod:
        over.update(multipod_overrides())
    if pcfg.fsdp:
        over.update(fsdp_overrides())
    if pcfg.seq_shard_activations and shape.kind == "train":
        over.update({"seq": "model"})
    if shape.kind in ("prefill", "decode"):
        # KV caches shard along their sequence axis over "model"
        # (flash-decoding).
        over["kv_seq"] = "model"
    if shape.global_batch == 1:
        # long_500k: nothing to shard on batch; shard the KV sequence over
        # every axis there is. The one-token query stays replicated.
        data_axes = ("pod", "data") if multi_pod else ("data",)
        over["batch"] = None
        over["seq"] = None
        over["kv_seq"] = tuple(data_axes) + ("model",)
    over.update(dict(pcfg.rule_overrides))
    return rules.with_overrides(over)
