"""Starting the world of ranks that the SNN fabric shards over.

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
"""
from __future__ import annotations

import importlib
import os
import tempfile
import time
from typing import Any, List, Optional

import torch
import torch.distributed as dist

from repro_torch import device as _device
from repro_torch.parallel.mesh import AXIS, SNNMesh, make_snn_mesh

__all__ = ["AXIS", "SNNMesh", "default_backend", "init_world", "make_snn_mesh",
           "run_world", "to_host"]


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
