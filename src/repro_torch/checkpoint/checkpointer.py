"""Checkpointing: atomic, rotated, resumable.

Counterpart of ``repro.checkpoint.checkpointer``, with its protocol and its
files. Layout: ``<dir>/step_<N>/`` holds one ``.npy`` per tree leaf, named
by the leaf's path with the reference's keys (``params/stages/0/layer0/
mixer/wq``, ``opt/m/...``, ``opt/step``; ``/`` becomes ``__`` in the file
name), plus ``META.json`` (the step, the manifest of every leaf's file,
shape and dtype, and the caller's extra metadata such as the pipeline
state). Writes go to ``step_<N>.tmp``, ``META.json`` is fsynced, and only
then is the directory renamed, so a crash mid-write never corrupts the
newest complete step; the last ``keep`` steps are kept.

The files are the reference's byte for byte: a float32 or int32 leaf is
``np.save``'s, and a bfloat16 leaf is written as the reference's
``ml_dtypes`` array is, its 2-byte words under the ``'<V2'`` descriptor with
``"dtype": "bfloat16"`` in the manifest (the port does not import
``ml_dtypes``). ``restore`` reads each leaf back by its manifest dtype onto
the device and dtype of ``tree_like``'s leaf; the reference's own restore
hands JAX a ``|V2`` array for a bf16 leaf, which it refuses (ROADMAP,
faults of the reference).

On a mesh: a DTensor leaf is saved whole (``full_tensor()``, a collective
every rank of the mesh takes part in), so its files are byte for byte those
of the same values saved unsharded, and the world's rank 0 alone writes
them (the ranks share the directory). ``restore(shardings=)`` is the elastic
reshard: every rank reads the whole leaf and keeps its own slice under the
new mesh's placements, whatever mesh wrote it.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.parallel.sharding import NamedSharding, gather, is_dtensor, place
from repro_torch.util import tree

META = "META.json"
BF16_DESCR = "<V2"   # numpy's descriptor of an ml_dtypes bfloat16 array


def _flatten_with_paths(tree_) -> List[Tuple[str, Any]]:
    return [("/".join(str(k) for k in path), leaf)
            for path, leaf in tree.flatten_with_paths(tree_)]


def _host(leaf) -> Tuple[np.ndarray, str]:
    """The leaf as a host array and its dtype name; a bf16 tensor as its
    2-byte words."""
    if isinstance(leaf, torch.Tensor):
        t = gather(leaf).detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.contiguous().view(torch.int16).numpy(), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _write_npy(path: str, arr: np.ndarray, dtype: str) -> None:
    if dtype != "bfloat16":
        np.save(path, arr)
        return
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": BF16_DESCR, "fortran_order": False, "shape": arr.shape})
        f.write(np.ascontiguousarray(arr).astype("<i2", copy=False).tobytes())


def _read_npy(path: str, dtype: str) -> torch.Tensor:
    arr = np.load(path)
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view("<i2").copy()).view(torch.bfloat16)
    return torch.from_numpy(arr)


def save(
    directory: str,
    step: int,
    tree_: Any,
    *,
    extra_meta: Optional[Dict] = None,
    keep: int = 3,
) -> str:
    """Atomic checkpoint write; returns the final path. With DTensor leaves
    every rank must call it; rank 0 writes and the others wait for it."""
    final = os.path.join(directory, f"step_{step:08d}")
    sharded = any(is_dtensor(leaf) for leaf in tree.leaves(tree_))
    leaves = [(key, gather(leaf)) for key, leaf in _flatten_with_paths(tree_)]
    if not sharded or _writer():
        _write(directory, final, step, leaves, extra_meta, keep)
    if sharded:
        _barrier()
    return final


def _writer() -> bool:
    """Whether this process writes a mesh's checkpoints: rank 0 of its
    world, or a process in none."""
    import torch.distributed as dist
    return not dist.is_initialized() or dist.get_rank() == 0


def _barrier() -> None:
    import torch.distributed as dist
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


def _write(directory: str, final: str, step: int, leaves, extra_meta, keep: int) -> None:
    os.makedirs(directory, exist_ok=True)
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {}
    for key, leaf in leaves:
        arr, dtype = _host(leaf)
        fname = key.replace("/", "__") + ".npy"
        _write_npy(os.path.join(tmp, fname), arr, dtype)
        manifest[key] = {"file": fname, "shape": list(arr.shape), "dtype": dtype}
    meta = {"step": step, "manifest": manifest}
    if extra_meta:
        meta["extra"] = extra_meta
    with open(os.path.join(tmp, META), "w") as f:
        json.dump(meta, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _rotate(directory, keep)


def _rotate(directory: str, keep: int) -> None:
    steps = sorted(all_steps(directory))
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(directory, f"step_{s:08d}"), ignore_errors=True)


def all_steps(directory: str) -> List[int]:
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        m = re.fullmatch(r"step_(\d+)", name)
        if m and os.path.exists(os.path.join(directory, name, META)):
            out.append(int(m.group(1)))
    return sorted(out)


def latest_step(directory: str) -> Optional[int]:
    steps = all_steps(directory)
    return steps[-1] if steps else None


def restore(directory: str, tree_like: Any, step: Optional[int] = None,
            *, shardings: Any = None) -> Tuple[Any, Dict]:
    """Restore into the structure of ``tree_like`` (a tree of tensors);
    returns (tree, meta). Each leaf is read by the manifest's dtype and cast
    to the dtype of ``tree_like``'s leaf. ``shardings``: optional matching
    tree of :class:`~repro_torch.parallel.sharding.NamedSharding`s -- the
    elastic reshard path: a leaf with a sharding is laid over that mesh as a
    DTensor, each rank keeping its slice; a leaf without one (no
    ``shardings``, or a ``None`` entry) goes to the device of ``tree_like``'s
    leaf."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, META)) as f:
        meta = json.load(f)
    by_path = dict(tree.flatten_with_paths(shardings)) if shardings is not None else {}
    out = []
    for leaf_path, like in tree.flatten_with_paths(tree_like):
        key = "/".join(str(k) for k in leaf_path)
        entry = meta["manifest"].get(key)
        if entry is None:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        t = _read_npy(os.path.join(path, entry["file"]), entry["dtype"])
        if tuple(t.shape) != tuple(like.shape):
            raise ValueError(f"leaf {key!r}: checkpoint shape {tuple(t.shape)}, "
                             f"tree_like's {tuple(like.shape)}")
        sharding = by_path.get(leaf_path)
        if sharding is not None and not isinstance(sharding, NamedSharding):
            raise TypeError(f"leaf {key!r}: shardings holds a {type(sharding).__name__}, "
                            f"not a NamedSharding")
        if sharding is not None:
            out.append(place(t.to(like.dtype), sharding))
        else:
            out.append(t.to(device=like.device, dtype=like.dtype))
    return tree.unflatten(tree_like, out), meta


class AsyncCheckpointer:
    """Off-step-path checkpoint writes (one background thread, depth-1 queue).

    ``save_async`` copies the tree to the host before it returns (a DTensor
    leaf gathered whole, on every rank), so the caller may go on updating its
    tensors; a write's error is raised by the next ``save_async`` or
    ``wait``. On a mesh rank 0 writes, and ``wait`` holds every rank until
    the write is done."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._sharded = False
        self.last_error: Optional[BaseException] = None

    def save_async(self, step: int, tree_: Any, extra_meta=None) -> None:
        self.wait()
        self._sharded = any(is_dtensor(leaf) for leaf in tree.leaves(tree_))
        host_tree = tree.map(lambda x: gather(x).detach().to("cpu", copy=True)
                             if isinstance(x, torch.Tensor) else np.array(x), tree_)

        write = not self._sharded or _writer()

        def work():
            try:
                if write:
                    save(self.directory, step, host_tree,
                         extra_meta=extra_meta, keep=self.keep)
            except BaseException as e:  # noqa: BLE001 -- surfaced on the next wait()
                self.last_error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
            if self._sharded:
                _barrier()
        if self.last_error is not None:
            err, self.last_error = self.last_error, None
            raise err
