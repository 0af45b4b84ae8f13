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
faults of the reference). Restoring onto another mesh (``shardings=``)
waits for the fleet scaffold (ROADMAP A.7d).
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
        t = leaf.detach().cpu()
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
    """Atomic checkpoint write; returns the final path."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {}
    for key, leaf in _flatten_with_paths(tree_):
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
    return final


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
    returns (tree, meta). Each leaf is read by the manifest's dtype and
    placed on the device, and cast to the dtype, of ``tree_like``'s leaf."""
    if shardings is not None:
        raise NotImplementedError(
            "restore(shardings=...): restoring onto a mesh waits for the fleet scaffold "
            "(ROADMAP A.7d); the port restores onto tree_like's devices")
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, META)) as f:
        meta = json.load(f)
    out = []
    for key, like in _flatten_with_paths(tree_like):
        entry = meta["manifest"].get(key)
        if entry is None:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        t = _read_npy(os.path.join(path, entry["file"]), entry["dtype"])
        if tuple(t.shape) != tuple(like.shape):
            raise ValueError(f"leaf {key!r}: checkpoint shape {tuple(t.shape)}, "
                             f"tree_like's {tuple(like.shape)}")
        out.append(t.to(device=like.device, dtype=like.dtype))
    return tree.unflatten(tree_like, out), meta


class AsyncCheckpointer:
    """Off-step-path checkpoint writes (one background thread, depth-1 queue).

    ``save_async`` copies the tree to the host before it returns, so the
    caller may go on updating its tensors; a write's error is raised by the
    next ``save_async`` or ``wait``."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self.last_error: Optional[BaseException] = None

    def save_async(self, step: int, tree_: Any, extra_meta=None) -> None:
        self.wait()
        host_tree = tree.map(lambda x: x.detach().to("cpu", copy=True)
                             if isinstance(x, torch.Tensor) else np.array(x), tree_)

        def work():
            try:
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
        if self.last_error is not None:
            err, self.last_error = self.last_error, None
            raise err
