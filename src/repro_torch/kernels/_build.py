"""Build the hand-written Hopper kernels at first use and bind them with ctypes.

The sources under ``repro_torch/csrc/`` are compiled with ``nvcc`` for
``sm_90a`` into one shared library with a plain C interface, cached under
``build/repro_torch_kernels/<hash of sources and flags>/`` at the root of
the checkout. Each ``.cu`` file compiles in its own ``nvcc`` process, all
started together, and the objects are linked into the library. Nothing here
runs at import time: the CPU tests import every module without a compiler.

``--fmad=false`` keeps the multiply-adds of the LIF epilogue and the STDP
update rounding as the plain PyTorch twins' separate elementwise ops do.
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("lif_step.cu", "tick_fused.cu", "stdp_update.cu", "event_dispatch.cu",
           "spike_matmul.cu", "telemetry.cu")
HEADERS = ("lif_epilogue.cuh", "masked_product.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-Xcompiler", "-fPIC", "-Xptxas=-v")
LIB_NAME = "librepro_torch_kernels.so"

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# B1's and B2's launch plan (kernels/_plan.py Plan.args): bb, kt, stages, ks,
# k_chunk, smem.
_PLAN = (_I,) * 6
# B4's launch plan (kernels/_event_plan.py EventPlan.args): rows, chunk,
# window, stage_rows, vec (the fill), smem.
_GATHER = (_I,) * 6
# argtypes of each C entry, in the order of its signature in csrc/.
SIGNATURES = {
    "repro_lif_step": (
        _P, _L, _P, _L, _P, _L,          # s, w, c (+ slot strides)
        _P, _P, _P,                      # v, r, drive
        _P, _P, _P, _P, _P, _P, _L,      # six rows + row slot stride
        _P, _P, _P, _P, _L,              # v_out, r_out, y_out, run_if (+ slot stride)
        _I, _I, _I, _I, _I,              # S, B, K, N, mode
        *_PLAN, _P),                     # the launch plan, stream
    "repro_tick_fused": (
        _P,                              # slots
        _P, _L, _L, _I,                  # read, read_slot, read_row, n_read
        _P, _L, _P, _L, _P, _L,          # w, c, delays (+ slot strides)
        _P, _P, _P,                      # v, r, drive
        _P, _P, _P, _P, _P, _P, _L,      # six rows + row slot stride
        _P, _P, _P,                      # v_out, r_out, y_out
        _P, _P, _L, _I,                  # ring_in, ring_out, ring_slot, n_ring
        _I, _I, _I, _I, _I,              # S, B, K, N, mode
        *_PLAN, _P),                     # the launch plan, stream
    "repro_stdp_update": (
        _P, _P, _P, _P,                  # s_pre, x_pre, s_post, x_post
        _P, _L, _P, _L, _P, _L,          # w, c, elig (+ slot strides)
        _P, _L, _P, _P, _L,              # reward (+ stride), tick, learn_until (+ stride)
        _P, _P, _P,                      # x_pre_out, x_post_out, dw stats (or null)
        _I, _I, _I, _I, _I,              # S, B, K, N, rstdp
        _F, _F, _F, _F, _F, _F, _F, _F,  # a_plus .. w_max
        _I, _I, _I, _P),                 # the plan (blocks, stages, smem), stream
    "repro_event_dispatch": (
        _P, _P, _I,                      # idx, counts (null: walk all), k
        _P, _L, _I,                      # w, its slot stride, its rows
        _P, _P, _P,                      # v, r, drive
        _P, _P, _P, _P, _P, _P, _L,      # six rows + row slot stride
        _P, _P, _P, _P, _L,              # v_out, r_out, y_out, skip (+ slot stride)
        _I, _I, _I, _I,                  # S, B, N, mode
        *_GATHER, _P),                   # B4's launch plan, stream
    "repro_spike_matmul": (
        _P, _P, _P, _P, _P, _P,          # s, w, c, out, workspace, counters
        _I, _I, _I, _I, _I,              # B, K, N, s_bf16, w_bf16
        _I, _I, _I, _I, _P),             # the plan (kt, stages, blocks, smem), stream
    "repro_telemetry": (
        _P, _I, _P, _I, _P, _I, _I,      # y (+ int), v (+ int), r, rows, n
        _P, _I, _P, _I,                  # over, take_dense (+ rows per flag)
        _P, _I, _I,                      # dw partials, rows per group, partials
        _P, _P),                         # the accumulators' (9, rows) buffer, stream
}


@dataclasses.dataclass(frozen=True)
class Build:
    """Where the library is, how long it took to build (0 when cached), and
    the compiler's per-kernel register / shared-memory report."""

    path: Path
    seconds: float
    log: str


def repo_root() -> Path:
    return Path(__file__).resolve().parents[3]


def _digest() -> str:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the port's kernels for sm_90a")


def _compile(out: Path) -> str:
    """Compile every source in parallel, link, and move the library into place."""
    nvcc = _nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=out.parent))
    try:
        procs = []
        for name in SOURCES:
            obj = tmp / (name + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(CSRC / name), "-o", str(obj)]
            procs.append((name, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        logs = []
        for name, _, proc in procs:
            text, _ = proc.communicate()
            logs.append(f"== {name}\n{text}")
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {name}:\n{text}")
        lib = tmp / LIB_NAME
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(lib), *(str(o) for _, o, _ in procs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"linking {LIB_NAME} failed:\n{link.stdout}")
        os.replace(lib, out)  # atomic: a concurrent build sees all or nothing
        return "\n".join(logs)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


@functools.lru_cache(maxsize=None)
def build() -> Build:
    """Build the library once per process (reused across processes by hash)."""
    out = repo_root() / "build" / "repro_torch_kernels" / _digest() / LIB_NAME
    if out.exists():
        return Build(out, 0.0, "")
    t0 = time.perf_counter()
    log = _compile(out)
    return Build(out, time.perf_counter() - t0, log)


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded library with every entry's argtypes and restype declared."""
    lib = ctypes.CDLL(str(build().path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def sm_count(device) -> int:
    """The card's streaming multiprocessors (the launch planner's wave)."""
    import torch

    return torch.cuda.get_device_properties(device).multi_processor_count


_twin = threading.local()


@contextlib.contextmanager
def twin(name: str):
    """Mark the plain twin of kernel ``name`` running in its wrapper's CPU
    branch, so that an op recorder (:mod:`repro_torch.analysis.op_rules`)
    sees the call as one opaque kernel, as the card runs it, and not as the
    twin's elementwise ops. The card's branch never enters it."""
    outer = getattr(_twin, "name", None)
    _twin.name = outer or name
    try:
        yield
    finally:
        _twin.name = outer


def twin_running() -> "str | None":
    """The kernel whose plain twin this thread is running, or None."""
    return getattr(_twin, "name", None)


def check(name: str, err: int) -> None:
    """Raise if a launch returned a CUDA error (the launch did not run)."""
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with cudaError_t {err}")


def ptr(t) -> "int | None":
    """A tensor's device address for a ``c_void_p`` argument (None -> NULL)."""
    return None if t is None else t.data_ptr()


def expect(t, name: str, dtype, shape, device) -> None:
    """Raise unless ``t`` is a contiguous tensor of this dtype, shape and device."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name}: expected device {device}, got {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def expect_rows(rows, N: int, S: int, device) -> int:
    """Check the six per-neuron rows (``v_th, leak, r_ref, gain, i_bias,
    v_reset``; int32 ``r_ref``), all shared ``(N,)`` or all per slot
    ``(S, N)``; return their slot stride."""
    import torch

    if any(p.dim() != rows[0].dim() for p in rows):
        raise ValueError("the six per-neuron rows must all be shared or all per slot")
    names = ("v_th", "leak", "r_ref", "gain", "i_bias", "v_reset")
    strides = [expect_slotted(p, name, torch.int32 if name == "r_ref" else torch.float32,
                              (N,), S, device) for name, p in zip(names, rows)]
    return strides[0]


def expect_slotted(t, name: str, dtype, shape, S: int, device) -> int:
    """Check an operand that is either shared (``shape``) or per slot
    (``(S, *shape)``); return its slot stride in elements (0 when shared)."""
    if t.dim() == len(shape) + 1:
        expect(t, name, dtype, (S,) + tuple(shape), device)
        return t.stride(0)
    expect(t, name, dtype, shape, device)
    return 0


def outputs(out, v, r, slotted: bool):
    """The ``(v', r', y')`` buffers a tick kernel writes: fresh ones shaped
    like ``v`` (which already carries its slot axis), or the caller's ``out``
    checked against ``v`` and ``r`` and seen with a slot axis."""
    import torch

    if out is None:
        return torch.empty_like(v), torch.empty_like(r), torch.empty_like(v)
    lead = (lambda t: t) if slotted else (lambda t: t.unsqueeze(0))
    for name, t, like in zip(("v_out", "r_out", "y_out"), out, (v, r, v)):
        expect(lead(t), name, like.dtype, like.shape, like.device)
    return tuple(lead(t) for t in out)
