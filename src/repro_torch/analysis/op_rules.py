"""Rules on a recorded op trace: purity, dtype discipline, the hoist contract.

Counterpart of ``repro.analysis.jaxpr_rules`` and ``repro.analysis.hlo_rules``.
Eager PyTorch has no program to walk before it runs and no lowering step, so
the port records one: :class:`OpRecorder`, a ``TorchDispatchMode``, sees
every aten and c10d op a program dispatches while it runs at a small
operating point, with its operands' and results' shapes, dtypes and devices,
whether it ran inside :meth:`~repro_torch.core.engine.TickEngine.tick_body`
(the loop body, called once a tick: the counterpart of "inside a scan
body"), and the Python functions on the stack (the counterpart of the name
scope). The two HLO-text rules of the reference are folded in here under
their own names.

Kernel wrappers are opaque, as ``recurse_pallas=False`` makes Pallas calls:
on CPU tensors a wrapper runs its kernel's plain twin under
:func:`repro_torch.kernels._build.twin`, and every op of the twin is
recorded as inside that kernel and left to the kernel lint. The mesh's
collectives (:class:`~repro_torch.parallel.mesh.SNNMesh` ``all_gather`` and
``all_reduce``) are recorded as one collective each, whatever the world's
size (a world of one moves nothing but still marks the exchange).

Rules:

* ``purity.sync_in_loop`` -- an op that makes the host wait for the device
  (``.item()``/``bool(t)``, ``nonzero``, ``masked_select``, boolean
  indexing, ``unique``, ``repeat_interleave`` without ``output_size``, a
  copy to the CPU) inside the tick loop; ``purity.sync`` the same outside
  it, a WARNING (as ``io_callback`` outside the loop is in the reference).
* ``purity.host_custom_call`` -- an op of a namespace other than the
  framework's own (a custom op may call back into the host).
* ``dtype.x64`` -- an op that produces a float64, complex128 or uint64
  tensor; ``dtype.x64_lowered`` -- one that consumes such a tensor and hides
  it behind a narrower result. int64 is allowed (:data:`ALLOWED_64BIT`).
* ``dtype.u8_upcast`` -- a uint8 operand widened to a float result outside
  the sanctioned scopes (register decode, quantization, encoding).
* ``hoist.*`` -- the ``W*C`` premask contract, both ways, from the count of
  elementwise ``(n, n) * (n, n)`` multiplies in and out of the loop.
"""
from __future__ import annotations

import dataclasses
import re
import sys
import threading
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.analysis.findings import ERROR, WARNING, Finding
from repro_torch.kernels import _build

__all__ = [
    "OpRecord", "OpRecorder", "record", "check_hot_loop_purity", "check_dtype_discipline",
    "check_hoist", "square_muls", "SYNC_OPS", "ALLOWED_64BIT", "DEFAULT_UPCAST_ALLOWLIST",
    "HOIST_HOISTED", "HOIST_IN_LOOP", "HOIST_KERNEL", "HOIST_SKIP",
]

# Ops that make the host wait for the device on CUDA: a scalar read, and the
# ops whose result size depends on the data.
SYNC_OPS = frozenset({
    "aten._local_scalar_dense", "aten.item", "aten.nonzero", "aten.nonzero_static",
    "aten.masked_select", "aten._unique", "aten._unique2", "aten.unique_dim",
    "aten.unique_consecutive", "aten.equal", "aten.is_nonzero",
})
# Namespaces of ops that run on the device or only describe the trace.
FRAMEWORK_NAMESPACES = frozenset({"aten", "prims", "c10d", "_c10d_functional", "profiler"})
# 64-bit dtypes the port allows, with the reason: int64 is PyTorch's index
# type (topk, argmax, sum of a bool mask, index_select), and the port's
# decoders return int64 ids (a deliberate difference from the reference,
# which forbids every 64-bit type).
ALLOWED_64BIT = ("int64",)
FORBIDDEN_64BIT = ("float64", "complex128", "uint64")
# Scopes (module or function names on the stack) where a uint8 -> float widen
# is sanctioned: the register-decode / quantization boundaries.
DEFAULT_UPCAST_ALLOWLIST: Tuple[str, ...] = (r"decode_u8", r"quant", r"registers", r"encode")

HOIST_HOISTED = "hoisted"    # frozen weights: W*C formed once, outside the loop
HOIST_IN_LOOP = "in_loop"    # learning: the weights change every tick, W*C in the loop
HOIST_KERNEL = "kernel"      # W*C formed inside a kernel; only no dense W*C may leak
HOIST_SKIP = "skip"          # the rule does not apply

_MULS = ("aten.mul.Tensor", "aten.mul.out", "aten.mul_.Tensor")


@dataclasses.dataclass(frozen=True)
class OpRecord:
    """One op a program dispatched.

    ``inside`` names the opaque call it ran in (a kernel's twin, or a mesh
    collective), None at the program's own level; ``collective`` marks a
    cross-rank exchange (a mesh collective, or a c10d op outside one)."""

    name: str
    in_shapes: Tuple[Tuple[int, ...], ...]
    in_dtypes: Tuple[str, ...]
    in_devices: Tuple[str, ...]
    out_shapes: Tuple[Tuple[int, ...], ...]
    out_dtypes: Tuple[str, ...]
    out_devices: Tuple[str, ...]
    in_loop: bool
    scope: str
    inside: Optional[str] = None
    collective: bool = False
    kwargs: Tuple[str, ...] = ()
    index_dtypes: Tuple[str, ...] = ()

    @property
    def namespace(self) -> str:
        return self.name.split(".", 1)[0]

    @property
    def numel(self) -> int:
        """The largest tensor the op produced (for a c10d op, that it touched)."""
        shapes = self.out_shapes + (self.in_shapes if self.namespace == "c10d" else ())
        best = 0
        for s in shapes:
            n = 1
            for d in s:
                n *= int(d)
            best = max(best, n)
        return best


def _tensors(x, out: list) -> list:
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _tensors(v, out)
    return out


def _dt(t: torch.Tensor) -> str:
    return str(t.dtype).replace("torch.", "")


_state = threading.local()


def tick_loop_code() -> tuple:
    """The loop body's code: :meth:`TickEngine.tick_body`, called once a tick."""
    from repro_torch.core.engine import TickEngine

    return (TickEngine.tick_body.__code__,)


def _context(loop_codes: tuple, skip: int = 2) -> Tuple[bool, str]:
    """``(inside a loop body, the scope)``: the functions on the stack,
    outermost first, as ``module.function``, leaving out PyTorch's own and
    this module's frames."""
    frame = sys._getframe(skip)
    loop, names = False, []
    while frame is not None:
        if frame.f_code in loop_codes:
            loop = True
        mod = frame.f_globals.get("__name__", "")
        if not (mod == "torch" or mod.startswith("torch.") or mod in (__name__, "contextlib")):
            names.append(f"{mod}.{frame.f_code.co_name}")
        frame = frame.f_back
    return loop, "/".join(reversed(names))


class OpRecorder(TorchDispatchMode):
    """Record every op dispatched while active (see the module docstring).

    Use as a context manager; ``records`` holds the :class:`OpRecord` list.
    ``loop_codes``: the code objects of the loop bodies (default the tick
    body). While active, the mesh's ``all_gather`` and ``all_reduce`` are
    wrapped to record themselves as one collective each."""

    def __init__(self, loop_codes: Optional[tuple] = None):
        super().__init__()
        self.records: List[OpRecord] = []
        self.loop_codes = tuple(loop_codes) if loop_codes else tick_loop_code()
        self._saved = None

    def __enter__(self):
        from repro_torch.parallel.mesh import SNNMesh

        self._saved = (SNNMesh.all_gather, SNNMesh.all_reduce)
        SNNMesh.all_gather = self._collective("mesh.all_gather", self._saved[0])
        SNNMesh.all_reduce = self._collective("mesh.all_reduce", self._saved[1])
        return super().__enter__()

    def __exit__(self, *exc):
        from repro_torch.parallel.mesh import SNNMesh

        SNNMesh.all_gather, SNNMesh.all_reduce = self._saved
        return super().__exit__(*exc)

    def _collective(self, name: str, fn: Callable) -> Callable:
        rec = self

        def wrapped(mesh, x, *args, **kwargs):
            outer = getattr(_state, "inside", None)
            _state.inside = outer or name
            try:
                out = fn(mesh, x, *args, **kwargs)
            finally:
                _state.inside = outer
            if outer is None and _build.twin_running() is None:
                loop, scope = _context(rec.loop_codes)
                rec.records.append(OpRecord(
                    name=name, in_shapes=(tuple(x.shape),), in_dtypes=(_dt(x),),
                    in_devices=(x.device.type,), out_shapes=(tuple(out.shape),),
                    out_dtypes=(_dt(out),), out_devices=(out.device.type,), in_loop=loop,
                    scope=scope, collective=True))
            return out
        return wrapped

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = _tensors(args, []) + _tensors(list(kwargs.values()), [])
        outs = _tensors(out, [])
        name = str(func)   # "aten.mul.Tensor"
        inside = _build.twin_running() or getattr(_state, "inside", None)
        loop, scope = _context(self.loop_codes)
        index_dtypes = ()
        if func.overloadpacket in (torch.ops.aten.index, torch.ops.aten.index_put,
                                   torch.ops.aten.index_put_) and len(args) > 1:
            index_dtypes = tuple(_dt(t) for t in _tensors(args[1], []))
        self.records.append(OpRecord(
            name=name, in_shapes=tuple(tuple(t.shape) for t in ins),
            in_dtypes=tuple(_dt(t) for t in ins), in_devices=tuple(t.device.type for t in ins),
            out_shapes=tuple(tuple(t.shape) for t in outs),
            out_dtypes=tuple(_dt(t) for t in outs),
            out_devices=tuple(t.device.type for t in outs), in_loop=loop, scope=scope,
            inside=inside, collective=name.startswith("c10d.") and inside is None,
            kwargs=tuple(sorted(k for k, v in kwargs.items() if v is not None)),
            index_dtypes=index_dtypes))
        return out


def record(fn: Callable[[], Any], loop_codes: Optional[tuple] = None) -> List[OpRecord]:
    """Run ``fn()`` under an :class:`OpRecorder`; return its records."""
    rec = OpRecorder(loop_codes)
    with rec:
        fn()
    return rec.records


def _own(records: Sequence[OpRecord]):
    """The program's own ops: not inside a kernel's twin or a collective."""
    return [r for r in records if r.inside is None]


# ---------------------------------------------------------------------------
# purity
# ---------------------------------------------------------------------------

def sync_reason(r: OpRecord) -> Optional[str]:
    """Why the op makes the host wait for the device on CUDA, or None."""
    base = r.name.rsplit(".", 1)[0]
    if base in SYNC_OPS:
        return f"`{r.name}` reads a device value back to the host"
    if base == "aten.repeat_interleave" and "output_size" not in r.kwargs \
            and r.in_shapes and len(r.in_shapes[0]):
        return f"`{r.name}` without output_size sizes its result from device data"
    if base in ("aten.index", "aten.index_put", "aten.index_put_") and any(
            d in ("bool", "uint8") for d in r.index_dtypes):
        return f"`{r.name}` with a boolean mask sizes its result from device data"
    if base in ("aten._to_copy", "aten.copy_", "aten.to") and r.out_devices \
            and r.out_devices[0] == "cpu" and any(d != "cpu" for d in r.in_devices):
        return f"`{r.name}` copies a device tensor to the host"
    return None


def check_hot_loop_purity(records: Sequence[OpRecord], program: str, *,
                          allow: Sequence[str] = ()) -> List[Finding]:
    """No host sync inside the tick loop (a WARNING outside it), and no op
    outside the framework's namespaces anywhere."""
    out: List[Finding] = []
    for r in _own(records):
        if r.name in allow or r.collective:
            continue
        if r.namespace not in FRAMEWORK_NAMESPACES:
            out.append(Finding(
                rule="purity.host_custom_call", severity=ERROR, program=program,
                location=r.scope.rsplit("/", 1)[-1],
                message=f"custom op `{r.name}` in a tick program: it may call back into "
                        f"the host"))
            continue
        why = sync_reason(r)
        if why is None:
            continue
        if r.in_loop:
            out.append(Finding(
                rule="purity.sync_in_loop", severity=ERROR, program=program,
                location=r.scope.rsplit("/", 1)[-1],
                message=f"{why} inside the tick loop: one host round trip per tick"))
        else:
            out.append(Finding(
                rule="purity.sync", severity=WARNING, program=program,
                location=r.scope.rsplit("/", 1)[-1],
                message=f"{why} outside the loop: the host waits for the device once"))
    return out


# ---------------------------------------------------------------------------
# dtype discipline
# ---------------------------------------------------------------------------

def check_dtype_discipline(
        records: Sequence[OpRecord], program: str, *,
        upcast_allowlist: Sequence[str] = DEFAULT_UPCAST_ALLOWLIST) -> List[Finding]:
    """No float64, complex128 or uint64 tensor anywhere (int64 is allowed:
    :data:`ALLOWED_64BIT`), and every ``uint8 -> float`` widen under a
    sanctioned scope."""
    out: List[Finding] = []
    pats = [re.compile(p) for p in upcast_allowlist]
    for r in _own(records):
        loc = r.scope.rsplit("/", 1)[-1]
        bad_out = [d for d in r.out_dtypes if d in FORBIDDEN_64BIT]
        bad_in = [d for d in r.in_dtypes if d in FORBIDDEN_64BIT]
        if bad_out:
            out.append(Finding(rule="dtype.x64", severity=ERROR, program=program, location=loc,
                               message=f"64-bit result of `{r.name}` -> {bad_out[0]}"))
        elif bad_in:
            out.append(Finding(
                rule="dtype.x64_lowered", severity=ERROR, program=program, location=loc,
                message=f"`{r.name}` consumes a {bad_in[0]} tensor behind a "
                        f"{r.out_dtypes[0] if r.out_dtypes else 'scalar'} result"))
        if "uint8" in r.in_dtypes and any(d.startswith(("float", "bfloat")) for d in
                                           r.out_dtypes):
            if not any(p.search(r.scope) for p in pats):
                out.append(Finding(
                    rule="dtype.u8_upcast", severity=ERROR, program=program, location=loc,
                    message=f"uint8 -> {r.out_dtypes[0]} widen (`{r.name}`) outside "
                            f"sanctioned scopes (scope={r.scope or '<none>'})"))
    return out


# ---------------------------------------------------------------------------
# hoist contract
# ---------------------------------------------------------------------------

def square_muls(records: Sequence[OpRecord], n: int) -> Tuple[int, int]:
    """Elementwise multiplies whose two operands are both ``(n, n)``:
    ``(inside the loop, outside it)``, over the whole recording. A kernel's
    twin is opaque: a multiply inside a kernel is judged by the kernel lint."""
    in_loop = hoisted = 0
    for r in _own(records):
        if r.name in _MULS and len(r.in_shapes) >= 2 \
                and all(s == (n, n) for s in r.in_shapes[:2]):
            if r.in_loop:
                in_loop += 1
            else:
                hoisted += 1
    return in_loop, hoisted


def check_hoist(records: Sequence[OpRecord], program: str, *, n: int,
                expect: str = HOIST_HOISTED) -> List[Finding]:
    """The ``W*C`` premask contract: frozen programs form the ``(n, n)``
    product once, outside the loop; learning programs form it every tick
    (a hoisted product would be stale); a kernel that masks per tile leaves
    no dense product in the loop."""
    if expect == HOIST_SKIP:
        return []
    in_loop, hoisted = square_muls(records, n)
    out: List[Finding] = []
    if expect == HOIST_HOISTED:
        if in_loop:
            out.append(Finding(
                rule="hoist.wc_in_loop", severity=ERROR, program=program,
                location=f"{in_loop} op(s)",
                message=f"frozen-weight program forms ({n},{n}) W*C inside the tick loop "
                        f"{in_loop}x"))
        if not hoisted:
            out.append(Finding(
                rule="hoist.wc_missing", severity=ERROR, program=program,
                message=f"no hoisted ({n},{n}) W*C multiply found -- the premask was "
                        f"never formed"))
    elif expect == HOIST_IN_LOOP:
        if not in_loop:
            out.append(Finding(
                rule="hoist.wc_not_in_loop", severity=ERROR, program=program,
                message=f"learning program has no in-loop ({n},{n}) W*C multiply: a "
                        f"hoisted stale premask would miss per-tick weight updates"))
    elif expect == HOIST_KERNEL:
        if in_loop:
            out.append(Finding(
                rule="hoist.wc_in_loop", severity=ERROR, program=program,
                location=f"{in_loop} op(s)",
                message=f"({n},{n}) W*C multiply leaked outside the kernel into the tick "
                        f"loop"))
    else:
        raise ValueError(f"unknown hoist expectation {expect!r}")
    return out
