"""Trip-count-aware cost extraction for the roofline analysis.

Counterpart of ``repro.launch.hlo_cost``. The reference parses a compiled
XLA program's text; eager PyTorch has no such program, so the input here is
a record of the **local** ops a step dispatches on one rank: :func:`record`
runs a function under a recorder and :func:`analyze` sums the record.

The recorder sits beneath DTensor, where each op is a rank's own: either
:class:`FakeRecorder`, a ``FakeTensorMode`` whose fake tensors (the local
shards of a dry run) dispatch through it while it is *not* on the mode
stack (DTensor's sharding propagation makes helper tensors of its own,
which must stay real), or :class:`Recorder`, a ``TorchDispatchMode`` pushed
for a step on real tensors. The counting rules:

  flops              2*M*N*K for ``mm`` / ``addmm`` / ``bmm`` / ``baddbmm``
                     (``mv``, ``dot`` alike), and for ``convolution``
                     2 * output elements * (weight elements / out channels),
                     as the reference counts a convolution
  dot_bytes          the two matrix operands' and the output's bytes of
                     those ops, an operand broadcast over a batch counted
                     once (an HBM-traffic model assuming elementwise ops
                     fuse into the products, the reference's)
  collective_bytes   operand bytes by kind: ``_c10d_functional``'s
                     ``all_gather_into_tensor`` (all-gather), ``all_reduce``,
                     ``reduce_scatter_tensor``, ``all_to_all_single`` and
                     their ``_coalesced`` forms, DTensor's
                     ``shard_dim_alltoall`` (all-to-all), and the ``c10d`` ops of the
                     SNN fabric's mesh (``_allgather_base_``, ``allreduce_``,
                     ...) by their kinds
  peak_bytes         the largest sum of the bytes of the storages the
                     recorded ops allocated and that were still alive (each
                     tracked until its last tensor is freed); the arguments'
                     storages are not in it, the outputs' are
  temp_bytes         the same peak over the storages that are neither
                     arguments nor outputs (XLA's ``temp_size``), with the
                     largest storages alive at it (``at_peak``: bytes,
                     shape, dtype, op and the innermost frame of the port's
                     ``models/``, ``optim/`` or ``launch/``); set when
                     :func:`record` returns, from the outputs it returned

**Trip counts.** The reference multiplies ``while`` bodies by their trip
counts. The port's loops that are ``lax.scan``s in the reference (the
per-step loops of ``models/ssm.py`` and ``models/rwkv.py``, and their chunk
loops) go through :func:`repro_torch.util.trips.scan`: under a recording
the body runs once and each of its ops (and of its backward) counts the trip
count times; its outputs keep their full shapes. Outside a recording nothing
changes. The shortcut lowers the peak: a step's temporaries exist once
rather than once a step, and the list of per-step outputs that the plain
loop stacks at its end is not built (the stacked output is).
"""
from __future__ import annotations

import dataclasses
import math
import os
import sys
import threading
import traceback
import weakref
from collections import Counter, defaultdict
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.util import trips

COLLECTIVE_KINDS = (
    "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
    "collective-permute",
)

# Products: op name -> how its FLOPs and dot bytes are counted.
_DOTS = {"aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm", "aten::mv", "aten::dot",
         "aten::convolution"}

# Collectives: op name -> (kind, the schema arguments that are its operands).
_COLLECTIVES = {
    "_c10d_functional::all_gather_into_tensor": ("all-gather", ("input",)),
    "_c10d_functional::all_gather_into_tensor_coalesced": ("all-gather", ("inputs",)),
    "_c10d_functional::all_reduce": ("all-reduce", ("input",)),
    "_c10d_functional::all_reduce_coalesced": ("all-reduce", ("inputs",)),
    "_c10d_functional::reduce_scatter_tensor": ("reduce-scatter", ("input",)),
    "_c10d_functional::reduce_scatter_tensor_coalesced": ("reduce-scatter", ("inputs",)),
    "_c10d_functional::all_to_all_single": ("all-to-all", ("input",)),
    "_dtensor::shard_dim_alltoall": ("all-to-all", ("input",)),   # DTensor's on the card
    "c10d::allreduce_": ("all-reduce", ("tensors",)),
    "c10d::allreduce_coalesced_": ("all-reduce", ("tensors",)),
    "c10d::allgather_": ("all-gather", ("input_tensors",)),
    "c10d::_allgather_base_": ("all-gather", ("input_tensor",)),
    "c10d::allgather_coalesced_": ("all-gather", ("input_list",)),
    "c10d::allgather_into_tensor_coalesced_": ("all-gather", ("inputs",)),
    "c10d::reduce_scatter_": ("reduce-scatter", ("input_tensors",)),
    "c10d::_reduce_scatter_base_": ("reduce-scatter", ("input_tensor",)),
    "c10d::reduce_scatter_tensor_coalesced_": ("reduce-scatter", ("inputs",)),
    "c10d::alltoall_": ("all-to-all", ("input_tensors",)),
    "c10d::alltoall_base_": ("all-to-all", ("input",)),
    "c10d::send": ("collective-permute", ("tensors",)),
}

_HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))  # the package
_STACK_DEPTH = 6
AT_PEAK = 8                       # storages named at the temp's peak
_FRAME_DIRS = tuple(os.path.join(_HERE, d) + os.sep for d in ("models", "optim", "launch"))
_frames: Dict[Any, Optional[str]] = {}    # code object -> its "file" or None


def cost_dict(cost_analysis) -> Dict[str, float]:
    """The global count of ``torch.utils.flop_counter.FlopCounterMode`` as
    ``{"flops": ...}`` (the place of XLA's ``compiled.cost_analysis()``).
    A dict passes through; a one-element list of dicts gives its dict;
    None or anything else gives {}."""
    if cost_analysis is None:
        return {}
    if isinstance(cost_analysis, dict):
        return cost_analysis
    if isinstance(cost_analysis, (list, tuple)):
        return cost_analysis[0] if cost_analysis and isinstance(
            cost_analysis[0], dict) else {}
    total = getattr(cost_analysis, "get_total_flops", None)
    return {"flops": float(total())} if total is not None else {}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class OpRecord(NamedTuple):
    """One counted op: a product or a collective."""
    op: str                    # "aten::mm", "_c10d_functional::all_reduce", ...
    kind: str                  # "dot" or a COLLECTIVE_KINDS entry
    flops: float               # one execution's
    nbytes: float              # dot bytes or collective operand bytes, one execution's
    trips: int                 # how many times it counts
    shapes: str                # the operands' local shapes
    stack: Tuple[str, ...]     # the port's innermost frames, "file:line fn"


def _stack() -> Tuple[str, ...]:
    frames = [f for f in traceback.extract_stack()[:-3]
              if f.filename.startswith(_HERE) and not f.filename.endswith(
                  ("hlo_cost.py", "trips.py"))]
    return tuple(f"{os.path.relpath(f.filename, os.path.dirname(_HERE))}:{f.lineno} {f.name}"
                 for f in frames[-_STACK_DEPTH:])


def _frame() -> str:
    """The innermost frame of the calling stack in the port's ``models/``,
    ``optim/`` or ``launch/`` (this module aside), as "file:line fn"; "?"
    where there is none (a backward on autograd's device thread)."""
    f = sys._getframe(1)
    while f is not None:
        code = f.f_code
        if code not in _frames:
            name = code.co_filename
            _frames[code] = (os.path.relpath(name, os.path.dirname(_HERE))
                             if name.startswith(_FRAME_DIRS)
                             and not name.endswith("hlo_cost.py") else None)
        if _frames[code] is not None:
            return f"{_frames[code]}:{f.f_lineno} {code.co_name}"
        f = f.f_back
    return "?"


class Allocation(NamedTuple):
    """A storage the recorded ops allocated."""
    nbytes: int
    shape: Tuple[int, ...]     # of the tensor that made it
    dtype: str
    op: str                    # "aten::mm", ...
    frame: str                 # :func:`_frame` at the op


def _distinct_bytes(t: torch.Tensor) -> int:
    """The bytes of ``t``'s distinct elements: a dim broadcast by a zero
    stride (a weight expanded over a batch) is read once."""
    return t.element_size() * math.prod(n for n, st in zip(t.shape, t.stride()) if st)


def _dot_cost(name: str, args, out) -> Tuple[float, float, str]:
    """(flops, dot bytes, shapes) of one product."""
    if name in ("aten::addmm", "aten::baddbmm"):
        a, b = args[1], args[2]
    else:
        a, b = args[0], args[1]
    shapes = f"{tuple(a.shape)} x {tuple(b.shape)}"
    nbytes = float(_distinct_bytes(a) + _distinct_bytes(b) + _nbytes(out))
    if name == "aten::convolution":
        return 2.0 * out.numel() * max(1, b.numel() // max(1, b.shape[0])), nbytes, shapes
    k = a.shape[-1] if a.dim() else 1
    return 2.0 * out.numel() * k, nbytes, shapes


def _operand_bytes(func, args, kwargs, names) -> Tuple[float, str]:
    schema = func._schema
    given = dict(zip((a.name for a in schema.arguments), args))
    given.update(kwargs or {})
    leaves = []
    for n in names:
        leaves.extend(tree_flatten(given.get(n))[0])
    ts = [t for t in leaves if isinstance(t, torch.Tensor)]
    return float(sum(_nbytes(t) for t in ts)), " ".join(str(tuple(t.shape)) for t in ts)


class Recording:
    """What a recorder saw: the counted ops, every op's name, and the
    storages the ops allocated (their live and peak bytes, and the order in
    which they were made and freed). Two threads may note ops at once (a
    backward's CPU and CUDA nodes)."""

    def __init__(self):
        self._lock = threading.RLock()
        self.records: List[OpRecord] = []
        self.op_counts: Counter = Counter()
        self.live_bytes = 0
        self.peak_bytes = 0
        self.temp_bytes: Optional[int] = None      # set by close()
        self.at_peak: List[Allocation] = []        # set by close()
        self.allocations: List[Allocation] = []
        self._events: List[int] = []          # allocation i made: i; freed: ~i
        self._refs: Dict[int, int] = {}       # storage -> tensors that hold it
        self._live: Dict[int, int] = {}       # storage -> its allocation
        self._known: set = set()              # storages that were there before
        from torch.utils.weak import WeakIdKeyDictionary
        self._tracked = WeakIdKeyDictionary()

    # -- memory ---------------------------------------------------------------

    def exclude(self, tensors) -> None:
        """Storages the recorded ops do not allocate (the arguments)."""
        for t in tensors:
            if isinstance(t, torch.Tensor):
                self._known.add(_storage_key(t))

    def _release(self, key: int) -> None:
        with self._lock:
            self._release_locked(key)

    def _release_locked(self, key: int) -> None:
        n = self._refs.get(key)
        if n is None:
            return
        if n > 1:
            self._refs[key] = n - 1
            return
        del self._refs[key]
        i = self._live.pop(key)
        self._events.append(~i)
        self.live_bytes -= self.allocations[i].nbytes

    def _hold(self, t: torch.Tensor, key: int) -> None:
        if t in self._tracked:
            return
        self._tracked[t] = True
        self._refs[key] = self._refs.get(key, 0) + 1
        weakref.finalize(t, self._release, key)

    def _note_memory(self, func, out) -> None:
        returns = func._schema.returns
        outs = out if isinstance(out, (tuple, list)) else (out,)
        for i, t in enumerate(outs):
            if not isinstance(t, torch.Tensor):
                continue
            try:
                key = _storage_key(t)
            except (RuntimeError, NotImplementedError):
                continue
            if key in self._refs:                      # a view or the same storage
                self._hold(t, key)
                continue
            aliased = i < len(returns) and returns[i].alias_info is not None
            if aliased or key in self._known:
                continue
            size = t.untyped_storage().nbytes()
            if size == 0:
                continue
            self._live[key] = len(self.allocations)
            self._events.append(len(self.allocations))
            self.allocations.append(Allocation(size, tuple(t.shape), str(t.dtype).replace(
                "torch.", ""), func._schema.name, _frame()))
            self.live_bytes += size
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            self._hold(t, key)

    def close(self, outputs) -> None:
        """Set :attr:`temp_bytes`, the peak of the live bytes of the
        allocated storages that ``outputs`` (the recorded function's
        result) do not hold, and :attr:`at_peak`, the largest of them alive
        at that peak, from the order in which they were made and freed."""
        with self._lock:
            keep = {self._live[k] for k in (_storage_key(t) for t in tensors(outputs))
                    if k in self._live}
            events = list(self._events)
        live = peak = 0
        at = -1
        for n, e in enumerate(events):
            i = e if e >= 0 else ~e
            if i in keep:
                continue
            live += self.allocations[i].nbytes if e >= 0 else -self.allocations[i].nbytes
            if live > peak:
                peak, at = live, n
        alive = set()
        for e in events[:at + 1]:
            if e >= 0:
                alive.add(e)
            else:
                alive.discard(~e)
        self.temp_bytes = peak
        self.at_peak = sorted((self.allocations[i] for i in alive - keep),
                              key=lambda a: -a.nbytes)[:AT_PEAK]

    # -- counts ---------------------------------------------------------------

    def note(self, func, args, kwargs, out) -> None:
        with self._lock:
            self._note(func, args, kwargs, out)

    def _note(self, func, args, kwargs, out) -> None:
        name = func._schema.name
        self.op_counts[name] += 1
        self._note_memory(func, out)
        if name in _DOTS:
            res = out[0] if isinstance(out, (tuple, list)) else out
            flops, nbytes, shapes = _dot_cost(name, args, res)
            self.records.append(OpRecord(name, "dot", flops, nbytes, trips.multiplier(),
                                         shapes, _stack()))
        elif name in _COLLECTIVES:
            kind, names = _COLLECTIVES[name]
            nbytes, shapes = _operand_bytes(func, args, kwargs, names)
            self.records.append(OpRecord(name, kind, 0.0, nbytes, trips.multiplier(),
                                         shapes, _stack()))

    def text(self) -> str:
        """The record as text: one line per counted op, then every op's count."""
        lines = [f"{r.kind:14s} {r.op:50s} x{r.trips:<6d} flops {r.flops:.6g} "
                 f"bytes {r.nbytes:.6g} {r.shapes} | {' < '.join(reversed(r.stack))}"
                 for r in self.records]
        lines.append(f"# peak bytes {self.peak_bytes}")
        if self.temp_bytes is not None:
            lines.append(f"# temp bytes {self.temp_bytes} (the outputs left out); alive at "
                         "its peak:")
            lines += [f"#   {a.nbytes} B {a.dtype}{list(a.shape)} {a.op} at {a.frame}"
                      for a in self.at_peak]
        lines += [f"# {n} {c}" for n, c in sorted(self.op_counts.items())]
        return "\n".join(lines) + "\n"


def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


class Recorder(TorchDispatchMode):
    """A dispatch mode that records the ops of real tensors into a
    :class:`Recording` (push it with ``with``)."""

    def __init__(self, recording: Recording):
        super().__init__()
        self.recording = recording

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.recording.note(func, args, kwargs, out)
        return out


class FakeRecorder(FakeTensorMode):
    """A ``FakeTensorMode`` that records each op its fake tensors dispatch
    while :attr:`recording` is set (see :func:`record`). Make the fake
    tensors under ``with mode:``; run the step with the mode off the stack (a
    fake tensor dispatches through its own mode)."""

    def __init__(self, **kw):
        kw.setdefault("allow_non_fake_inputs", True)
        super().__init__(**kw)
        self.recording: Optional[Recording] = None
        # Nesting per thread: autograd runs the backward of CUDA tensors on a
        # thread of its own while the calling thread runs the CPU nodes.
        self._nesting = threading.local()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        depth = getattr(self._nesting, "depth", 0)
        self._nesting.depth = depth + 1
        try:
            out = super().__torch_dispatch__(func, types, args, kwargs)
        finally:
            self._nesting.depth = depth
        if self.recording is not None and depth == 0:
            self.recording.note(func, args, kwargs, out)
        return out


def record(fn: Callable, *args, fake_mode=None, shortcut: bool = True,
           **kwargs) -> Tuple[Any, Recording]:
    """``(fn(*args, **kwargs), recording)``: the ops ``fn`` dispatches,
    local to this rank. With ``fake_mode`` (a :func:`FakeRecorder` whose fake
    tensors the arguments hold) the mode records while it stays off the
    stack; without, a :class:`Recorder` is pushed for real tensors. The
    arguments' storages are not counted as allocations. Loops through
    :func:`repro_torch.util.trips.scan` run their body once and count it
    their trip count times (every step runs with ``shortcut=False``). The
    recording is closed on the result (:meth:`Recording.close`)."""
    rec = Recording()
    rec.exclude(tensors((args, kwargs)))
    prev = trips.activate(rec if shortcut else None)
    try:
        if fake_mode is not None:
            fake_mode.recording = rec
            try:
                out = fn(*args, **kwargs)
            finally:
                fake_mode.recording = None
        else:
            with Recorder(rec):
                out = fn(*args, **kwargs)
    finally:
        trips.activate(prev)
    rec.close(out)
    return out, rec


def tensors(obj) -> List[torch.Tensor]:
    """Every tensor inside dicts, lists, tuples and dataclasses of ``obj``,
    a DTensor as its local shard."""
    from torch.distributed.tensor import DTensor

    if isinstance(obj, DTensor):
        return [obj.to_local()]
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, dict):
        obj = list(obj.values())
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        obj = [getattr(obj, f.name) for f in dataclasses.fields(obj)]
    if isinstance(obj, (list, tuple)):
        return [t for x in obj for t in tensors(x)]
    return []


@dataclasses.dataclass
class CostSummary:
    flops: float
    dot_bytes: float
    collective_bytes: Dict[str, float]

    @property
    def total_collective_bytes(self) -> float:
        return sum(self.collective_bytes.values())

    def scaled(self, k: float) -> "CostSummary":
        return CostSummary(
            flops=self.flops * k,
            dot_bytes=self.dot_bytes * k,
            collective_bytes={kk: v * k for kk, v in self.collective_bytes.items()},
        )


def analyze(records) -> CostSummary:
    """Whole-step cost: each counted op times its trip count. ``records`` is
    a :class:`Recording` or its list of :class:`OpRecord`."""
    if isinstance(records, Recording):
        records = records.records
    flops = dot_bytes = 0.0
    coll: Dict[str, float] = defaultdict(float)
    for r in records:
        if r.kind == "dot":
            flops += r.trips * r.flops
            dot_bytes += r.trips * r.nbytes
        else:
            coll[r.kind] += r.trips * r.nbytes
    return CostSummary(flops=flops, dot_bytes=dot_bytes, collective_bytes=dict(coll))


class GlobalDots(TorchDispatchMode):
    """A dispatch mode above DTensor: each product that DTensor dispatches,
    at its global shapes, in order (with its trip count). The k-th of them
    is the k-th local product of the record beneath."""

    def __init__(self):
        super().__init__()
        self.products: List[Tuple[float, str]] = []   # (FLOPs x trips, shapes)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        out = func(*args, **(kwargs or {}))
        name = func._schema.name
        if name in _DOTS and any(isinstance(a, DTensor) for a in args):
            flops, _, shapes = _dot_cost(name, args, out)
            self.products.append((flops * trips.multiplier(), shapes))
        return out


def model_frame(stack) -> str:
    """The innermost frame of a recorded stack that lies in ``models/``
    (else the innermost frame)."""
    frames = [f for f in stack if "/models/" in f]
    return frames[-1] if frames else (stack[-1] if stack else "?")


def departures(records, products: List[Tuple[float, str]], n_chips: int) -> Dict:
    """Each local product of ``records`` against its even share (1 /
    ``n_chips``) of the same product at its global shapes (``products``, a
    :class:`GlobalDots`' list): how many compute more than their share, the
    FLOPs above the shares, the first that does, with its stack (the op
    where the layout departs from an even split), and every ``sites`` where
    one does: keyed by op and innermost ``models/`` frame, each with its
    count of products over their share, the largest times its share and the
    FLOPs above the shares, the most such FLOPs first."""
    if isinstance(records, Recording):
        records = records.records
    dots = [r for r in records if r.kind == "dot"]
    if len(dots) != len(products):
        return {"matched": False, "local_products": len(dots),
                "global_products": len(products)}
    over, excess, first = 0, 0.0, None
    sites: Dict[Tuple[str, str], Dict] = {}
    for r, (flops, shapes) in zip(dots, products):
        local = r.trips * r.flops
        if local * n_chips > flops * (1 + 1e-9):
            over += 1
            excess += local - flops / n_chips
            times = local * n_chips / flops
            if first is None:
                first = {"op": r.op, "local_shapes": r.shapes, "global_shapes": shapes,
                         "times_share": times, "stack": list(r.stack)}
            key = (r.op, model_frame(r.stack))
            site = sites.setdefault(key, {"op": key[0], "frame": key[1], "products": 0,
                                          "times_share": 0.0, "excess_flops": 0.0})
            site["products"] += 1
            site["times_share"] = max(site["times_share"], times)
            site["excess_flops"] += local - flops / n_chips
    return {"matched": True, "products": len(dots), "over_share": over,
            "excess_flops": excess, "first": first,
            "sites": sorted(sites.values(), key=lambda s: -s["excess_flops"])}


def largest(records, kind: str = "dot", n: int = 5) -> List[Tuple[float, OpRecord]]:
    """The ``n`` call sites with the most FLOPs (``kind="dot"``) or bytes
    (a collective kind), summed over their records: ``(total, first record)``."""
    if isinstance(records, Recording):
        records = records.records
    by_site: Dict[Tuple, List] = {}
    for r in records:
        if r.kind != kind:
            continue
        key = (r.op, r.shapes, r.stack)
        v = r.trips * (r.flops if kind == "dot" else r.nbytes)
        if key in by_site:
            by_site[key][0] += v
        else:
            by_site[key] = [v, r]
    return sorted(((v, r) for v, r in by_site.values()), key=lambda x: -x[0])[:n]
