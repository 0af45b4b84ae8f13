"""Loops that a cost recorder runs once and counts many times.

The reference's scans over time (the selective scan, the WKV recurrence)
are ``lax.scan`` ``while`` loops, and its cost model
(``repro.launch.hlo_cost``) multiplies a loop body's costs by the trip
count. The port's counterparts are Python loops; its cost model
(:mod:`repro_torch.launch.hlo_cost`) traces every op they dispatch, which
costs time per step. So these loops go through :func:`scan`:

* outside a recording it is the plain loop, step for step, and every number
  is what the loop gives;
* under a recording it runs three steps of a longer loop (the first, one
  middle step and the last), multiplies the counts of the middle step's ops
  by the steps it stands for (the ops of its backward too), and returns
  outputs of the full shape.

:func:`checkpoint` is ``torch.utils.checkpoint.checkpoint`` that keeps those
multipliers right when the backward recomputes a region.

The multiplier of an op is the product of the trip counts of the loops it
runs in (the microbatch loop of ``launch/steps.py`` also goes through
:func:`scan`: its body runs a whole forward and backward). An op of a
backward run outside the loop that built its graph takes the count that the
recorder tagged its autograd node with when the forward built it (in the
node's ``metadata``). A region that :func:`checkpoint` recomputes takes the
multiplier that held where it was checkpointed; its loops tag nothing (the
recomputed graph is never run backward).
"""
from __future__ import annotations

import threading
from typing import Any, Callable, List, Optional, Tuple

import torch
from torch.utils import checkpoint as _ckpt

from repro_torch.util import tree

_KEY = "repro_trips"
_NO_SEQ = 2 ** 64 - 1           # AccumulateGrad nodes: leaves, never tagged
_recorder: Optional[Any] = None  # the active recording (process-wide)
# ("loop", n) or ("base", m), innermost last. The frames the step's own code
# pushes are process-wide: autograd runs a CUDA graph's backward on a thread
# of its own while the thread that called it waits inside the loop. The
# frames pushed inside a backward (a checkpoint's recomputation, on the
# thread that needed it) are that thread's alone: another thread may run the
# backward of other nodes meanwhile.
_FRAMES: List[Tuple[str, int]] = []
_LOCAL = threading.local()


def _frames() -> List[Tuple[str, int]]:
    """The stack a loop or a recomputation pushes its frame on."""
    if torch._C._current_autograd_node() is None:
        return _FRAMES
    if not hasattr(_LOCAL, "frames"):
        _LOCAL.frames = []
    return _LOCAL.frames


def recording() -> bool:
    """True while a cost recorder is active."""
    return _recorder is not None


def activate(recorder: Optional[Any]) -> Optional[Any]:
    """Make ``recorder`` the active one (None: none); returns the previous."""
    global _recorder
    prev, _recorder = _recorder, recorder
    return prev


def multiplier() -> int:
    """How many times the op being dispatched now counts."""
    m = 1
    for kind, v in reversed(getattr(_LOCAL, "frames", None) or _FRAMES):
        m *= v
        if kind == "base":
            return m
    node = torch._C._current_autograd_node()
    if node is not None:
        m *= node.metadata.get(_KEY, 1)
    return m


def _tag(roots, start: int, n: int) -> None:
    """Multiply by ``n`` the trips of every autograd node behind ``roots``
    that was made at or after sequence number ``start``."""
    # ``seen`` holds the nodes it has met: a node's Python object may be made
    # afresh at each access and freed after, and a freed object's id reused.
    seen, todo = {}, [t.grad_fn for t in roots
                      if isinstance(t, torch.Tensor) and t.grad_fn is not None]
    while todo:
        node = todo.pop()
        if node is None or id(node) in seen:
            continue
        seen[id(node)] = node
        seq = node._sequence_nr()
        if seq < start or seq == _NO_SEQ:
            continue
        node.metadata[_KEY] = node.metadata.get(_KEY, 1) * n
        todo.extend(fn for fn, _ in node.next_functions)


def scan(body: Callable, carry, n: int, dim: Optional[int] = None):
    """``(carry, ys)`` after ``n`` steps of ``carry, y = body(carry, t)``,
    ``ys`` the ``y``s stacked on a new leading dim (concatenated along their
    own dim ``dim`` if given), or None if the body gives None
    (``lax.scan``'s contract with the step index as the input).

    Under a recording a loop of more than 3 steps runs three: the first,
    one middle step that counts ``n - 2`` times and the last, so that each
    kind of step is in the record with its backward (the first takes the
    initial carry, the last gives the final one, a middle step's carry comes
    from a step and goes to one). ``ys`` has the full shape (the middle
    step's output repeated) and the carry is the last step's.
    """
    if _recorder is None or n <= 3:
        ys = []
        for t in range(n):
            carry, y = body(carry, t)
            ys.append(y)
        if ys[-1] is None:
            return carry, None
        return carry, (torch.stack(ys) if dim is None else torch.cat(ys, dim))
    ys = []
    frames = _frames()
    for t, count in ((0, 1), (1, n - 2), (n - 1, 1)):
        start = torch._C._autograd._get_sequence_nr()
        frames.append(("loop", count))
        try:
            carry, y = body(carry, t)
        finally:
            frames.pop()
        if count > 1 and torch.is_grad_enabled() and torch._C._current_autograd_node() is None:
            _tag(tree.leaves((carry, y)), start, count)
        ys.append(y)
    if y is None:
        return carry, None
    if dim is not None:
        return carry, torch.cat([ys[0]] + [ys[1]] * (n - 2) + [ys[2]], dim)
    mid = ys[1][None].expand((n - 2,) + tuple(ys[1].shape))
    return carry, torch.cat([ys[0][None], mid, ys[2][None]])


def checkpoint(fn: Callable, *args, **kwargs):
    """``torch.utils.checkpoint.checkpoint(fn, *args, **kwargs)``; the
    recomputation in the backward runs under the sharding rules the forward
    ran under (they are per thread, and autograd recomputes a CUDA graph on
    a thread of its own: without them a recomputed layer is laid out
    otherwise than the forward's), and under a recording its ops count as
    they did in the forward."""
    from repro_torch.parallel.sharding import current_rules, use_rules

    rules = current_rules()
    base = None if _recorder is None else multiplier()
    if rules is None and base is None:
        return _ckpt.checkpoint(fn, *args, **kwargs)

    def body(*a, **k):
        with use_rules(rules):
            if base is None:
                return fn(*a, **k)
            frames = _frames()
            frames.append(("base", base))
            try:
                return fn(*a, **k)
            finally:
                frames.pop()

    return _ckpt.checkpoint(body, *args, **kwargs)
