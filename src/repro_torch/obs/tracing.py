"""Tracing hooks: named scopes in the tick loop, timed spans on the host.

Counterpart of ``repro.obs.tracing``, on ``torch.profiler``:

* :func:`trace_scope` -- ``torch.profiler.record_function``: labels the ops
  of a region, so a profiler trace reads ``tick/event/topk`` instead of a
  list of kernels. A record costs a few microseconds even with no profiler
  running, so the tick loop asks :func:`profiling` once per rollout and
  opens no scope when it is False.

* :class:`span` -- the program's one host timing facility, around a stage
  of the serving loop (a wave, a chunk's dispatch, a refill). Off (no
  profiler recording), it only times the region with one ``perf_counter``
  pair for its sinks: an optional
  :class:`~repro_torch.obs.metrics.Histogram` and an optional running total
  ``[seconds, count]``. On, it also opens a profiler record of its name
  (``torch._C._profiler._RecordFunctionFast``: ``record_function``'s record
  without its Python wrapper, which takes microseconds on each side of the
  profiler's own stamp), so the profiler's host timeline and the idle gaps
  of its device timeline carry the stage's name, and appends a
  :class:`SpanRecord` to the process-wide :class:`SpanLog`
  (:func:`get_span_log`): name, start and end in ``time.time_ns()`` (the
  clock the profiler stamps its events on, and the one
  ``ServeRequest.t_submit`` is read from), the index of the enclosing
  recorded span and the attributes given.
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, List, Optional

import torch


def profiling() -> bool:
    """Whether a ``torch.profiler`` (or autograd profiler) is recording."""
    return torch.autograd._profiler_enabled()


def trace_scope(name: str, enabled: bool = True):
    """Label the ops of a region (``with trace_scope("tick/event"): ...``);
    ``enabled=False`` opens nothing."""
    return torch.profiler.record_function(name) if enabled else contextlib.nullcontext()


class SpanRecord:
    """One recorded span: ``start_ns`` / ``end_ns`` on ``time.time_ns()``
    (``end_ns`` is 0 while it is open), ``parent`` the :class:`SpanLog`
    index of the enclosing recorded span on the same thread (-1 at the top)."""

    __slots__ = ("name", "start_ns", "end_ns", "parent", "attrs")

    def __init__(self, name: str, start_ns: int, parent: int, attrs: Dict):
        self.name, self.start_ns, self.end_ns = name, start_ns, 0
        self.parent, self.attrs = parent, attrs

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


class SpanLog:
    """The records of the spans opened while a profiler recorded, in the
    order they opened, at most ``max_records``: later ones are counted in
    :attr:`dropped` and not kept, so every kept record's ``parent`` index
    stays valid. :meth:`clear` starts a new window."""

    def __init__(self, max_records: int = 1 << 18):
        self._max = int(max_records)
        self._records: List[SpanRecord] = []
        self.dropped = 0
        self._lock = threading.Lock()
        self._open = threading.local()   # per thread: indices of its open records

    def _stack(self) -> List[int]:
        stack = getattr(self._open, "stack", None)
        if stack is None:
            stack = self._open.stack = []
        return stack

    def open(self, name: str, start_ns: int, attrs: Dict) -> int:
        """Append an open record; returns its index, or -1 when it was dropped."""
        stack = self._stack()
        parent = stack[-1] if stack else -1
        with self._lock:
            if len(self._records) >= self._max:
                self.dropped += 1
                return -1
            self._records.append(SpanRecord(name, start_ns, parent, attrs))
            i = len(self._records) - 1
        stack.append(i)
        return i

    def close(self, i: int, end_ns: int) -> None:
        if i < 0:
            return
        self._records[i].end_ns = end_ns
        stack = self._stack()
        if stack and stack[-1] == i:
            stack.pop()

    def records(self) -> List[SpanRecord]:
        with self._lock:
            return list(self._records)

    def clear(self) -> None:
        with self._lock:
            self._records.clear()
            self.dropped = 0


_DEFAULT = SpanLog()


def get_span_log() -> SpanLog:
    return _DEFAULT


class span:
    """Time a host region: ``with span("snn/fill", total=t, rid=7, slot=2): ...``.

    Args:
      histogram: optional :class:`~repro_torch.obs.metrics.Histogram`; the
        elapsed seconds are observed into it with ``attrs`` as its labels.
      total: optional ``[seconds, count]`` list the elapsed seconds and one
        are added to.
      on: whether a profiler is recording, as the caller last asked
        :func:`profiling` (a loop asks once per iteration); None asks now.
      attrs: kept on the record (``rid``, ``slot``, ``backend``).

    Off, with neither sink, it does nothing.
    """

    __slots__ = ("name", "histogram", "total", "on", "attrs", "_t0", "_rf", "_i")

    def __init__(self, name: str, histogram=None, *, total: Optional[List] = None,
                 on: Optional[bool] = None, **attrs):
        self.name, self.histogram, self.total, self.attrs = name, histogram, total, attrs
        self.on = profiling() if on is None else on

    def __enter__(self) -> "span":
        if self.on:
            # Stamped inside the profiler's own event, which it opens and closes.
            self._rf = torch._C._profiler._RecordFunctionFast(self.name)
            self._rf.__enter__()
            self._t0 = time.time_ns()
            self._i = _DEFAULT.open(self.name, self._t0, self.attrs)
        elif self.histogram is not None or self.total is not None:
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        if self.on:
            end = time.time_ns()
            self._rf.__exit__(*exc)
            _DEFAULT.close(self._i, end)
            dt = (end - self._t0) / 1e9
        elif self.histogram is not None or self.total is not None:
            dt = time.perf_counter() - self._t0
        else:
            return
        if self.total is not None:
            self.total[0] += dt
            self.total[1] += 1
        if self.histogram is not None:
            self.histogram.observe(dt, **self.attrs)
