"""Dependency-free metrics registry: counters, gauges, histograms.

The host-side half of the observability layer (DESIGN.md §11). No
prometheus_client, no opentelemetry -- the container bakes neither, and
the exposition format is a page of text protocol:

  https://prometheus.io/docs/instrumenting/exposition_formats/

Three instrument kinds, all label-aware:

* :class:`Counter` -- monotonically increasing (requests, spikes, waves).
* :class:`Gauge` -- last-write-wins (queue depth, resident tenants).
* :class:`Histogram` -- fixed buckets, cumulative counts + sum/count
  (TTFT, wave wall time).

One :class:`MetricsRegistry` owns the instruments and renders both a
Prometheus text exposition (:meth:`MetricsRegistry.to_prometheus`) and a
JSON-able dict (:meth:`MetricsRegistry.to_dict`). A process-wide default
registry is available via :func:`get_registry`, but servers create their
own so tests stay isolated.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple

# Prometheus-conventional latency buckets, in seconds.
DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                   1.0, 2.5, 5.0, 10.0)

LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labelnames: Sequence[str], labels: Dict[str, str]) -> LabelKey:
    if set(labels) != set(labelnames):
        raise ValueError(
            f"expected labels {sorted(labelnames)}, got {sorted(labels)}")
    return tuple((k, str(labels[k])) for k in labelnames)


def _render_labels(key: LabelKey, extra: str = "") -> str:
    parts = [f'{k}="{v}"' for k, v in key]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


class _Instrument:
    kind = "untyped"

    def __init__(self, name: str, help: str = "", labelnames: Sequence[str] = ()):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()

    def expose(self) -> List[str]:
        raise NotImplementedError

    def to_dict(self) -> Dict:
        raise NotImplementedError


class Counter(_Instrument):
    kind = "counter"

    def __init__(self, name, help="", labelnames=()):
        super().__init__(name, help, labelnames)
        self._values: Dict[LabelKey, float] = {}

    def inc(self, amount: float = 1.0, **labels) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        key = _label_key(self.labelnames, labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, **labels) -> float:
        return self._values.get(_label_key(self.labelnames, labels), 0.0)

    def expose(self) -> List[str]:
        lines = []
        for key, v in sorted(self._values.items()):
            lines.append(f"{self.name}{_render_labels(key)} {v:g}")
        return lines or [f"{self.name} 0"]

    def to_dict(self) -> Dict:
        return {"type": self.kind, "help": self.help,
                "values": {_render_labels(k) or "": v
                           for k, v in sorted(self._values.items())}}


class Gauge(_Instrument):
    kind = "gauge"

    def __init__(self, name, help="", labelnames=()):
        super().__init__(name, help, labelnames)
        self._values: Dict[LabelKey, float] = {}

    def set(self, value: float, **labels) -> None:
        key = _label_key(self.labelnames, labels)
        with self._lock:
            self._values[key] = float(value)

    def inc(self, amount: float = 1.0, **labels) -> None:
        key = _label_key(self.labelnames, labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, **labels) -> float:
        return self._values.get(_label_key(self.labelnames, labels), 0.0)

    def expose(self) -> List[str]:
        lines = []
        for key, v in sorted(self._values.items()):
            lines.append(f"{self.name}{_render_labels(key)} {v:g}")
        return lines or [f"{self.name} 0"]

    def to_dict(self) -> Dict:
        return {"type": self.kind, "help": self.help,
                "values": {_render_labels(k) or "": v
                           for k, v in sorted(self._values.items())}}


class Histogram(_Instrument):
    kind = "histogram"

    def __init__(self, name, help="", labelnames=(),
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        super().__init__(name, help, labelnames)
        self.buckets = tuple(sorted(buckets))
        if not self.buckets:
            raise ValueError("histogram needs at least one bucket bound")
        # per label-set: per-bucket (non-cumulative) counts + sum + count
        self._counts: Dict[LabelKey, List[int]] = {}
        self._sum: Dict[LabelKey, float] = {}
        self._n: Dict[LabelKey, int] = {}

    def observe(self, value: float, **labels) -> None:
        key = _label_key(self.labelnames, labels)
        with self._lock:
            counts = self._counts.setdefault(
                key, [0] * (len(self.buckets) + 1))
            for i, bound in enumerate(self.buckets):
                if value <= bound:
                    counts[i] += 1
                    break
            else:
                counts[-1] += 1  # the +Inf bucket
            self._sum[key] = self._sum.get(key, 0.0) + float(value)
            self._n[key] = self._n.get(key, 0) + 1

    def count(self, **labels) -> int:
        return self._n.get(_label_key(self.labelnames, labels), 0)

    def sum(self, **labels) -> float:
        return self._sum.get(_label_key(self.labelnames, labels), 0.0)

    def percentile(self, q: float, **labels) -> float:
        """Approximate ``q``-quantile (``q`` in [0, 1]) from the bucket
        bounds -- the Prometheus ``histogram_quantile`` estimate, server
        side. Returns the upper bound of the bucket holding the
        quantile observation (the last finite bound for the +Inf
        bucket -- a deliberate under-read, same as Prometheus), and 0.0
        with no observations."""
        if not (0.0 <= q <= 1.0):
            raise ValueError(f"q must lie in [0, 1], got {q}")
        key = _label_key(self.labelnames, labels)
        n = self._n.get(key, 0)
        if n == 0:
            return 0.0
        rank = q * n
        cum = 0
        for bound, c in zip(self.buckets, self._counts[key]):
            cum += c
            if cum >= rank:
                return float(bound)
        return float(self.buckets[-1])

    def expose(self) -> List[str]:
        lines = []
        for key in sorted(self._counts):
            cum = 0
            for bound, c in zip(self.buckets, self._counts[key]):
                cum += c
                le = 'le="%g"' % bound
                lines.append(
                    f"{self.name}_bucket{_render_labels(key, le)} {cum}")
            cum += self._counts[key][-1]
            inf = 'le="+Inf"'
            lines.append(
                f"{self.name}_bucket{_render_labels(key, inf)} {cum}")
            lines.append(
                f"{self.name}_sum{_render_labels(key)} {self._sum[key]:g}")
            lines.append(f"{self.name}_count{_render_labels(key)} {cum}")
        return lines or [f"{self.name}_count 0"]

    def to_dict(self) -> Dict:
        out = {"type": self.kind, "help": self.help,
               "buckets": list(self.buckets), "values": {}}
        for key in sorted(self._counts):
            out["values"][_render_labels(key) or ""] = {
                "counts": list(self._counts[key]),
                "sum": self._sum[key],
                "count": self._n[key]}
        return out


class MetricsRegistry:
    """Owns instruments; idempotent by name (re-registration returns the
    existing instrument, mismatched kind raises)."""

    def __init__(self):
        self._instruments: Dict[str, _Instrument] = {}
        self._lock = threading.Lock()

    def _get_or_make(self, cls, name, help, labelnames, **kw) -> _Instrument:
        with self._lock:
            inst = self._instruments.get(name)
            if inst is not None:
                if not isinstance(inst, cls):
                    raise ValueError(
                        f"metric {name!r} already registered as {inst.kind}")
                return inst
            inst = cls(name, help=help, labelnames=labelnames, **kw)
            self._instruments[name] = inst
            return inst

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> Counter:
        return self._get_or_make(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._get_or_make(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_make(Histogram, name, help, labelnames,
                                 buckets=buckets)

    def get(self, name: str) -> Optional[_Instrument]:
        return self._instruments.get(name)

    # -- expositions -------------------------------------------------------

    def to_prometheus(self) -> str:
        """Prometheus text exposition (format version 0.0.4)."""
        lines: List[str] = []
        for name in sorted(self._instruments):
            inst = self._instruments[name]
            if inst.help:
                lines.append(f"# HELP {name} {inst.help}")
            lines.append(f"# TYPE {name} {inst.kind}")
            lines.extend(inst.expose())
        return "\n".join(lines) + "\n"

    def to_dict(self) -> Dict:
        """JSON-able snapshot of every instrument."""
        return {name: inst.to_dict()
                for name, inst in sorted(self._instruments.items())}


_DEFAULT = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-wide default registry (CLIs; servers make their own)."""
    return _DEFAULT
