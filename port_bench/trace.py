"""The traced window: ``torch.profiler`` around it, reduced to device busy
time, device operations by name and idle gaps by what the host was doing.

A copy of ``repro_torch.launch.serve.device_profile``'s reduction (device
events only, the wave, chunk and tick annotations left out by name), with
two changes: busy time is the union of the device intervals, and a trace in
which the profiler recorded no device activity is a failure, never an idle
share of 1.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Tuple

import numpy as np

# Annotations that the profiler also lays on the device timeline: the
# program's (``snn/...`` spans, ``tick/...`` scopes) and the harness's.
ANNOTATIONS = ("snn/", "tick/", "bench/")
WINDOW = "bench/window"
TOP = 10
NAME = 160   # characters of a kernel's name kept in the breakdown


class NoDeviceActivity(RuntimeError):
    """The profiler recorded no operation on the device."""


@dataclasses.dataclass
class Trace:
    window_s: float                        # the traced window's wall time
    busy_s: float                          # union of device operations
    ops: Dict[str, Tuple[float, int]]      # device seconds and count, by name
    idle_gaps: List[Tuple[str, float]]     # idle seconds by host activity
    events: int                            # device operations in the window

    def seconds_of(self, match: Callable[[str], bool]) -> float:
        return sum(s for name, (s, _) in self.ops.items() if match(name))

    def breakdown(self) -> dict:
        top = sorted(self.ops.items(), key=lambda kv: -kv[1][0])[:TOP]
        return {"device_ops": [[k[:NAME], v[0]] for k, v in top],
                "idle_gaps": [[k, s] for k, s in self.idle_gaps[:TOP]]}


def traced(fn: Callable[[], object]):
    """Run ``fn()`` under the profiler on the card; returns ``(its result, Trace)``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        with record_function(WINDOW):
            out = fn()
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev, host, window = [], [], None
    for name, on_device, start, end in _events(prof, DeviceType.CUDA):
        if on_device:
            if not name.startswith(ANNOTATIONS):
                dev.append((start, end, name))
        elif name == WINDOW:
            window = (start, end)
        else:
            host.append((start, end, name))
    if not dev:
        raise NoDeviceActivity("the profiler recorded no device activity in the window")
    return out, reduce(dev, host, window, wall)


def _events(prof, cuda):
    """``(name, on the device, start us, end us)`` of every recorded event,
    read from the profiler's raw results (building its event tree with
    ``events()`` takes seventeen times as long)."""
    for e in prof.profiler.kineto_results.events():
        yield e.name(), e.device_type() == cuda, e.start_ns() / 1e3, e.end_ns() / 1e3


def reduce(dev, host, window, wall: float) -> Trace:
    """Busy time, operations by name and the idle gaps of a window, from
    ``(start_us, end_us, name)`` device and host events."""
    ops: Dict[str, Tuple[float, int]] = {}
    for s, e, name in dev:
        sec, cnt = ops.get(name, (0.0, 0))
        ops[name] = (sec + (e - s) / 1e6, cnt + 1)
    iv = np.array(sorted((s, e) for s, e, _ in dev), dtype=np.float64)
    lo = window[0] if window else iv[0, 0]
    hi = window[1] if window else iv[:, 1].max()
    merged = []
    for s, e in iv:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    busy = sum(e - s for s, e in merged) / 1e6
    edges = [lo] + [x for se in merged for x in se] + [hi]
    gaps = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    return Trace(window_s=wall, busy_s=busy, ops=ops,
                 idle_gaps=_by_host(gaps, host), events=len(dev))


def _by_host(gaps, host, longest: int = 400) -> List[Tuple[str, float]]:
    """Idle seconds by what the host was doing at each gap's middle (the
    innermost host event there, under the innermost annotation; ``python``
    where no profiled op ran), for the ``longest`` gaps; largest first."""
    if not gaps or not host:
        return []
    hs = np.array([h[0] for h in host], dtype=np.float64)
    he = np.array([h[1] for h in host], dtype=np.float64)
    names = [h[2] for h in host]
    scope = np.array([n.startswith(ANNOTATIONS) for n in names])
    out: Dict[str, float] = {}
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:longest]:
        mid = (a + b) / 2
        inside = np.flatnonzero((hs <= mid) & (he >= mid))
        label = "python"   # no profiled op: the host was in Python
        if inside.size:
            dur = he[inside] - hs[inside]
            inner = names[inside[dur.argmin()]]
            scopes = inside[scope[inside]]
            outer = names[scopes[(he[scopes] - hs[scopes]).argmin()]] if scopes.size else ""
            label = f"{outer} > {inner}" if outer and outer != inner else inner
        out[label] = out.get(label, 0.0) + (b - a) / 1e6
    return sorted(out.items(), key=lambda kv: -kv[1])
