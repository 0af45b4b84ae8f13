"""Tracing hooks: named scopes in the tick loop, profiler spans on the host.

Counterpart of ``repro.obs.tracing``, on ``torch.profiler``:

* :func:`trace_scope` -- ``torch.profiler.record_function``: labels the ops
  of a region, so a profiler trace reads ``tick/event/topk`` instead of a
  list of kernels. A record costs a few microseconds even with no profiler
  running, so the tick loop asks :func:`profiling` once per rollout and
  opens no scope when it is False.

* :func:`span` -- ``record_function`` around a host region (a wave), with
  the elapsed seconds optionally observed into a
  :class:`~repro_torch.obs.metrics.Histogram`.

* :func:`profile` -- capture a ``torch.profiler`` trace into a directory (the
  serve CLI's ``--profile``) as a Chrome trace. A no-op when the directory
  is None; a failure to start or stop the profiler is logged, never raised.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch

from repro_torch.obs.log import log_event


def profiling() -> bool:
    """Whether a ``torch.profiler`` (or autograd profiler) is recording."""
    return torch.autograd._profiler_enabled()


def trace_scope(name: str, enabled: bool = True):
    """Label the ops of a region (``with trace_scope("tick/event"): ...``);
    ``enabled=False`` opens nothing."""
    return torch.profiler.record_function(name) if enabled else contextlib.nullcontext()


@contextlib.contextmanager
def span(name: str, histogram=None, **labels) -> Iterator[None]:
    """Host wall-time span: a profiler record plus an optional histogram sink.

    Args:
      histogram: optional :class:`repro_torch.obs.metrics.Histogram`; the
        span's elapsed seconds are observed into it with ``labels``.
    """
    t0 = time.perf_counter()
    with torch.profiler.record_function(name):
        try:
            yield
        finally:
            if histogram is not None:
                histogram.observe(time.perf_counter() - t0, **labels)


@contextlib.contextmanager
def profile(outdir: Optional[str]) -> Iterator[None]:
    """Capture a ``torch.profiler`` trace into ``outdir``/``trace.json``
    (None -> no-op): host activity, and the card's when one is visible.

    A failure to start or to stop and export (a directory that cannot be
    made, a sandbox without the profiler's backend) is logged as
    ``profile_failed`` and swallowed, so a profiling flag never takes down a
    serving run."""
    if not outdir:
        yield
        return
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    try:
        os.makedirs(outdir, exist_ok=True)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
    except Exception as e:  # noqa: BLE001 -- observability must not crash serving
        log_event("profile_failed", outdir=outdir, error=repr(e))
        yield
        return
    try:
        yield
    finally:
        try:
            prof.__exit__(None, None, None)
            prof.export_chrome_trace(os.path.join(outdir, "trace.json"))
            log_event("profile_captured", outdir=outdir)
        except Exception as e:  # noqa: BLE001
            log_event("profile_failed", outdir=outdir, error=repr(e))
