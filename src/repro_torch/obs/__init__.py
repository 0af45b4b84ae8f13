"""Observability: on-device tick telemetry + host-side metrics, log, tracing.

Counterpart of ``repro.obs``, in two tiers:

* **on the device**: :class:`~repro_torch.obs.telemetry.TickTelemetry`,
  accumulators the :class:`~repro_torch.core.engine.TickEngine` carries
  through the tick loop when its ``telemetry=True`` option is set, folded
  in by one launch of the telemetry kernel per tick
  (:mod:`repro_torch.kernels.telemetry`) with no host sync; per slot on a
  slot axis; nothing when off.

* **on the host**: the dependency-free metrics registry
  (:mod:`repro_torch.obs.metrics`: counters, gauges, histograms with a
  Prometheus text exposition and a JSON dump), structured event logging
  (:mod:`repro_torch.obs.log`) -- both copied byte for byte from the
  reference, which imports no JAX there -- and tracing helpers
  (:mod:`repro_torch.obs.tracing`: ``torch.profiler`` scopes in the tick
  loop, and :class:`~repro_torch.obs.tracing.span`, the host timing of the
  serving loop's stages, which also records each span on the profiler's
  clock while a profiler runs). The serve CLI's ``--profile`` goes through
  :func:`repro_torch.launch.serve.device_profile`.
"""
from repro_torch.obs.log import EventLog, get_event_log, log_event  # noqa: F401
from repro_torch.obs.metrics import (  # noqa: F401
    Counter, Gauge, Histogram, MetricsRegistry, get_registry,
)
from repro_torch.obs.telemetry import TickTelemetry  # noqa: F401
from repro_torch.obs.tracing import get_span_log, span, trace_scope  # noqa: F401
