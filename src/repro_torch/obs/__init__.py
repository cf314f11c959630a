"""Telemetry plane of the port: span tracer, metrics, device annotations.

  * :mod:`repro_torch.obs.trace`   — thread-safe span tracer; Chrome
    trace-event (Perfetto) + JSONL export; near-zero-cost when disabled.
  * :mod:`repro_torch.obs.metrics` — counters / gauges / latency histograms.
  * :mod:`repro_torch.obs.device`  — ``torch.profiler.record_function`` and
    NVTX ranges that put solver semantics on device timelines, and spans
    that sync the device so a stage's device work is charged to it.
"""
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,  # noqa: F401
                                     Metrics, get_metrics)
from repro_torch.obs.trace import (NOOP_SPAN, Tracer,  # noqa: F401
                                   disable_tracing, enable_tracing,
                                   get_tracer, span)

__all__ = [
    "Counter", "Gauge", "Histogram", "Metrics", "get_metrics",
    "NOOP_SPAN", "Tracer", "get_tracer", "span",
    "enable_tracing", "disable_tracing",
]
