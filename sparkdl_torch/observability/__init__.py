"""Observability spine of the port, copied from
``sparkdl_tpu.observability`` (all framework-free) where the reference
needs no JAX:

* :mod:`~sparkdl_torch.observability.registry` — the process-wide
  :func:`registry` of counters / gauges / bucketed histograms;
* :mod:`~sparkdl_torch.observability.exporters` — the Prometheus
  ``/metrics`` endpoint (``SPARKDL_TORCH_METRICS_PORT``) and a periodic
  logline emitter;
* :mod:`~sparkdl_torch.observability.tracing` — request/step spans with
  contextvar propagation and Chrome ``trace_event`` export;
* :mod:`~sparkdl_torch.observability.metrics` — step meters and
  percentiles (the part of the reference's the serving layer uses);
* :mod:`~sparkdl_torch.observability.profiling` — ``torch.profiler``
  trace capture (a context manager and a localhost trace server) and
  host stack sampling (``SPARKDL_TORCH_PROFILE=1``);
* :mod:`~sparkdl_torch.observability.flight` — the flight recorder and
  the ``/healthz`` aggregation;
* :mod:`~sparkdl_torch.observability.slo` — declared latency /
  availability objectives with rolling error-budget burn.

The reference's fleet roll-ups and the pre-training health probe are
ROADMAP A8.
"""

from sparkdl_torch.observability.exporters import (
    MetricsServer,
    PeriodicLogEmitter,
    maybe_start_metrics_server,
)
from sparkdl_torch.observability.flight import (
    FlightRecorder,
    flight_recorder,
    healthz_report,
    record_event,
    trigger_dump,
)
from sparkdl_torch.observability.metrics import StepMeter, percentile
from sparkdl_torch.observability.profiling import (
    StackProfile,
    annotate,
    maybe_profile,
    profile_block,
    start_trace_server,
    trace,
)
from sparkdl_torch.observability.registry import MetricsRegistry, registry
from sparkdl_torch.observability.slo import SLO, SLOTracker, slo_report
from sparkdl_torch.observability.tracing import (
    attach,
    current_context,
    disable_tracing,
    enable_tracing,
    export_chrome_trace,
    record_span,
    span,
    spans_for_trace,
    tracing_enabled,
)

__all__ = [
    "FlightRecorder",
    "MetricsRegistry",
    "MetricsServer",
    "PeriodicLogEmitter",
    "SLO",
    "SLOTracker",
    "StackProfile",
    "StepMeter",
    "annotate",
    "attach",
    "current_context",
    "disable_tracing",
    "enable_tracing",
    "export_chrome_trace",
    "flight_recorder",
    "healthz_report",
    "maybe_profile",
    "maybe_start_metrics_server",
    "percentile",
    "profile_block",
    "record_event",
    "record_span",
    "registry",
    "slo_report",
    "span",
    "spans_for_trace",
    "start_trace_server",
    "trace",
    "tracing_enabled",
]
