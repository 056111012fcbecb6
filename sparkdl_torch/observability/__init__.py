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
* :mod:`~sparkdl_torch.observability.metrics` — step meters,
  percentiles, FLOP counts of a step and the card's peak, and their
  roll-up across hosts;
* :mod:`~sparkdl_torch.observability.profiling` — ``torch.profiler``
  trace capture (a context manager and a localhost trace server) and
  host stack sampling (``SPARKDL_TORCH_PROFILE=1``);
* :mod:`~sparkdl_torch.observability.flight` — the flight recorder and
  the ``/healthz`` aggregation;
* :mod:`~sparkdl_torch.observability.slo` — declared latency /
  availability objectives with rolling error-budget burn.

* :mod:`~sparkdl_torch.observability.health` — the device/collective
  health probe (:func:`check_health`; each ``TorchRunner`` rank runs
  :func:`~sparkdl_torch.observability.health.preflight`).

* :mod:`~sparkdl_torch.observability.fleet` — the fleet plane:
  :class:`~sparkdl_torch.observability.fleet.FleetScraper` polls every
  fabric host, stitches one request's spans across hosts onto one
  skew-corrected timeline, and :class:`~sparkdl_torch.observability.
  fleet.FleetServer` serves ``/fleet/*`` over HTTP.
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
from sparkdl_torch.observability.health import HealthReport, check_health
from sparkdl_torch.observability.metrics import (
    StepMeter,
    aggregate_across_hosts,
    compiled_flops,
    device_peak_flops,
    percentile,
)
from sparkdl_torch.observability.profiling import (
    StackProfile,
    annotate,
    maybe_profile,
    profile_block,
    start_trace_server,
    trace,
)
from sparkdl_torch.observability.registry import (
    MetricsRegistry,
    registry,
    snapshot_across_hosts,
)
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
    "HealthReport",
    "MetricsRegistry",
    "MetricsServer",
    "PeriodicLogEmitter",
    "SLO",
    "SLOTracker",
    "StackProfile",
    "StepMeter",
    "aggregate_across_hosts",
    "annotate",
    "attach",
    "check_health",
    "compiled_flops",
    "current_context",
    "device_peak_flops",
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
    "snapshot_across_hosts",
    "span",
    "spans_for_trace",
    "start_trace_server",
    "trace",
    "tracing_enabled",
    "trigger_dump",
]
