"""Registry exporters: Prometheus HTTP endpoint and periodic logline.

Three ways out of :func:`sparkdl_torch.observability.registry.registry`:

* :class:`MetricsServer` — stdlib ``http.server`` serving the Prometheus
  text exposition on ``/metrics`` (and the JSON snapshot on
  ``/metrics.json``, SLO burn on ``/slo.json``, the reliability health
  aggregate on ``/healthz``, a live flight-recorder bundle on
  ``/debug/flight`` and one request's finished spans on
  ``/debug/trace/<request_id>``); opt-in per process via
  ``SPARKDL_TORCH_METRICS_PORT`` (:func:`maybe_start_metrics_server`), so
  a serving host becomes scrape-able with zero dependencies;
* ``registry().snapshot()`` — the JSON form benches embed in their
  artifacts (no exporter needed);
* :class:`PeriodicLogEmitter` — a daemon thread logging a compact
  snapshot line every N seconds, the "no scraper, just logs" fallback
  that still beats grepping executor stdout.
"""

from __future__ import annotations

import json
import logging
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from sparkdl_torch.observability.registry import MetricsRegistry, registry

__all__ = [
    "MetricsServer",
    "PeriodicLogEmitter",
    "maybe_start_metrics_server",
]

logger = logging.getLogger(__name__)

#: Environment knob: set to a port number to expose /metrics from this
#: process (0 = ephemeral port, logged at startup).
METRICS_PORT_ENV = "SPARKDL_TORCH_METRICS_PORT"

PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


class _Handler(BaseHTTPRequestHandler):
    registry: MetricsRegistry  # set by MetricsServer on the class copy

    def do_GET(self):  # noqa: N802 - BaseHTTPRequestHandler API
        path = self.path.split("?", 1)[0]
        status = 200
        try:
            if path in ("/metrics", "/"):
                self._refresh_slo_gauges()
                body = self.registry.to_prometheus().encode()
                ctype = PROMETHEUS_CONTENT_TYPE
            elif path == "/metrics.json":
                body = json.dumps(self.registry.snapshot()).encode()
                ctype = "application/json"
            elif path == "/slo.json":
                # every registered SLO tracker's rolling
                # compliance / error-budget burn, sampled at scrape time
                from sparkdl_torch.observability import slo

                body = json.dumps(
                    {"slos": slo.slo_report()}, default=repr).encode()
                ctype = "application/json"
            elif path == "/healthz":
                # aggregate reliability state for a router-tier health
                # check: 503 only when this host cannot serve at all
                from sparkdl_torch.observability import flight

                report = flight.healthz_report()
                status = 503 if report["status"] == "unhealthy" else 200
                body = json.dumps(report, default=repr).encode()
                ctype = "application/json"
            elif path == "/debug/flight":
                from sparkdl_torch.observability import flight

                body = json.dumps(
                    flight.flight_recorder().debug_view(),
                    default=repr).encode()
                ctype = "application/json"
            elif path.startswith("/debug/trace/"):
                # one request's finished spans from THIS
                # process's ring, keyed by request id (= trace id) —
                # the single-host half of fleet_trace()
                from sparkdl_torch.observability import tracing

                try:
                    rid = int(path.rsplit("/", 1)[1])
                except ValueError:
                    self.send_error(
                        400, "request id must be an integer")
                    return
                body = json.dumps({
                    "request_id": rid,
                    "host_hash": tracing.host_hash(),
                    "now_us": tracing.trace_clock_us(),
                    "spans": tracing.spans_for_trace(rid),
                }, default=repr).encode()
                ctype = "application/json"
            else:
                self.send_error(404)
                return
        except Exception:
            logger.exception("exporter: %s handler failed", path)
            self.send_error(500)
            return
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _refresh_slo_gauges(self):
        """Refresh sparkdl_slo_* gauges so a Prometheus scrape of
        /metrics sees current burn rates (trackers are pull-sampled)."""
        from sparkdl_torch.observability import slo

        slo.sample_all()

    def log_message(self, fmt, *args):  # scrapes must not spam stdout
        logger.debug("metrics scrape: " + fmt, *args)


class MetricsServer:
    """Serve the registry over HTTP from a daemon thread.

    >>> srv = MetricsServer(port=0)          # ephemeral port
    >>> urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/metrics")
    >>> srv.close()
    """

    def __init__(self, port: int = 0, host: str = "",
                 reg: "MetricsRegistry | None" = None):
        # per-instance handler subclass so two servers (tests) can carry
        # different registries
        handler = type("_BoundHandler", (_Handler,),
                       {"registry": reg if reg is not None else registry()})
        self._httpd = ThreadingHTTPServer((host, port), handler)
        self._httpd.daemon_threads = True
        self._closed = False
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, kwargs={"poll_interval": 0.2},
            name="sparkdl-metrics-http", daemon=True,
        )
        self._thread.start()

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def closed(self) -> bool:
        return self._closed

    def close(self) -> None:
        self._closed = True
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=2)

    def __enter__(self) -> "MetricsServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


_autostart_lock = threading.Lock()
_autostarted: "MetricsServer | None" = None


def maybe_start_metrics_server(port_offset: int = 0) -> "MetricsServer | None":
    """Start the process's /metrics endpoint iff ``SPARKDL_TORCH_METRICS_PORT``
    is set. Idempotent (one server per process) and never raises — a taken
    port logs a warning rather than failing the job it observes.

    ``port_offset`` is added to the configured port (0 stays 0: an
    ephemeral port needs no offset) — the per-rank spread worker
    preflights use so co-hosted ranks don't fight over one port, same
    convention as ``SPARKDL_TORCH_PROFILER_PORT + rank``."""
    global _autostarted
    port_s = os.environ.get(METRICS_PORT_ENV)
    if not port_s:
        return None
    with _autostart_lock:
        # a caller that close()d the shared server relinquishes it; the
        # next request starts a fresh one instead of returning a corpse
        if _autostarted is not None and not _autostarted.closed:
            return _autostarted
        try:
            port = int(port_s)
            _autostarted = MetricsServer(
                port=port + port_offset if port else 0
            )
        # OverflowError: int() accepts e.g. 99999 but bind() rejects
        # ports outside 0-65535 with OverflowError, not OSError
        except (OSError, OverflowError, ValueError) as e:
            logger.warning(
                "%s=%s: metrics endpoint not started (%s)",
                METRICS_PORT_ENV, port_s, e,
            )
            return None
        logger.info("serving /metrics on port %d", _autostarted.port)
        return _autostarted


class PeriodicLogEmitter:
    """Log a compact registry snapshot every ``interval_s`` seconds.

    One JSON object per line under the ``sparkdl_torch.metrics`` logger —
    greppable from Spark executor logs, which is exactly the observability
    floor the reference left us at (SURVEY.md §5), now structured.
    """

    def __init__(self, interval_s: float = 60.0,
                 log: "logging.Logger | None" = None,
                 reg: "MetricsRegistry | None" = None):
        if interval_s <= 0:
            raise ValueError(f"interval_s must be > 0, got {interval_s}")
        self.interval_s = interval_s
        self._log = log if log is not None else \
            logging.getLogger("sparkdl_torch.metrics")
        self._registry = reg if reg is not None else registry()
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, name="sparkdl-metrics-log", daemon=True
        )
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.emit()

    def emit(self) -> None:
        snap = self._registry.snapshot()
        if snap:
            self._log.info("metrics %s", json.dumps(snap, sort_keys=True))

    def close(self, *, final_emit: bool = True) -> None:
        self._stop.set()
        self._thread.join(timeout=2)
        if final_emit:
            self.emit()

    def __enter__(self) -> "PeriodicLogEmitter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
