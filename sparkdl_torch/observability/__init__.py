"""Observability spine of the port: the process-wide metrics registry
(``registry.py``), spans (``tracing.py``), the flight recorder
(``flight.py``), SLO trackers (``slo.py``) and the Prometheus exporter
(``exporters.py``), copied from ``sparkdl_tpu.observability`` (all are
framework-free), and the step meters (``metrics.py``, the part of the
reference's the serving layer uses). The reference's fleet, health and
JAX profiling modules are not ported yet.
"""
