"""Observability spine of the port: the process-wide metrics registry
(``registry.py``), spans (``tracing.py``) and the flight recorder
(``flight.py``), copied from ``sparkdl_tpu.observability`` (all three are
framework-free). The reference's exporters, SLOs and JAX profiling are
not ported yet.
"""
