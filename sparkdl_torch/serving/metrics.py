"""Serving observability: queue depth, batch occupancy, latency tails.

Built on :mod:`sparkdl_torch.observability.metrics` — per-request latency
rides a :class:`StepMeter` window so the p50/p95/p99 helpers are the SAME
code that meters training steps (one percentile implementation in the
whole stack), and counters mirror the queue's admission bookkeeping.
"""

from __future__ import annotations

import os
import socket
import threading
from typing import Any

from sparkdl_torch.observability import flight
from sparkdl_torch.observability import slo as slo_mod
from sparkdl_torch.observability.metrics import StepMeter
from sparkdl_torch.observability.registry import PERCENT_BUCKETS, registry

# The registry spine's view of every ServingMetrics instance in the
# process (engines aggregate; per-engine detail stays on snapshot()).
_M_REQS = registry().counter(
    "sparkdl_serving_requests_total", "finished requests by outcome",
    labels=("outcome",))
_M_REQ_OK = _M_REQS.labels(outcome="completed")
_M_REQ_FAIL = _M_REQS.labels(outcome="failed")
_M_LATENCY = registry().histogram(
    "sparkdl_serving_latency_seconds", "request latency, submit to result")
_M_BATCHES = registry().counter(
    "sparkdl_serving_batches_total", "device dispatches")
_M_OCCUPANCY = registry().histogram(
    "sparkdl_serving_batch_occupancy_pct",
    "live rows per dispatch as % of capacity", buckets=PERCENT_BUCKETS)


def default_host_id() -> str:
    """The stable id a serving engine publishes in ``snapshot()`` so a
    router tier can address this host. Operators pin it via
    ``SPARKDL_TORCH_HOST_ID`` (a k8s pod name, an instance id); the
    default ``hostname:pid`` is unique per serving process, which is
    what the fabric's in-process test hosts and single-host deployments
    need. Engines may also take ``host_id=`` directly (how several
    in-process hosts in one test process stay distinct)."""
    env = os.environ.get("SPARKDL_TORCH_HOST_ID")
    return env if env else f"{socket.gethostname()}:{os.getpid()}"


class EngineObservability:
    """The process-wide registrations every serving engine shares
   : an optional SLO tracker, a flight-recorder context
    provider, and engine.start/engine.close lifecycle events. One
    implementation so ServingEngine and ContinuousGPTEngine cannot
    drift. Construct LAST in the engine's ``__init__`` (a constructor
    failure must not leak registrations) and :meth:`close` on engine
    close (idempotent)."""

    def __init__(self, kind: str, context_fn, *,
                 slo: "slo_mod.SLO | None" = None, **start_fields):
        self.tracker = (
            slo_mod.register(slo_mod.SLOTracker(slo))
            if slo is not None else None
        )
        self.name = flight.add_context_provider(
            f"{kind}-{id(context_fn.__self__):x}", context_fn
        )
        self._closed = False
        flight.record_event("engine.start", engine=self.name,
                            **start_fields)

    def close(self, *, drain: bool = True) -> None:
        if self._closed:
            return
        self._closed = True
        flight.record_event("engine.close", engine=self.name, drain=drain)
        flight.remove_context_provider(self.name)
        if self.tracker is not None:
            slo_mod.unregister(self.tracker)


class ServingMetrics:
    """Thread-safe counters + windowed latency/occupancy for one engine.

    ``snapshot()`` is the structured dict an operator scrapes: admission
    (submitted/rejected/expired/cancelled, straight off the queue's own
    counters), outcomes (completed/failed), queue depth, mean
    batch-occupancy %, dispatch count, request latency p50/p95/p99
    (seconds, submit -> result) and, for generation engines, time to
    first token p50/p95/p99.
    """

    def __init__(self, window: int = 1024):
        self._lock = threading.Lock()
        # n_chips=1: latency is per request, not per chip; warmup 0 —
        # serving must count the compile-paying first requests too.
        self._latency = StepMeter(n_chips=1, window=window, warmup_steps=0)
        self._occupancy = StepMeter(n_chips=1, window=window, warmup_steps=0)
        #: time to first token (generation engines): submit -> the first
        #: generated token on the host
        self._ttft = StepMeter(n_chips=1, window=window, warmup_steps=0)
        self.completed = 0
        self.failed = 0
        self.batches = 0

    def record_request(self, latency_s: float, *, ok: bool) -> None:
        with self._lock:
            self._latency.record(latency_s, examples=1)
            if ok:
                self.completed += 1
            else:
                self.failed += 1
        _M_LATENCY.observe(latency_s)
        (_M_REQ_OK if ok else _M_REQ_FAIL).inc()

    def record_first_token(self, seconds: float) -> None:
        """A generation request's first token reached the host
        ``seconds`` after its submit."""
        with self._lock:
            self._ttft.record(seconds, examples=1)

    def record_batch(self, n_valid: int, capacity: int) -> None:
        """One device dispatch: ``n_valid`` live rows of ``capacity``
        (bucket size or slot count) — occupancy is what dynamic batching
        is buying over batch-of-1."""
        with self._lock:
            self.batches += 1
            if capacity > 0:
                self._occupancy.record(100.0 * n_valid / capacity,
                                       examples=n_valid)
        _M_BATCHES.inc()
        if capacity > 0:
            _M_OCCUPANCY.observe(100.0 * n_valid / capacity)

    def latency_percentiles(self) -> dict[str, float | None]:
        with self._lock:
            return self._latency.step_time_percentiles((50, 95, 99))

    def snapshot(self, queue=None) -> dict[str, Any]:
        """Point-in-time metrics dict; pass the engine's RequestQueue to
        include its depth and admission counters."""
        with self._lock:
            out: dict[str, Any] = {
                "completed": self.completed,
                "failed": self.failed,
                "batches": self.batches,
                "batch_occupancy_pct": self._occupancy.mean_step_time(),
                "latency_s": self._latency.step_time_percentiles((50, 95, 99)),
                "latency_mean_s": self._latency.mean_step_time(),
                "ttft_s": self._ttft.step_time_percentiles((50, 95, 99)),
            }
        if queue is not None:
            out.update(
                queue_depth=queue.depth,
                submitted=queue.submitted,
                rejected=queue.rejected,
                expired=queue.expired,
                cancelled=queue.cancelled,
            )
        return out
