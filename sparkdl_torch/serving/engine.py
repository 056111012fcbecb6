"""ServingEngine — the async front door over queue + micro-batcher.

One object to construct, one method to call::

    engine = ServingEngine(
        BatchedRunner(apply_fn, batch_size=64), max_wait_s=0.004
    )
    fut = engine.submit({"x": row})          # returns immediately
    y = fut.result(timeout=1.0)              # one output row

Requests coalesce into bucketed device batches (each one the runner's
CUDA-graph replay of its bucket on the card, on the runner's device);
overload rejects at admission (QueueFullError), deadlines
cancel mid-queue (DeadlineExceededError), and ``close(drain=True)``
serves every admitted request before stopping.

Observability: every submit allocates a request id
(``fut.request_id``); with ``SPARKDL_TORCH_TRACE=1`` the request's full
span set replays via :meth:`ServingEngine.trace`. Pass ``slo=`` to
declare latency/availability objectives — rolling error-budget burn then
rides ``snapshot()["slo"]``, the ``sparkdl_slo_*`` gauges, and the
exporter's ``/slo.json``. The engine also registers itself with the
flight recorder, so reliability-triggered postmortem bundles carry its
queue state and in-flight request traces.
"""

from __future__ import annotations

from concurrent.futures import Future
from typing import Any, Callable

import numpy as np

from sparkdl_torch.observability import slo as slo_mod
from sparkdl_torch.observability import tracing
from sparkdl_torch.observability.exporters import maybe_start_metrics_server
from sparkdl_torch.serving import tenancy
from sparkdl_torch.serving.metrics import EngineObservability, ServingMetrics
from sparkdl_torch.serving.microbatcher import MicroBatcher
from sparkdl_torch.serving.queue import RequestQueue
from sparkdl_torch.transformers._inference import BatchedRunner


class ServingEngine:
    """Online micro-batching inference over a :class:`BatchedRunner`, a
    :class:`~sparkdl_torch.serving.replicas.ReplicaPool`, or anything
    with their ``run_batch``/``run_batch_async``/``chunk_size`` surface.

    ``max_wait_s`` bounds the extra latency the FIRST request of a batch
    pays to pick up riders; ``max_queue_depth`` bounds host memory and
    turns overload into fast rejects instead of unbounded tail latency.
    ``slo`` (an :class:`~sparkdl_torch.observability.slo.SLO`) declares
    this engine's objectives; the tracker it creates lives on
    ``self.slo_tracker`` and is unregistered at close.
    """

    def __init__(self, runner: "BatchedRunner | Any", *,
                 max_queue_depth: int = 256,
                 max_wait_s: float = 0.005,
                 extract: Callable[[Any], dict[str, np.ndarray]] | None = None,
                 metrics: ServingMetrics | None = None,
                 slo: "slo_mod.SLO | None" = None,
                 tenants: "tenancy.TenantRegistry | None" = None,
                 host_id: "str | None" = None):
        from sparkdl_torch.serving.metrics import default_host_id

        # Opt-in observability endpoint (SPARKDL_TORCH_METRICS_PORT):
        # idempotent, so every engine in the process shares one server.
        maybe_start_metrics_server()
        self.runner = runner
        #: stable host identity for the fabric's router tier
        self.host_id = host_id if host_id is not None else default_host_id()
        self.queue = RequestQueue(max_depth=max_queue_depth,
                                  tenants=tenants)
        self.metrics = metrics if metrics is not None else ServingMetrics()
        self.batcher = MicroBatcher(
            self.queue, runner, max_wait_s=max_wait_s, extract=extract,
            metrics=self.metrics,
        ).start()
        # process-wide registrations go LAST: a constructor failure above
        # must not leak a tracker/provider bound to a half-built engine
        self._obs = EngineObservability(
            "engine", self._flight_context, slo=slo,
            max_queue_depth=max_queue_depth,
        )
        self.slo_tracker = self._obs.tracker

    def submit(self, payload: Any, *,
               timeout_s: float | None = None,
               tenant: str = "default",
               priority: "int | None" = None) -> Future:
        """Admit one request (a feature dict of per-row arrays, or
        whatever ``extract`` eats). Returns a Future resolving to the
        output row (carrying ``request_id``); raises QueueFullError /
        EngineClosedError at the door. ``tenant``/``priority`` scope the
        request for quota and class scheduling (the defaults
        reproduce the single-user path) — over-quota and brownout sheds
        raise the typed :mod:`~sparkdl_torch.serving.tenancy` errors."""
        return self.queue.submit(payload, timeout_s=timeout_s,
                                 tenant=tenant, priority=priority)

    def trace(self, request_id: int) -> "list[dict]":
        """Every finished span of one request's trace (queue wait, batch
        assembly/dispatch via links, replica execution, the terminal
        ``serving.request``), timestamp-ordered. Empty with tracing off —
        enable with ``SPARKDL_TORCH_TRACE=1`` or
        :func:`~sparkdl_torch.observability.tracing.enable_tracing`.
        Export for Perfetto with
        ``tracing.export_chrome_trace(path, trace_id=request_id)``."""
        return tracing.spans_for_trace(request_id)

    def inflight_request_ids(self) -> "list[int]":
        """Ids of every admitted-but-unresolved request (queued +
        dispatched) — what a postmortem bundle resolves to traces."""
        return (self.queue.pending_request_ids()
                + self.batcher.inflight_request_ids())

    def begin_drain(self):
        """Graceful host drain, phase one: stop admission and
        hand back every accepted-but-undispatched request (the fabric
        re-queues them to surviving hosts via ``RequestQueue.requeue``
        on the target — Futures, trace ids, and deadlines untouched).
        Batches already dispatched finish here; :meth:`close` afterwards
        completes the drain."""
        from sparkdl_torch.observability import flight

        self.queue.close()
        reqs = self.queue.extract_pending()
        flight.record_event(
            "engine.drain_begin", engine=self._obs.name,
            host=self.host_id, extracted=len(reqs))
        return reqs

    def capacity(self, _pool_snap: "dict | None" = None) -> dict:
        """The one structure a router's weighting reads:
        identity + room. ``n_slots``/KV fields are None — this engine
        has no persistent decode slots or block pool; its weight is its
        replica count. ``_pool_snap`` lets :meth:`snapshot` share the
        pool snapshot it already fetched (walking per-replica state
        twice per router poll would be pure waste)."""
        if _pool_snap is None:
            pool_snapshot = getattr(self.runner, "snapshot", None)
            _pool_snap = (pool_snapshot()
                          if callable(pool_snapshot) else {})
        replicas = _pool_snap.get("replica_count", 1)
        return {
            "host_id": self.host_id,
            "replica_count": replicas,
            "n_slots": None,
            "free_slots": None,
            "kv_blocks_free": None,
            "kv_blocks_total": None,
            "queue_depth": self.queue.depth,
            "max_queue_depth": self.queue.max_depth,
            "draining": self.queue.closed,
            "overload_level": tenancy.overload_level(),
        }

    def prefix_digest(self, max_entries: int = 1024) -> "dict | None":
        """No prefix cache on the micro-batching engine: routing to it
        is pure load balancing (the fabric's digest surface is uniform
        across host kinds, so the router never special-cases)."""
        return None

    def close(self, *, drain: bool = True,
              timeout_s: float | None = 30.0) -> None:
        self.batcher.shutdown(drain=drain, timeout_s=timeout_s)
        self._obs.close(drain=drain)

    def _flight_context(self) -> dict:
        """The engine's contribution to flight-recorder postmortems."""
        out = self.metrics.snapshot(self.queue)
        out["inflight_request_ids"] = self.inflight_request_ids()
        if self.slo_tracker is not None:
            out["slo"] = self.slo_tracker.sample()
        return out

    def snapshot(self) -> dict:
        """Operator metrics: queue depth, occupancy, latency p50/p95/p99,
        admission counters — plus per-replica depth/in-flight/quarantine
        state when the runner is a ReplicaPool, the process-wide
        shed-load breakdown (``requests_failed_by_reason``, from the
        reliability layer's ``sparkdl_requests_failed_total`` counter),
        and rolling SLO compliance/burn under ``slo`` when objectives
        were declared."""
        snap = self.metrics.snapshot(self.queue)
        snap["host_id"] = self.host_id
        pool_snapshot = getattr(self.runner, "snapshot", None)
        pool_snap = pool_snapshot() if callable(pool_snapshot) else None
        snap["capacity"] = self.capacity(_pool_snap=pool_snap or {})
        if pool_snap is not None:
            snap.update(pool_snap)
        else:
            snap["replica_count"] = 1
        from sparkdl_torch.observability.registry import registry

        fam = registry().get("sparkdl_requests_failed_total")
        snap["requests_failed_by_reason"] = (
            fam.labelled_values("reason") if fam else {}
        )
        snap["slo"] = (self.slo_tracker.sample()
                       if self.slo_tracker is not None else None)
        return snap

    def __enter__(self) -> "ServingEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close(drain=exc == (None, None, None))

