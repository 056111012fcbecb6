"""Host abstraction: one serving host behind a uniform fabric surface.

A :class:`HostHandle` is what the :class:`~sparkdl_torch.fabric.router.Router`
routes over — the coordinator/worker split of distributed TensorFlow
(Abadi et al., arXiv 1603.04467) applied to the serving tier: the router
is the coordinator, each handle fronts one worker host running its own
engine, and the surface between them is deliberately small:

``submit(payload, timeout_s) -> Future``, ``snapshot()``, ``health()``,
``prefix_digest()``, ``drain()``, ``close()``.

Two implementations:

* :class:`InProcessHost` — wraps a live
  :class:`~sparkdl_torch.serving.continuous.ContinuousGPTEngine` or
  :class:`~sparkdl_torch.serving.engine.ServingEngine` in THIS process.
  What tests, the CPU harness, and ``chip_smoke.py``'s ``[fabric]``
  section use: N real engines, N real prefix caches, zero transport.
* :class:`~sparkdl_torch.fabric.http.HttpHostHandle` — the thin
  HTTP/json transport over :class:`~sparkdl_torch.fabric.http.HostServer`
  (the same stdlib-http machinery as the metrics exporter) for real
  multi-process deployments.

Error classes: :data:`HOST_LEVEL_ERRORS` is the *retry class* for
host-level failures — errors that indict the HOST, not the request
(engine shut down, transport dead, host draining), which the router
answers by re-routing the request to a surviving host. Anything else
(deadline exceeded, a bad prompt, a model error) is the request's own
outcome and passes through to the caller exactly once.
"""

from __future__ import annotations

import threading
from concurrent.futures import Future
from typing import Any

from sparkdl_torch.reliability.faults import fault_point
from sparkdl_torch.serving.queue import EngineClosedError, Request

__all__ = [
    "HOST_LEVEL_ERRORS",
    "HostDrainingError",
    "HostHandle",
    "HostUnavailableError",
    "InProcessHost",
]


class HostUnavailableError(RuntimeError):
    """The host cannot take work right now: transport dead, process
    gone, or the handle's circuit is open. Routes re-route on it."""


class HostDrainingError(RuntimeError):
    """The host is draining for a rolling restart: admission stopped,
    in-flight work finishing. A planned state — the router re-routes
    without counting a host failure."""


#: The host-level retry class: a Future failing with one of
#: these means the HOST lost the request, not that the request failed —
#: the router re-submits it to a surviving host. ConnectionError/OSError
#: cover the HTTP transport (urllib's URLError subclasses OSError).
HOST_LEVEL_ERRORS = (
    HostUnavailableError,
    HostDrainingError,
    EngineClosedError,
    ConnectionError,
    OSError,
)


class HostHandle:
    """The surface a fabric host exposes to the router (see module
    docstring). Subclass and implement; ``host_id`` must be stable for
    the handle's lifetime."""

    host_id: str

    def submit(self, payload: "dict[str, Any]", *,
               timeout_s: "float | None" = None) -> Future:
        raise NotImplementedError

    def snapshot(self) -> "dict[str, Any]":
        raise NotImplementedError

    def capacity(self) -> "dict[str, Any]":
        raise NotImplementedError

    def health(self) -> "dict[str, Any]":
        raise NotImplementedError

    def prefix_digest(self, max_entries: int = 1024) -> "dict | None":
        raise NotImplementedError

    def prefix_digest_delta(self, since_version: int,
                            max_entries: int = 1024) -> "dict | None":
        """Journal of block-hash adds/removes since ``since_version``
       , or None when the host cannot produce one (no
        journal, gap, dense layout) — the router then re-syncs with one
        wholesale :meth:`prefix_digest`. Defaulting to None keeps every
        pre-delta handle (and test fake) correct: they simply stay on
        the wholesale path."""
        return None

    def export_parked_sessions(self) -> "dict | None":
        """Serialize this host's parked sessions for migration
       ; None when the host has nothing to export or no
        tier store. Default None: migration quietly no-ops on hosts
        that cannot ship state, and those sessions re-prefill."""
        return None

    def import_parked_sessions(self, bundle: "dict | None") -> int:
        """Adopt migrated parked sessions; returns sessions adopted.
        Default 0: a host that cannot import simply lets the sessions
        re-prefill — the pre-migration cost, never an error."""
        return 0

    def trace(self, request_id: int) -> "dict[str, Any]":
        """This host's span fragments for one trace:
        ``{"host_id", "now_us", "spans"}``. ``now_us`` is the host's
        trace clock (µs since its process epoch) read while serving the
        call — the fleet scraper pairs it with the RPC round-trip
        midpoint to estimate this host's clock offset, so fragments
        from hosts with unrelated monotonic epochs stitch into one
        skew-corrected timeline."""
        raise NotImplementedError

    def drain(self) -> "list[Request]":
        """Stop admission; return the unstarted requests (in-process
        handles return live :class:`Request` objects for queue-level
        transfer; transports return [] and fail their blocked submits
        with :class:`HostDrainingError` so the router's failover path
        re-places them)."""
        raise NotImplementedError

    def close(self, *, timeout_s: "float | None" = 30.0) -> None:
        raise NotImplementedError


class InProcessHost(HostHandle):
    """A fabric host over an engine living in this process.

    ``payload`` for a :class:`ContinuousGPTEngine` host is
    ``{"prompt": <1-D int ids>, "max_new_tokens": n}``; for a
    :class:`ServingEngine` host it is whatever that engine's extract
    eats (the router treats it opaquely either way — only the GPT
    payload's ``prompt`` feeds affinity scoring).
    """

    def __init__(self, engine: Any, *, host_id: "str | None" = None):
        self.engine = engine
        self.host_id = (host_id if host_id is not None
                        else str(getattr(engine, "host_id", id(engine))))
        #: GPT engines take (prompt, max_new_tokens); micro-batching
        #: engines take the payload whole
        self._gpt = hasattr(engine, "kv_layout")
        self._drained = threading.Event()

    def submit(self, payload: "dict[str, Any]", *,
               timeout_s: "float | None" = None) -> Future:
        fault_point("host.submit")
        if self._drained.is_set():
            raise HostDrainingError(
                f"host {self.host_id} is draining; route elsewhere")
        if isinstance(payload, dict) and "handoff" in payload:
            # cross-tier KV handoff: the decode-tier
            # admission path — installed blocks, no re-prefill
            return self.engine.submit_handoff(
                payload["handoff"], timeout_s=timeout_s)
        if self._gpt:
            # tenant/priority ride the payload only when the submitter
            # set them: an absent key leaves the engine's
            # defaults untouched — the bitwise single-user path
            extra = {k: payload[k] for k in ("tenant", "priority")
                     if payload.get(k) is not None}
            return self.engine.submit(
                payload["prompt"], payload["max_new_tokens"],
                timeout_s=timeout_s, **extra)
        return self.engine.submit(payload, timeout_s=timeout_s)

    def snapshot(self) -> "dict[str, Any]":
        return self.engine.snapshot()

    def capacity(self) -> "dict[str, Any]":
        return self.engine.capacity()

    def health(self) -> "dict[str, Any]":
        """Host-local health, shaped like one host's slice of
        ``healthz_report()``: ``unhealthy`` when the engine loop died or
        every replica is quarantined, ``degraded`` on a KV exhaustion
        streak, else ``ok``. (The process-wide ``/healthz`` aggregates
        across every engine in the process, which is the wrong grain
        when several in-process hosts share one process — tests do.)"""
        status = "ok"
        snap = self.engine.snapshot()
        kv = snap.get("kv") or {}
        if kv.get("exhausted_streak"):
            status = "degraded"
        total = snap.get("replica_count")
        healthy = snap.get("healthy_count")
        if healthy == 0 and total:
            status = "unhealthy"
        thread = getattr(self.engine, "_thread", None)
        if (thread is not None and not thread.is_alive()
                and not self.engine.queue.closed):
            # the loop crashed (close() would have closed the queue):
            # this host serves nothing until restarted
            status = "unhealthy"
        return {"status": status, "host_id": self.host_id,
                "draining": self._drained.is_set()}

    def prefix_digest(self, max_entries: int = 1024) -> "dict | None":
        fn = getattr(self.engine, "prefix_digest", None)
        return fn(max_entries) if callable(fn) else None

    def prefix_digest_delta(self, since_version: int,
                            max_entries: int = 1024) -> "dict | None":
        fn = getattr(self.engine, "prefix_digest_delta", None)
        return (fn(since_version, max_entries) if callable(fn)
                else None)

    def export_parked_sessions(self) -> "dict | None":
        fn = getattr(self.engine, "export_parked_sessions", None)
        return fn() if callable(fn) else None

    def import_parked_sessions(self, bundle: "dict | None") -> int:
        fn = getattr(self.engine, "import_parked_sessions", None)
        return int(fn(bundle)) if callable(fn) else 0

    def trace(self, request_id: int) -> "dict[str, Any]":
        from sparkdl_torch.observability import tracing
        fn = getattr(self.engine, "trace", None)
        spans = (fn(int(request_id)) if callable(fn)
                 else tracing.spans_for_trace(int(request_id)))
        return {"host_id": self.host_id,
                "now_us": tracing.trace_clock_us(),
                "spans": spans}

    def drain(self) -> "list[Request]":
        fault_point("host.drain")
        self._drained.set()
        return self.engine.begin_drain()

    @property
    def draining(self) -> bool:
        return self._drained.is_set()

    def reopen(self) -> None:
        """Reverse :meth:`drain`: a drained handle parked on
        ``AutoScaler.spare_hosts`` re-enters service — the engine's
        queue reopens (and its loop restarts if it exited on graceful
        drain) before the handle rejoins a ``Router.add_host``."""
        fn = getattr(self.engine, "reopen", None)
        if callable(fn):
            fn()
        else:
            self.engine.queue.reopen()
        self._drained.clear()

    def requeue(self, requests: "list[Request]") -> None:
        """Adopt requests extracted from ANOTHER host's queue (the
        drain hand-off): queue-level transfer, Futures and trace ids
        intact — see ``RequestQueue.requeue``."""
        self.engine.queue.requeue(requests)

    def close(self, *, timeout_s: "float | None" = 30.0) -> None:
        self.engine.close(drain=True, timeout_s=timeout_s)
