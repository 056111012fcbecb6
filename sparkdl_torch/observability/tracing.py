"""Span-based request/step tracing with Chrome ``trace_event`` export.

The timeline view the TensorFlow system paper models (PAPERS.md): every
stage of the online path — queue wait, micro-batch assembly, device step —
and the batch path — ingest, prefetch, run_batch — is a ``span`` whose
wall time lands both in a Chrome/Perfetto-loadable JSON trace (open it in
ui.perfetto.dev next to a ``torch.profiler`` trace) and in the
``sparkdl_stage_seconds`` histogram of the metrics registry, so per-stage
p50/p95/p99 come for free wherever tracing is on.

Disabled by default: ``span()`` then returns a shared no-op context
manager (< 1µs per use — guarded by a test) so the serving hot loop pays
nothing. Enable with ``SPARKDL_TORCH_TRACE=1`` in the environment or
:func:`enable_tracing` in code.

Cross-thread propagation: parentage rides a :mod:`contextvars` var inside
a thread; across threads (a submitting caller → the MicroBatcher worker)
the producer captures :func:`current_context` and the consumer re-roots
with :func:`attach` — the pattern ``serving/queue.py`` uses so a request's
queue-wait and device-step spans hang off the submitter's trace.

Per-request traces: every serving request is allocated a
FLEET-unique id at ``RequestQueue.submit`` (:func:`next_request_id` —
an int, the ONLY per-request cost with tracing off) that doubles as its
trace id. :func:`request_context` roots the request's trace; stage spans
(queue wait, prefill, the terminal ``serving.request``) parent on it,
while batch-level spans — one device dispatch serving many riders — run
in their OWN trace carrying a ``links=[request ids...]`` attribute that
fans them into every rider's trace. :func:`spans_for_trace` resolves one
request id to its full span set (direct spans + linked batch traces);
``ServingEngine.trace(request_id)`` is the operator surface over it.

Fleet uniqueness: ids are host-qualified — the high bits are
a stable per-process host hash (:func:`host_hash`, derived from the
fabric ``host_id``: ``SPARKDL_TORCH_HOST_ID`` or ``hostname:pid``), the
low 32 bits a local counter — so two hosts can NEVER mint colliding
trace ids and a :class:`SpanContext` can cross processes
(:func:`context_to_wire` / :func:`context_from_wire`, shipped in the
fabric submit payload and ``KVHandoff.to_wire``). The receiving host
``attach()``\\ es the deserialized context so prefill-tier, handoff, and
decode-tier spans parent into ONE stitched trace
(``observability/fleet.py`` is the cross-host aggregation surface).
"""

from __future__ import annotations

import collections
import contextvars
import itertools
import json
import os
import threading
import time
from dataclasses import dataclass
from typing import Any

__all__ = [
    "SpanContext",
    "attach",
    "clear_trace",
    "context_from_wire",
    "context_to_wire",
    "current_context",
    "disable_tracing",
    "enable_tracing",
    "export_chrome_trace",
    "host_hash",
    "host_of_id",
    "new_trace_context",
    "next_request_id",
    "observe_stage",
    "record_span",
    "request_context",
    "set_trace_host",
    "span",
    "spans_for_trace",
    "trace_clock_us",
    "trace_events",
    "tracing_enabled",
]

#: Stage-duration histogram every finished span observes into.
STAGE_METRIC = "sparkdl_stage_seconds"

_stage_family = None
_stage_bound: "dict[str, Any]" = {}


def observe_stage(stage: str, seconds: float) -> None:
    """Record a stage duration in the ``sparkdl_stage_seconds`` histogram.

    The single owner of that metric's schema: every finished span feeds
    through here, and instrumentation that times a stage without a span
    (bench loops) calls it directly. Bound handles are cached per stage so
    the hot path pays one dict hit + a float add."""
    global _stage_family
    bound = _stage_bound.get(stage)
    if bound is None:
        if _stage_family is None:
            from sparkdl_torch.observability.registry import registry

            _stage_family = registry().histogram(
                STAGE_METRIC, "per-stage span wall time", labels=("stage",)
            )
        # benign race: .labels() caches under the family lock, so two
        # threads resolving the same stage get the same bound object
        bound = _stage_bound[stage] = _stage_family.labels(stage=stage)
    bound.observe(seconds)

_enabled: bool = os.environ.get("SPARKDL_TORCH_TRACE", "") not in ("", "0")
_ids = itertools.count(1)
_ids_lock = threading.Lock()
#: bounded ring of finished-span events (dicts in trace_event shape)
_events: "collections.deque[dict]" = collections.deque(maxlen=100_000)
#: seconds origin for trace timestamps; one epoch per process so spans
#: from every thread land on a common clock
_EPOCH = time.monotonic()

_now = time.monotonic

#: bits reserved for the per-host local counter in every minted id
HOST_ID_SHIFT = 32


def _stable_host_hash(host_id: str) -> int:
    """Deterministic 31-bit hash of a host identity string (NOT
    ``hash()``, which is salted per process — the same ``host_id`` must
    map to the same id prefix across restarts so traces and logs remain
    joinable)."""
    import zlib

    return (zlib.crc32(host_id.encode()) & 0x7FFFFFFF) or 1


def _default_host_identity() -> str:
    env = os.environ.get("SPARKDL_TORCH_HOST_ID")
    if env:
        return env
    import socket

    return f"{socket.gethostname()}:{os.getpid()}"


_host_hash: int = _stable_host_hash(_default_host_identity())
#: precomputed high-bits base so the minting hot path is one OR
_id_base: int = _host_hash << HOST_ID_SHIFT


def host_hash() -> int:
    """This process's 31-bit stable host hash — the high bits of every
    id :func:`next_request_id` mints (fleet uniqueness)."""
    return _host_hash


def host_of_id(any_id: int) -> int:
    """The host hash folded into a request/span id (0 for pre-17 ids)."""
    return int(any_id) >> HOST_ID_SHIFT


def set_trace_host(host_id: str) -> int:
    """Re-key this process's id space to ``host_id`` (returns the new
    :func:`host_hash`). Operators pin identity via ``SPARKDL_TORCH_HOST_ID``
    before import; this is the in-code override (tests simulating a
    foreign host, a fabric process adopting its assigned id late).
    Already-minted ids keep their old prefix — ids only ever need to be
    unique, not re-derivable."""
    global _host_hash, _id_base
    _host_hash = _stable_host_hash(host_id)
    _id_base = _host_hash << HOST_ID_SHIFT
    return _host_hash


def trace_clock_us() -> float:
    """This process's trace clock: µs since its span-timestamp epoch —
    the same timebase ``ts`` in :func:`trace_events` uses. A fleet
    scraper reads it over the trace RPC and estimates per-host clock
    offset from the RPC round-trip midpoint (``fleet.FleetScraper``);
    monotonic clocks never cross processes raw."""
    return (time.monotonic() - _EPOCH) * 1e6


@dataclass(frozen=True)
class SpanContext:
    """Identity of a live or finished span, safe to ship across threads."""

    trace_id: int
    span_id: int


_current: "contextvars.ContextVar[SpanContext | None]" = \
    contextvars.ContextVar("sparkdl_torch_span", default=None)


def tracing_enabled() -> bool:
    return _enabled


def enable_tracing() -> None:
    global _enabled
    _enabled = True


def disable_tracing() -> None:
    global _enabled
    _enabled = False


def current_context() -> "SpanContext | None":
    """The innermost active span of THIS thread (None outside any span, or
    with tracing off). Capture at a boundary, re-attach with :func:`attach`."""
    if not _enabled:
        return None
    return _current.get()


def _next_id() -> int:
    with _ids_lock:
        return _id_base | next(_ids)


def next_request_id() -> int:
    """Fleet-unique id for one serving request; doubles as its trace
    id. High bits are this host's stable hash (:func:`host_hash`), low
    bits a local counter — two hosts cannot collide, so a
    ``DecodeWorker`` adopting a foreign id can never be
    handed an id this process will later mint. Allocated unconditionally
    at submit — with tracing disabled this int is the ONLY per-request
    tracing cost (guarded by run-tests.sh)."""
    with _ids_lock:
        return _id_base | next(_ids)


def request_context(request_id: int) -> "SpanContext | None":
    """Root span context of one request's trace (``trace_id`` IS the
    request id). None with tracing off — zero allocation there."""
    if not _enabled:
        return None
    return SpanContext(request_id, request_id)


def new_trace_context() -> "SpanContext | None":
    """Root context for a fresh trace — what batch-level work (a device
    dispatch serving many riders) runs under, with a ``links=[...]``
    attribute on its spans fanning it into each rider's trace. None with
    tracing off."""
    if not _enabled:
        return None
    tid = _next_id()
    return SpanContext(tid, tid)


class _Attach:
    __slots__ = ("_ctx", "_token")

    def __init__(self, ctx: "SpanContext | None"):
        self._ctx = ctx
        self._token = None

    def __enter__(self):
        self._token = _current.set(self._ctx)
        return self._ctx

    def __exit__(self, *exc):
        _current.reset(self._token)
        return False


def attach(ctx: "SpanContext | None") -> _Attach:
    """Context manager making ``ctx`` the ambient parent in this thread —
    the receiving half of cross-thread propagation."""
    return _Attach(ctx)


def context_to_wire(ctx: "SpanContext | None") -> "dict | None":
    """Serialize a :class:`SpanContext` for a cross-process hop (the
    fabric submit body, ``KVHandoff.to_wire``). None stays None — a
    tracing-off sender ships nothing."""
    if ctx is None:
        return None
    return {"trace_id": int(ctx.trace_id), "span_id": int(ctx.span_id)}


def context_from_wire(d: "dict | None") -> "SpanContext | None":
    """Rebuild a shipped :class:`SpanContext` on the receiving host.
    None with tracing off (the receiver pays zero, matching
    :func:`request_context`'s convention) or for an absent/garbled
    payload — propagation is best-effort, never a request failure."""
    if not _enabled or not isinstance(d, dict):
        return None
    try:
        return SpanContext(int(d["trace_id"]), int(d["span_id"]))
    except (KeyError, TypeError, ValueError):
        return None


class _NoopSpan:
    """Shared do-nothing span (tracing disabled fast path)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    #: parity with _Span so instrumentation never branches on the type
    context: "SpanContext | None" = None

    def set_attr(self, **attrs: Any) -> None:
        pass


_NOOP = _NoopSpan()


class _Span:
    __slots__ = ("name", "attrs", "context", "_parent", "_token", "_start")

    def __init__(self, name: str, parent: "SpanContext | None",
                 attrs: "dict[str, Any]"):
        self.name = name
        self.attrs = attrs
        self._parent = parent
        trace_id = parent.trace_id if parent is not None else _next_id()
        self.context = SpanContext(trace_id, _next_id())

    def set_attr(self, **attrs: Any) -> None:
        self.attrs.update(attrs)

    def __enter__(self) -> "_Span":
        self._token = _current.set(self.context)
        self._start = _now()
        return self

    def __exit__(self, exc_type, *exc) -> bool:
        end = _now()
        _current.reset(self._token)
        if exc_type is not None:
            self.attrs["error"] = exc_type.__name__
        _finish(self.name, self._start, end, self.context,
                self._parent, self.attrs)
        return False


def span(name: str, parent: "SpanContext | None" = None,
         **attrs: Any):
    """Open a span: ``with span("serving.device_step", rows=n): ...``.

    Parent defaults to the thread's ambient span (contextvar); pass
    ``parent=`` to re-root explicitly (e.g. a request's captured submit
    context). With tracing disabled this returns a shared no-op and costs
    well under a microsecond.
    """
    if not _enabled:
        return _NOOP
    if parent is None:
        parent = _current.get()
    return _Span(name, parent, attrs)


def record_span(name: str, start_s: float, end_s: float,
                parent: "SpanContext | None" = None,
                **attrs: Any) -> "SpanContext | None":
    """Record an already-elapsed interval as a finished span.

    For stages whose start predates the instrumentation point — queue
    wait is measured at ``take()`` from the request's enqueue stamp.
    ``start_s``/``end_s`` are ``time.monotonic()`` seconds (the clock
    :class:`Request` stamps with). No-op with tracing disabled.
    """
    if not _enabled:
        return None
    trace_id = parent.trace_id if parent is not None else _next_id()
    ctx = SpanContext(trace_id, _next_id())
    _finish(name, start_s, end_s, ctx, parent, attrs)
    return ctx


def _finish(name: str, start_s: float, end_s: float, ctx: SpanContext,
            parent: "SpanContext | None", attrs: "dict[str, Any]") -> None:
    dur = max(end_s - start_s, 0.0)
    args = {"trace_id": ctx.trace_id, "span_id": ctx.span_id}
    if parent is not None:
        args["parent_id"] = parent.span_id
    for k, v in attrs.items():
        if isinstance(v, (int, float, bool, str)):
            args[k] = v
        elif isinstance(v, (list, tuple)) and all(
                isinstance(i, (int, float, bool, str)) for i in v):
            # link lists (rider request ids on batch spans) stay
            # structured: spans_for_trace matches against them
            args[k] = list(v)
        else:
            args[k] = repr(v)
    _events.append({
        "name": name,
        "ph": "X",
        "ts": (start_s - _EPOCH) * 1e6,
        "dur": dur * 1e6,
        "pid": os.getpid(),
        "tid": threading.get_ident() & 0x7FFFFFFF,
        "args": args,
    })
    observe_stage(name, dur)
    # every span completion is also a flight-recorder event —
    # in the recorder's DEDICATED span ring, so high-rate span traffic
    # can never evict the sparse reliability events postmortems need
    from sparkdl_torch.observability import flight

    flight.flight_recorder().record_span_event(
        name, trace_id=ctx.trace_id, span_id=ctx.span_id,
        dur_ms=round(dur * 1e3, 3),
    )


def trace_events() -> "list[dict]":
    """The finished-span ring as plain dicts (test/inspection hook).

    Copied via the shared hot-append-safe snapshot (a postmortem dump
    taken under load must get the ring, not a RuntimeError from a
    concurrent span finish)."""
    from sparkdl_torch.observability.flight import safe_ring_snapshot

    return safe_ring_snapshot(_events)


def spans_for_trace(trace_id: int, *, follow_links: bool = True,
                    events: "list[dict] | None" = None) -> "list[dict]":
    """Every finished span of one trace, timestamp-ordered.

    A request's trace id is its request id (:func:`next_request_id`), so
    ``spans_for_trace(fut.request_id)`` answers "what happened to THIS
    request". Matching is two-level: spans whose ``trace_id`` equals (or
    whose ``links`` list contains) the id are direct members; with
    ``follow_links`` (default) the batch traces those linked spans
    belong to are pulled in whole — the device dispatch, replica
    execution and fetch spans a rider shared with its batch-mates.
    ``events`` lets a caller resolving MANY traces (a postmortem dump)
    snapshot the ring once instead of per call.
    """
    evs = events if events is not None else trace_events()
    picked: "list[dict]" = []
    span_ids: "set" = set()
    related: "set" = set()
    for ev in evs:
        args = ev.get("args", {})
        links = args.get("links")
        if args.get("trace_id") == trace_id or (
                isinstance(links, list) and trace_id in links):
            picked.append(ev)
            span_ids.add(args.get("span_id"))
            related.add(args.get("trace_id"))
    related.discard(trace_id)
    if follow_links and related:
        for ev in evs:
            args = ev.get("args", {})
            if (args.get("trace_id") in related
                    and args.get("span_id") not in span_ids):
                picked.append(ev)
                span_ids.add(args.get("span_id"))
    picked.sort(key=lambda e: e["ts"])
    return picked


def clear_trace() -> None:
    _events.clear()


def export_chrome_trace(path: "str | os.PathLike",
                        trace_id: "int | None" = None) -> int:
    """Write the collected spans as Chrome ``trace_event`` JSON.

    The file loads in ``chrome://tracing`` and https://ui.perfetto.dev —
    same UIs that read ``torch.profiler`` traces, so serving spans and
    device traces can sit side by side. ``trace_id`` (e.g. a
    request id) exports only that trace (linked batch spans included).
    Returns the event count.
    """
    events = (trace_events() if trace_id is None
              else spans_for_trace(trace_id))
    with open(path, "w") as f:
        json.dump(
            {"traceEvents": events, "displayTimeUnit": "ms"}, f,
            separators=(",", ":"),
        )
    return len(events)
