"""Flight recorder: a bounded ring of structured events + postmortems.

The spine (registry.py) answers "how is the system doing in aggregate";
the tracing ring answers "where did this request's time go". Neither
answers "why did replica 1 get quarantined at 14:02" — by the time an
operator asks, the causal chain (the fault injection, the retry storm,
the autotune decision that shrank the buffer) has scrolled out of the
logs. This module keeps that chain: every reliability-relevant event
(span completions, autotune decisions, retry attempts, fault
injections, quarantine/probation/watchdog transitions, checkpoint
fallbacks, failed requests) lands in ONE process-wide bounded ring, and
reliability triggers (:class:`~sparkdl_torch.serving.replicas.HungDispatchError`,
replica quarantine, ``CheckpointCorruptError``,
``AllReplicasQuarantinedError``) automatically dump a **postmortem
bundle** — last-N events, registry snapshot, per-replica/engine state
from registered context providers, and the in-flight requests' traces —
to a configurable directory (``SPARKDL_TORCH_FLIGHT_DIR``) and the
``/debug/flight`` endpoint.

Contracts:

* **Lock-cheap append.** :func:`record_event` is one dict build + a
  ``deque.append`` (+ an ``itertools.count`` bump) — no lock, well under
  a microsecond (guarded by run-tests.sh next to the fault_point guard).
  Recording is always on; the ring is the bound.
* **Triggers settle before dumping.** A trigger schedules the dump
  ``settle_s`` (default 0.25 s) later so the postmortem captures the
  *recovery* that followed — the re-routed batch completing, the
  probation probe — not just the instant of failure. Triggers inside
  that window (and within ``min_interval_s`` of the last dump) coalesce
  instead of storming the disk.
* **Observability must not crash the job.** Context providers and dump
  writes are exception-guarded; a failing provider lands as an error
  entry in the bundle, never as an exception on a serving thread.

The same context-provider registry feeds :func:`healthz_report` — the
``/healthz`` aggregation the future router tier health-checks: live
replica quarantine/probation state, retry-budget remaining, and the
last checkpoint-integrity verdict (pushed via :func:`set_health_fact`
by the checkpoint manager).
"""

from __future__ import annotations

import collections
import itertools
import json
import logging
import os
import re
import threading
import time
import weakref
from typing import Any, Callable

from sparkdl_torch.observability.registry import registry

__all__ = [
    "ENV_DIR",
    "FlightRecorder",
    "add_context_provider",
    "adopt_incident",
    "current_incident_id",
    "flight_recorder",
    "healthz_report",
    "record_event",
    "remove_context_provider",
    "set_health_fact",
    "trigger_dump",
]

_log = logging.getLogger(__name__)

#: Postmortem bundles land here when set (dumps stay in-memory-only,
#: served at /debug/flight, when unset).
ENV_DIR = "SPARKDL_TORCH_FLIGHT_DIR"
#: Ring capacity override (events retained in memory).
ENV_EVENTS = "SPARKDL_TORCH_FLIGHT_EVENTS"
#: Minimum seconds between postmortem dumps (trigger storms coalesce).
ENV_MIN_INTERVAL = "SPARKDL_TORCH_FLIGHT_MIN_INTERVAL_S"

#: Tracing events included in a bundle (the tail of the span ring).
_BUNDLE_TRACE_EVENTS = 512
#: In-flight request traces resolved per bundle (cap: dump cost bound).
_BUNDLE_MAX_TRACES = 32

_M_DUMPS = None


def _dumps_counter():
    global _M_DUMPS
    if _M_DUMPS is None:
        _M_DUMPS = registry().counter(
            "sparkdl_flight_dumps_total",
            "postmortem bundles written by the flight recorder",
            labels=("reason",))
    return _M_DUMPS


_UNSET = object()


def safe_ring_snapshot(ring) -> "list[dict]":
    """Copy a hot-append ring: ``list(deque)`` raises RuntimeError if a
    producer appends mid-copy, and a postmortem/scrape must get the
    ring, not an exception. Shared by the flight rings and the tracing
    event ring."""
    for _ in range(3):
        try:
            return list(ring)
        except RuntimeError:  # pragma: no cover - hot-append race
            continue
    return []  # pragma: no cover


class FlightRecorder:
    """Bounded ring of structured events + postmortem bundle writer.

    One process-wide instance (:func:`flight_recorder`) is what
    production code feeds; tests may build isolated instances. All
    configuration is mutable post-construction via :meth:`configure`
    (benches and the chaos smoke shrink ``settle_s``).
    """

    def __init__(self, capacity: int = 4096, *,
                 directory: "str | None" = None,
                 settle_s: float = 0.25,
                 min_interval_s: float = 10.0,
                 max_bundles: int = 16):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self._ring: "collections.deque[dict]" = collections.deque(
            maxlen=capacity)
        #: span completions are orders of magnitude more frequent than
        #: reliability events when tracing is on — they get their OWN
        #: ring so a span storm can never evict the sparse causal chain
        #: (quarantines, faults, retries) the postmortem exists for
        self._span_ring: "collections.deque[dict]" = collections.deque(
            maxlen=capacity)
        self._seq = itertools.count(1)  # CPython-atomic event counter
        self.directory = directory
        self.settle_s = settle_s
        self.min_interval_s = min_interval_s
        self.max_bundles = max_bundles
        self.last_bundle: "dict | None" = None
        self.last_path: "str | None" = None
        self._trigger_lock = threading.Lock()
        self._last_dump_mono: float = -float("inf")
        self._pending: "threading.Timer | None" = None
        #: cross-host postmortem correlation: one incident id
        #: spans every bundle this process writes within ``incident_ttl_s``
        #: of the first trigger, and rides the KV-handoff wire so the
        #: PEER tier's bundles carry the SAME id — /debug/flight output
        #: from both hosts joins on it.
        self.incident_ttl_s = 60.0
        self._incident_id: "str | None" = None
        self._incident_at: float = -float("inf")

    # -- the hot path --------------------------------------------------------
    def record(self, kind: str, **fields: Any) -> None:
        """Append one event. Lock-free (one dict + deque.append): sits on
        retry/fault/span-completion paths, so it must stay ~sub-µs."""
        ev = {"seq": next(self._seq), "t": time.time(), "kind": kind}
        if fields:
            ev.update(fields)
        self._ring.append(ev)

    def record_span_event(self, name: str, **fields: Any) -> None:
        """Append one span completion to the dedicated span ring (fed by
        ``tracing._finish``; same cost contract as :meth:`record`).

        Deliberately overlaps the tracing ring: that ring is the
        export surface and is user-clearable (``clear_trace()``), while
        the flight recorder is the always-available black box — a
        bundle taken after a trace export/clear still shows recent span
        activity. The dedicated ring (vs the reliability ring) is what
        keeps a tracing-on span storm from evicting the sparse causal
        chain."""
        ev = {"seq": next(self._seq), "t": time.time(), "kind": "span",
              "name": name}
        if fields:
            ev.update(fields)
        self._span_ring.append(ev)

    @property
    def events_total(self) -> int:
        """Events recorded since process start, both rings (monotone;
        survives ring eviction — it is the sequence counter, not the
        ring length)."""
        tails = [int(r[-1]["seq"])
                 for r in (self._ring, self._span_ring) if r]
        return max(tails, default=0)

    def events(self, last: "int | None" = None) -> "list[dict]":
        """Snapshot of the reliability-event ring (oldest first);
        ``last`` trims to the newest N. Best-effort consistent (the ring
        is append-only)."""
        evs = safe_ring_snapshot(self._ring)
        return evs[-last:] if last else evs

    def span_events(self, last: "int | None" = None) -> "list[dict]":
        """Snapshot of the span-completion ring (oldest first)."""
        evs = safe_ring_snapshot(self._span_ring)
        return evs[-last:] if last else evs

    # -- incident correlation ------------------------------------------------
    def current_incident_id(self) -> "str | None":
        """The live incident id, or None once ``incident_ttl_s`` has
        passed since the last trigger/adoption — reliability events
        separated by a quiet minute are different incidents."""
        with self._trigger_lock:
            if time.monotonic() - self._incident_at > self.incident_ttl_s:
                return None
            return self._incident_id

    def adopt_incident(self, incident_id: "str | None") -> None:
        """Join an incident another host started: a KV handoff (or any
        cross-host payload) carrying an incident id stamps it here, so
        THIS host's next bundle shares the id and the two tiers'
        ``/debug/flight`` output is joinable. A live local incident is
        never overwritten — first writer wins, both sides converge on
        the oldest id in the causal chain."""
        if not incident_id:
            return
        with self._trigger_lock:
            now = time.monotonic()
            if self._incident_id is None \
                    or now - self._incident_at > self.incident_ttl_s:
                self._incident_id = str(incident_id)
            self._incident_at = now

    def reset_incident(self) -> None:
        """Close the live incident window (test isolation, or an
        operator declaring the incident over): the next trigger mints a
        FRESH id instead of extending this one's TTL."""
        with self._trigger_lock:
            self._incident_id = None
            self._incident_at = -float("inf")

    def _ensure_incident_locked(self) -> str:
        now = time.monotonic()
        if self._incident_id is None \
                or now - self._incident_at > self.incident_ttl_s:
            self._incident_id = f"inc-{os.getpid():x}-{next(self._seq)}"
        self._incident_at = now
        return self._incident_id

    # -- configuration -------------------------------------------------------
    def configure(self, *, directory: Any = _UNSET,
                  settle_s: "float | None" = None,
                  min_interval_s: "float | None" = None,
                  capacity: "int | None" = None,
                  max_bundles: "int | None" = None) -> "FlightRecorder":
        if directory is not _UNSET:
            self.directory = directory
        if settle_s is not None:
            self.settle_s = settle_s
        if min_interval_s is not None:
            self.min_interval_s = min_interval_s
        if max_bundles is not None:
            self.max_bundles = max_bundles
        if capacity is not None and capacity != self._ring.maxlen:
            self._ring = collections.deque(self.events(), maxlen=capacity)
            self._span_ring = collections.deque(
                self.span_events(), maxlen=capacity)
        return self

    # -- postmortems ---------------------------------------------------------
    def dump(self, reason: str, *, extra: "dict | None" = None) -> dict:
        """Build (but do not write) a postmortem bundle: last-N events,
        registry snapshot, every context provider's state, the tail of
        the tracing ring, and the spans of every in-flight request any
        provider reports (``inflight_request_ids``)."""
        from sparkdl_torch.observability import tracing

        context: "dict[str, Any]" = {}
        inflight: "list[int]" = []
        for name, fn in _providers_snapshot():
            try:
                out = fn()
            except Exception as e:
                out = {"error": repr(e)}
            context[name] = out
            if isinstance(out, dict):
                try:
                    inflight.extend(
                        int(r) for r in out.get("inflight_request_ids") or ()
                    )
                except Exception:  # provider gave junk: keep the rest
                    pass
        # one snapshot of the span ring, shared by the tail copy and
        # every in-flight trace resolution (resolving 32 traces against
        # a 100k-event ring must not copy it 32 times mid-incident)
        all_traces = tracing.trace_events()
        bundle = {
            "reason": reason,
            "incident_id": self.current_incident_id(),
            "time_unix": time.time(),
            "pid": os.getpid(),
            "events_total": self.events_total,
            "events": self.events(),
            "span_events": self.span_events(_BUNDLE_TRACE_EVENTS),
            "registry": registry().snapshot(),
            "context": context,
            "trace_events": all_traces[-_BUNDLE_TRACE_EVENTS:],
            "inflight_traces": {
                str(rid): tracing.spans_for_trace(rid, events=all_traces)
                for rid in inflight[:_BUNDLE_MAX_TRACES]
            },
        }
        if extra:
            bundle["extra"] = extra
        return bundle

    def write_postmortem(self, reason: str, *,
                         extra: "dict | None" = None) -> "str | None":
        """Build a bundle, keep it as :attr:`last_bundle`, and write it
        to :attr:`directory` (pruned to ``max_bundles``) when one is
        configured. Returns the file path (None with no directory).

        A triggered postmortem IS an incident: one is minted here if
        none is live, so every bundle carries an ``incident_id`` and
        bundles from correlated failures (this host's, and — via the
        handoff wire's adoption — the peer tier's) share it."""
        with self._trigger_lock:
            self._ensure_incident_locked()
        bundle = self.dump(reason, extra=extra)
        self.last_bundle = bundle
        _dumps_counter().inc(reason=reason)
        path = None
        if self.directory:
            slug = re.sub(r"[^a-zA-Z0-9_.-]+", "_", reason)[:48]
            path = os.path.join(
                self.directory, f"flight-{time.time_ns()}-{slug}.json"
            )
            os.makedirs(self.directory, exist_ok=True)
            with open(path, "w") as f:
                # default=repr: provider state may carry numpy scalars /
                # device objects; a postmortem must never fail to write
                json.dump(bundle, f, default=repr)
            self.last_path = path
            self._prune()
            _log.error(
                "flight recorder: postmortem bundle (%s, %d events) "
                "written to %s", reason, len(bundle["events"]), path,
            )
        else:
            _log.error(
                "flight recorder: postmortem (%s, %d events) captured "
                "in memory — set %s to persist bundles",
                reason, len(bundle["events"]), ENV_DIR,
            )
        return path

    def _prune(self) -> None:
        try:
            bundles = sorted(
                f for f in os.listdir(self.directory)
                if f.startswith("flight-") and f.endswith(".json")
            )
            for stale in bundles[:-self.max_bundles]:
                os.unlink(os.path.join(self.directory, stale))
        except OSError:  # pragma: no cover - dir vanished mid-prune
            pass

    def trigger_dump(self, reason: str, *,
                     settle_s: "float | None" = None,
                     **fields: Any) -> None:
        """Reliability trigger: record the event now, write the
        postmortem after ``settle_s`` (so the bundle captures the
        recovery that follows — re-routes, probation), coalescing
        triggers inside the settle window and rate-limited to one dump
        per ``min_interval_s``. Never raises and never blocks the
        caller beyond the event append with a settle window; a
        ``settle_s=0`` override dumps INLINE before returning — what a
        trigger whose caller is about to raise a process-fatal error
        (checkpoint corruption) must use, or the daemon timer dies with
        the interpreter and the flagship postmortem is never written.
        The explicit override also BYPASSES coalescing and the rate
        limit (cancelling any pending settle timer): "the recent bundle
        covers this" is never true for a dump whose process is about to
        die. A recorder merely *configured* with ``settle_s=0`` (tests)
        keeps normal rate-limiting."""
        # the incident starts at the TRIGGER, not at the settled dump:
        # payloads crossing hosts inside the settle window must already
        # carry the id for the peer's bundle to join on
        with self._trigger_lock:
            incident = self._ensure_incident_locked()
        self.record("trigger", reason=reason, incident_id=incident,
                    **fields)
        force_inline = settle_s is not None and settle_s <= 0
        if settle_s is None:
            settle_s = self.settle_s
        pending = None
        with self._trigger_lock:
            now = time.monotonic()
            if force_inline:
                pending, self._pending = self._pending, None
                self._last_dump_mono = now
            else:
                if self._pending is not None:
                    return  # coalesced into the already-scheduled dump
                if now - self._last_dump_mono < self.min_interval_s:
                    return  # rate-limited: the recent bundle covers this
                self._last_dump_mono = now
                if settle_s <= 0:
                    timer = None
                else:
                    timer = threading.Timer(
                        settle_s, self._scheduled_dump, args=(reason,)
                    )
                    timer.daemon = True
                    self._pending = timer
        if force_inline:
            if pending is not None:
                pending.cancel()
            self._scheduled_dump(reason)
        elif timer is not None:
            timer.start()
        else:
            self._scheduled_dump(reason)

    def _scheduled_dump(self, reason: str) -> None:
        with self._trigger_lock:
            self._pending = None
            self._last_dump_mono = time.monotonic()
        try:
            self.write_postmortem(reason)
        except Exception:  # pragma: no cover - observability never crashes
            _log.exception("flight recorder: postmortem dump failed")

    def debug_view(self) -> dict:
        """The ``/debug/flight`` payload: a live bundle built on demand
        plus the location of the last written postmortem."""
        return {
            "last_postmortem_path": self.last_path,
            "bundle": self.dump("debug.scrape"),
        }


#: The process-wide recorder every instrumentation point feeds.
_RECORDER = FlightRecorder(
    capacity=int(os.environ.get(ENV_EVENTS, "4096")),
    directory=os.environ.get(ENV_DIR) or None,
    min_interval_s=float(os.environ.get(ENV_MIN_INTERVAL, "10")),
)


def flight_recorder() -> FlightRecorder:
    return _RECORDER


def record_event(kind: str, **fields: Any) -> None:
    """Append one event to the process flight ring (the hot-path form)."""
    _RECORDER.record(kind, **fields)


def trigger_dump(reason: str, *, settle_s: "float | None" = None,
                 **fields: Any) -> None:
    """Fire a reliability trigger on the process recorder
    (``settle_s=0`` dumps inline — see the method)."""
    _RECORDER.trigger_dump(reason, settle_s=settle_s, **fields)


def current_incident_id() -> "str | None":
    """The process recorder's live incident id (None outside one) —
    what the KV-handoff export stamps onto the wire."""
    return _RECORDER.current_incident_id()


def adopt_incident(incident_id: "str | None") -> None:
    """Join an incident that rode in over the wire (see the method)."""
    _RECORDER.adopt_incident(incident_id)


# -- context providers --------------------------------------------------------

_PROVIDERS: "dict[str, Callable[[], Callable[[], dict] | None]]" = {}
_PROVIDERS_LOCK = threading.Lock()


def add_context_provider(name: str, fn: Callable[[], dict]) -> str:
    """Register a zero-arg callable contributing live state to every
    postmortem bundle and to :func:`healthz_report` (engines and replica
    pools register their ``snapshot``-shaped views; remove on close).
    Bound methods are held via :class:`weakref.WeakMethod`, so an engine
    dropped WITHOUT close() is still garbage-collectable — its entry
    self-prunes instead of pinning the engine (and its model arrays)
    for the process lifetime. Returns ``name`` (the removal handle)."""
    ref = (weakref.WeakMethod(fn) if hasattr(fn, "__self__")
           else (lambda fn=fn: fn))
    with _PROVIDERS_LOCK:
        _PROVIDERS[name] = ref
    return name


def remove_context_provider(name: str) -> None:
    with _PROVIDERS_LOCK:
        _PROVIDERS.pop(name, None)


def _providers_snapshot() -> "list[tuple[str, Callable[[], dict]]]":
    out = []
    with _PROVIDERS_LOCK:
        for name, ref in list(_PROVIDERS.items()):
            fn = ref()
            if fn is None:  # provider owner was garbage-collected
                _PROVIDERS.pop(name)
            else:
                out.append((name, fn))
    return out


# -- health facts + /healthz aggregation --------------------------------------

_FACTS: "dict[str, Any]" = {}
_FACTS_LOCK = threading.Lock()


def set_health_fact(key: str, value: Any) -> None:
    """Publish one slow-changing health fact (e.g. the checkpoint
    manager's last integrity verdict) for /healthz and postmortems."""
    with _FACTS_LOCK:
        _FACTS[key] = value


def health_facts() -> "dict[str, Any]":
    with _FACTS_LOCK:
        return dict(_FACTS)


def healthz_report() -> dict:
    """Aggregate reliability state for a router-tier health check.

    ``status`` is ``ok`` / ``degraded`` / ``unhealthy``:

    * **unhealthy** — some replica pool has ZERO healthy replicas, or
      the last checkpoint restore found digest-verified corruption with
      no intact fallback (verdict ``corrupt``, not pinned): this host
      cannot currently serve / resume. ``/healthz`` answers 503.
    * **degraded** — a pool is serving with quarantined replicas, the
      process retry budget ran dry, a serving engine's KV block pool is
      on an exhaustion streak (admissions deferring — self-recovering
      as slots retire, hence never ``unhealthy``), an elastic
      autoscaler is mid-incident (a scale decision was vetoed by SLO
      burn or deferred by a fault — state ``vetoed``/``deferred``,
      self-clearing once the controller recovers), or the last restore
      fell back past a torn checkpoint / failed ambiguously
      (``fallback`` / ``unreadable`` / pinned-step ``corrupt``): route
      around if possible, still serving.
    * **ok** — everything else (including "no pools registered").

    A provider that RAISES lands under ``provider_errors`` (never in
    ``replica_pools`` — its shape is unknown) and forces at least
    ``degraded``: state that cannot be observed must not read as
    healthy.
    """
    pools = []
    kv_pools = []
    autoscalers = []
    errors = []
    status = "ok"
    for name, fn in _providers_snapshot():
        try:
            out = fn()
        except Exception as e:
            errors.append({"provider": name, "error": repr(e)})
            continue
        if isinstance(out, dict) and isinstance(
                out.get("autoscaler"), dict):
            a = out["autoscaler"]
            autoscalers.append({"provider": name, **a})
            if a.get("state") in ("vetoed", "deferred") \
                    and status == "ok":
                # a scale event is mid-incident (reverted by SLO burn,
                # or deferred by a fault): degraded, never unhealthy —
                # the controller retries/recovers on its own cadence
                status = "degraded"
            kv_as = a.get("kv")
            if (isinstance(kv_as, dict)
                    and int(kv_as.get("shrink_blocked_streak") or 0) > 0
                    and status == "ok"):
                # scale-down is deferring because parked sessions hold
                # unpark reservations (ROADMAP item 1): degraded, never
                # unhealthy — clears when sessions resume or drop
                status = "degraded"
        if isinstance(out, dict) and isinstance(out.get("kv_pool"), dict):
            kvp = out["kv_pool"]
            tiers = kvp.get("tiers") if isinstance(
                kvp.get("tiers"), dict) else None
            kv_pools.append({
                "provider": name,
                "blocks_total": kvp.get("blocks_total"),
                "blocks_used": kvp.get("blocks_used"),
                "blocks_cached": kvp.get("blocks_cached"),
                "deferrals_total": kvp.get("deferrals_total"),
                "exhausted_streak": kvp.get("exhausted_streak"),
                # tier occupancy (ROADMAP item 1): how much of this
                # engine's session state sits in the cheap tiers
                **({"host_tier_blocks": tiers.get("host_blocks"),
                    "disk_tier_blocks": tiers.get("disk_blocks"),
                    "parked_sessions": tiers.get("parked_sessions"),
                    } if tiers is not None else {}),
            })
            if int(kvp.get("exhausted_streak") or 0) > 0 \
                    and status == "ok":
                # admissions are deferring on an exhausted block pool:
                # degraded, never unhealthy — it self-recovers as slots
                # retire and free their blocks
                status = "degraded"
        if not (isinstance(out, dict) and "healthy_count" in out):
            continue  # engine-level providers: not a pool view
        healthy = int(out.get("healthy_count") or 0)
        total = int(out.get("replica_count") or 0)
        pools.append({
            "provider": name,
            "replica_count": total,
            "healthy_count": healthy,
            "quarantined_count": total - healthy,
        })
        if healthy == 0 and total > 0:
            status = "unhealthy"
        elif healthy < total and status == "ok":
            status = "degraded"
    if errors and status == "ok":
        status = "degraded"
    from sparkdl_torch.reliability.retry import process_retry_budget

    budget = process_retry_budget()
    if budget.remaining == 0 and status == "ok":
        status = "degraded"
    facts = health_facts()
    ck = facts.get("checkpoint_integrity")
    if isinstance(ck, dict):
        verdict = ck.get("verdict")
        if verdict == "corrupt" and not ck.get("pinned"):
            status = "unhealthy"
        elif verdict in ("fallback", "unreadable", "corrupt") \
                and status == "ok":
            status = "degraded"
    ov = facts.get("overload")
    if (isinstance(ov, dict) and int(ov.get("level") or 0) > 0
            and status == "ok"):
        # the brownout ladder is above normal: degraded,
        # never unhealthy — the host is deliberately shedding load and
        # steps back down on its own hysteresis
        status = "degraded"
    return {
        "status": status,
        "overload": ov if isinstance(ov, dict) else None,
        "replica_pools": pools,
        "kv_pools": kv_pools,
        "autoscalers": autoscalers,
        "provider_errors": errors,
        "retry_budget": {
            "remaining": budget.remaining,
            "initial": budget.initial,
        },
        "checkpoint_integrity": ck,
        "flight": {
            "events_total": _RECORDER.events_total,
            "last_postmortem_path": _RECORDER.last_path,
        },
    }
