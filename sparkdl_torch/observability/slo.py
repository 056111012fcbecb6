"""SLO accounting: declared objectives, rolling error-budget burn.

An objective ("95% of requests under 250 ms, 99.9% availability") only
means something against a *window* of traffic: this module turns the
spine's existing cumulative series — the
``sparkdl_serving_latency_seconds`` histogram and the
``sparkdl_serving_requests_total{outcome}`` counter — into rolling
compliance and **burn rate** (error rate / error budget: burn 1.0 means
the budget is being consumed exactly at the sustainable pace, burn 10
means an hour of this traffic eats ten hours of budget — the
multi-window alerting quantity from the SRE literature).

No new per-request instrumentation: a :class:`SLOTracker` samples the
cumulative series on demand (every :meth:`~SLOTracker.sample` call —
``snapshot()``, a ``/metrics`` or ``/slo.json`` scrape), keeps a small
deque of (time, totals) samples, and differences the newest against the
oldest still inside ``window_s``. Latency compliance uses
:meth:`~sparkdl_torch.observability.registry.MetricFamily.count_below`
(bucket-interpolated), so the objective threshold may sit anywhere in
the histogram's range.

Results surface three ways: ``ServingEngine.snapshot()["slo"]``, the
``sparkdl_slo_*`` gauges in ``/metrics`` (refreshed at scrape), and the
``/slo.json`` endpoint listing every registered tracker.

Note: the source series are process-wide — two engines sharing one
process share the histograms, so their trackers both see the union of
the traffic. One engine per process (the serving deployment shape) gives
exact per-engine accounting.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
import weakref
from typing import Any, Callable

from sparkdl_torch.observability.registry import MetricsRegistry, registry

__all__ = [
    "SLO",
    "SLOTracker",
    "register",
    "sample_all",
    "slo_report",
    "unregister",
]

#: The serving series the default tracker reads.
LATENCY_METRIC = "sparkdl_serving_latency_seconds"
REQUESTS_METRIC = "sparkdl_serving_requests_total"
#: Admission rejects (QueueFullError) never reach the outcome counter —
#: but a turned-away client is an availability failure, so the tracker
#: folds this counter into the availability denominator. Otherwise an
#: overloaded engine shedding 90% of submits would report availability
#: compliance 1.0 during exactly the incident the SLO exists to catch.
REJECTED_METRIC = "sparkdl_queue_rejected_total"
#: Per-request phase attribution: the disagg path's
#: ``{phase, tier}`` histogram. When it carries traffic the tracker
#: folds a windowed per-tier breakdown into every report, so a latency
#: burn names the GUILTY tier ("burn 4.2, 71% of request time was
#: (queue, decode)") instead of just ringing the bell.
PHASE_METRIC = "sparkdl_request_phase_seconds"

def _gauges(reg: MetricsRegistry):
    # get-or-create per sample: declaration is idempotent and samples
    # run at scrape frequency, so no handle caching is needed
    return (
        reg.gauge(
            "sparkdl_slo_objective",
            "declared objective (target fraction) per SLO dimension",
            labels=("slo", "dimension")),
        reg.gauge(
            "sparkdl_slo_compliance",
            "rolling-window compliance fraction per SLO dimension",
            labels=("slo", "dimension")),
        reg.gauge(
            "sparkdl_slo_burn_rate",
            "error-budget burn rate (error rate / budget; 1.0 = "
            "sustainable pace)",
            labels=("slo", "dimension")),
    )


@dataclasses.dataclass(frozen=True)
class SLO:
    """Declared objectives for one engine.

    ``latency_threshold_s``/``latency_target``: "``latency_target`` of
    requests complete within ``latency_threshold_s``" (None disables the
    latency dimension). ``availability_target``: fraction of requests
    that must complete without error (None disables). ``window_s`` is
    the rolling accounting window.
    """

    name: str
    latency_threshold_s: "float | None" = None
    latency_target: float = 0.95
    availability_target: "float | None" = 0.999
    window_s: float = 300.0

    def __post_init__(self):
        if not self.name:
            raise ValueError("SLO needs a name (it labels the metrics)")
        for target, what in ((self.latency_target, "latency_target"),
                             (self.availability_target,
                              "availability_target")):
            if target is not None and not (0.0 < target < 1.0):
                raise ValueError(
                    f"{what} must be in (0, 1) — a target of 1.0 has "
                    f"zero error budget; got {target}"
                )
        if self.latency_threshold_s is not None \
                and self.latency_threshold_s <= 0:
            raise ValueError(
                f"latency_threshold_s must be > 0, got "
                f"{self.latency_threshold_s}"
            )
        if self.window_s <= 0:
            raise ValueError(f"window_s must be > 0, got {self.window_s}")


class _Totals(collections.namedtuple(
        "_Totals", "t lat_good lat_total ok failed rejected phases")):
    """One cumulative sample of the source series. ``phases`` maps
    ``(phase, tier) -> (count, seconds)`` cumulative pairs from
    :data:`PHASE_METRIC` (empty when the disagg path is idle)."""


class SLOTracker:
    """Rolling error-budget accounting for one :class:`SLO`.

    ``sample()`` is the one verb: read the cumulative series, difference
    against the oldest in-window sample, publish the gauges, return the
    structured report. Thread-safe (scrapes race engine snapshots).
    """

    def __init__(self, slo: SLO, *, reg: "MetricsRegistry | None" = None,
                 clock: Callable[[], float] = time.monotonic):
        self.slo = slo
        self._reg = reg if reg is not None else registry()
        self._clock = clock
        self._lock = threading.Lock()
        self._samples: "collections.deque[_Totals]" = collections.deque()
        self._samples.append(self._read())  # the creation-time baseline

    def _read(self) -> _Totals:
        lat_good, lat_total = 0.0, 0
        if self.slo.latency_threshold_s is not None:
            fam = self._reg.get(LATENCY_METRIC)
            if fam is not None:
                lat_good, lat_total = fam.count_below(
                    self.slo.latency_threshold_s)
        ok = failed = rejected = 0.0
        fam = self._reg.get(REQUESTS_METRIC)
        if fam is not None:
            by = fam.labelled_values("outcome")
            ok = by.get("completed", 0.0)
            failed = by.get("failed", 0.0)
        fam = self._reg.get(REJECTED_METRIC)
        if fam is not None:
            values = fam.snapshot_values()
            rejected = float(values.get("", 0.0))
        phases: "dict[tuple, tuple]" = {}
        fam = self._reg.get(PHASE_METRIC)
        if fam is not None:
            for labels, stats in fam.hist_series():
                phases[(labels.get("phase", ""),
                        labels.get("tier", ""))] = (
                    stats["count"], stats["sum"])
        return _Totals(self._clock(), lat_good, lat_total, ok, failed,
                       rejected, phases)

    @staticmethod
    def _dimension(good: float, total: float, target: float) -> dict:
        """Compliance/burn report for one dimension's windowed deltas."""
        if total <= 0:
            # no traffic in the window: nothing violated, nothing burned
            return {"target": target, "requests": 0,
                    "compliance": None, "burn_rate": 0.0,
                    "budget_remaining": 1.0}
        compliance = min(1.0, max(0.0, good / total))
        burn = (1.0 - compliance) / (1.0 - target)
        return {
            "target": target,
            "requests": int(total),
            "compliance": compliance,
            "burn_rate": burn,
            "budget_remaining": max(0.0, 1.0 - burn),
        }

    def sample(self) -> "dict[str, Any]":
        with self._lock:
            cur = self._read()
            self._samples.append(cur)
            horizon = cur.t - self.slo.window_s
            while len(self._samples) >= 2 and self._samples[1].t <= horizon:
                self._samples.popleft()
            base = self._samples[0]
        # deltas clamp at 0: a registry().reset() (test isolation) makes
        # cumulative series go backwards; treat it as an empty window
        d = lambda a, b: max(0.0, a - b)  # noqa: E731
        report: "dict[str, Any]" = {
            "slo": self.slo.name,
            "window_s": self.slo.window_s,
            "latency": None,
            "availability": None,
        }
        objective, compliance_g, burn_g = _gauges(self._reg)
        if self.slo.latency_threshold_s is not None:
            dim = self._dimension(
                d(cur.lat_good, base.lat_good),
                d(cur.lat_total, base.lat_total),
                self.slo.latency_target,
            )
            dim["threshold_s"] = self.slo.latency_threshold_s
            report["latency"] = dim
            self._publish(objective, compliance_g, burn_g, "latency", dim)
        if self.slo.availability_target is not None:
            # denominator includes admission rejects (see REJECTED_METRIC)
            total = (d(cur.ok, base.ok) + d(cur.failed, base.failed)
                     + d(cur.rejected, base.rejected))
            dim = self._dimension(
                d(cur.ok, base.ok), total, self.slo.availability_target)
            dim["rejected"] = int(d(cur.rejected, base.rejected))
            report["availability"] = dim
            self._publish(objective, compliance_g, burn_g,
                          "availability", dim)
        phases = self._phase_attribution(cur, base, d)
        if phases:
            report["phases"] = phases
            # the guilty tier: where the window's request time went
            report["dominant_phase"] = {
                k: phases[0][k] for k in ("phase", "tier", "share")}
        return report

    @staticmethod
    def _phase_attribution(cur: _Totals, base: _Totals, d) -> "list[dict]":
        """Windowed per-(phase, tier) time attribution,
        largest share first — so a burning latency SLO reads which
        tier's which phase ate the window's request time."""
        rows = []
        for key, (cnt, tot) in (cur.phases or {}).items():
            b_cnt, b_tot = (base.phases or {}).get(key, (0, 0.0))
            secs = d(tot, b_tot)
            if secs > 0:
                rows.append({"phase": key[0], "tier": key[1],
                             "seconds": secs,
                             "observations": int(d(cnt, b_cnt))})
        total = sum(r["seconds"] for r in rows)
        for r in rows:
            r["share"] = r["seconds"] / total if total else 0.0
        rows.sort(key=lambda r: r["seconds"], reverse=True)
        return rows

    def _publish(self, objective, compliance, burn, dimension: str,
                 dim: dict) -> None:
        labels = {"slo": self.slo.name, "dimension": dimension}
        objective.set(dim["target"], **labels)
        compliance.set(
            dim["compliance"] if dim["compliance"] is not None else 1.0,
            **labels)
        burn.set(dim["burn_rate"], **labels)


# -- the process-wide tracker list (what /slo.json serves) --------------------

#: weak refs: the registrant (an engine's self.slo_tracker, or a test's
#: local) owns the tracker's lifetime — an engine dropped WITHOUT
#: close() self-prunes here instead of being sampled on every scrape
#: forever (same policy as flight's WeakMethod context providers)
_TRACKERS: "list[weakref.ref[SLOTracker]]" = []
_TRACKERS_LOCK = threading.Lock()


def register(tracker: SLOTracker) -> SLOTracker:
    """Add a tracker to the process list (engines register theirs at
    construction; unregister on close). Held weakly — keep a strong
    reference for as long as the SLO should be reported."""
    with _TRACKERS_LOCK:
        if not any(r() is tracker for r in _TRACKERS):
            _TRACKERS.append(weakref.ref(tracker))
    return tracker


def unregister(tracker: SLOTracker) -> None:
    with _TRACKERS_LOCK:
        _TRACKERS[:] = [r for r in _TRACKERS
                        if r() is not None and r() is not tracker]


def slo_report() -> "list[dict]":
    """Sample every registered tracker (refreshing its gauges); the
    ``/slo.json`` payload."""
    with _TRACKERS_LOCK:
        trackers = []
        live = []
        for r in _TRACKERS:
            t = r()
            if t is not None:
                trackers.append(t)
                live.append(r)
        _TRACKERS[:] = live
    out = []
    for t in trackers:
        try:
            out.append(t.sample())
        except Exception as e:  # a broken tracker must not 500 the scrape
            out.append({"slo": t.slo.name, "error": repr(e)})
    return out


def sample_all() -> None:
    """Refresh every tracker's gauges (called on /metrics scrapes so
    Prometheus sees current burn rates)."""
    slo_report()
