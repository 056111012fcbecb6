"""Process-wide metrics registry: counters, gauges, bucketed histograms.

The single spine every layer reports into: serving admission
and latency, prefetch buffer occupancy, batching pad waste, training step
times, checkpoint save/restore — one ``registry()`` call surfaces all of
it as a JSON snapshot, Prometheus exposition text, or a periodic logline
(:mod:`sparkdl_torch.observability.exporters`).

Zero-dep and thread-safe by construction: stdlib only (imported by
modules that must not pull torch, e.g. ``runtime.batching`` helpers before
a backend exists), one lock per metric family, label children resolved
once and cached so hot paths pay a dict hit + a float add.

Naming follows the Prometheus conventions: ``*_total`` counters,
``*_seconds`` histograms, lowercase snake-case label names. Histograms
are fixed-boundary cumulative buckets; ``snapshot()`` derives p50/p95/p99
by linear interpolation inside the owning bucket — coarse but monotone,
and free at scrape time.
"""

from __future__ import annotations

import math
import re
import threading
from typing import Iterable, Mapping

_NAME_RE = re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"[a-zA-Z_][a-zA-Z0-9_]*$")

#: Default histogram bucket upper bounds, tuned for seconds-scale
#: latencies from ~100µs device dispatches to multi-second restores.
DEFAULT_BUCKETS: tuple[float, ...] = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
)

#: Bucket set for percentage-valued histograms (occupancy, utilization).
PERCENT_BUCKETS: tuple[float, ...] = (
    5.0, 10.0, 20.0, 30.0, 40.0, 50.0, 60.0, 70.0, 80.0, 90.0, 95.0, 100.0,
)


def _escape_label_value(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _label_key(label_names: "tuple[str, ...]",
               labels: Mapping[str, object]) -> "tuple[str, ...]":
    if set(labels) != set(label_names):
        raise ValueError(
            f"labels {sorted(labels)} do not match declared label names "
            f"{sorted(label_names)}"
        )
    return tuple(str(labels[n]) for n in label_names)


def _render_labels(label_names: "tuple[str, ...]",
                   values: "tuple[str, ...]") -> str:
    return ",".join(
        f'{n}="{_escape_label_value(v)}"'
        for n, v in zip(label_names, values)
    )


class _Hist:
    """One histogram series: cumulative-at-render fixed buckets + sum."""

    __slots__ = ("counts", "sum", "n")

    def __init__(self, n_bounds: int):
        self.counts = [0] * (n_bounds + 1)  # last cell = +Inf overflow
        self.sum = 0.0
        self.n = 0


class _Bound:
    """A metric family bound to one label-value tuple (hot-path handle)."""

    __slots__ = ("_family", "_key")

    def __init__(self, family: "MetricFamily", key: "tuple[str, ...]"):
        self._family = family
        self._key = key

    def inc(self, value: float = 1.0) -> None:
        self._family._inc(self._key, value)

    def dec(self, value: float = 1.0) -> None:
        self._family._set_delta(self._key, -value)

    def set(self, value: float) -> None:
        self._family._set(self._key, value)

    def observe(self, value: float) -> None:
        self._family._observe(self._key, value)


class GaugeShare:
    """One contributor's share of a SUMMED process gauge.

    Several live objects (request queues, KV block pools) can feed the
    same gauge; each pushes *deltas* of its own value so neighbors are
    never clobbered. ``registry().reset()`` (test isolation) zeroes the
    gauge under every contributor — the generation stamp restarts this
    contributor's baseline at 0 instead of pushing a stale negative
    delta. Call :meth:`set` with the contributor's CURRENT value; call
    ``set(0)`` on close to retract the contribution.

    Not self-locking: callers serialize their own ``set`` (the queue's
    condition lock, the serving-engine lock).
    """

    def __init__(self, family: "MetricFamily"):
        self._family = family
        self._reported = 0.0
        self._gen = registry().generation

    def set(self, value: float) -> None:
        gen = registry().generation
        if gen != self._gen:
            self._reported = 0.0
            self._gen = gen
        if value != self._reported:
            self._family.inc(value - self._reported)
            self._reported = value


class MetricFamily:
    """One named metric (counter/gauge/histogram) with 0+ label dims."""

    def __init__(self, name: str, kind: str, help: str = "",
                 label_names: Iterable[str] = (),
                 buckets: "tuple[float, ...] | None" = None):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        label_names = tuple(label_names)
        for ln in label_names:
            if not _LABEL_RE.match(ln):
                raise ValueError(f"invalid label name {ln!r}")
        if kind not in ("counter", "gauge", "histogram"):
            raise ValueError(f"unknown metric kind {kind!r}")
        self.name = name
        self.kind = kind
        self.help = help
        self.label_names = label_names
        if kind == "histogram":
            bounds = tuple(sorted(buckets if buckets is not None
                                  else DEFAULT_BUCKETS))
            if not bounds:
                raise ValueError("histogram needs at least one bucket bound")
            self.bucket_bounds: "tuple[float, ...]" = bounds
        else:
            if buckets is not None:
                raise ValueError(f"buckets= is histogram-only, not {kind}")
            self.bucket_bounds = ()
        self._lock = threading.Lock()
        self._series: "dict[tuple[str, ...], float | _Hist]" = {}
        self._bound: "dict[tuple[str, ...], _Bound]" = {}

    # -- label binding -------------------------------------------------------
    def labels(self, **labels: object) -> _Bound:
        """Resolve (and cache) the child series for one label-value set."""
        key = _label_key(self.label_names, labels)
        with self._lock:
            b = self._bound.get(key)
            if b is None:
                b = self._bound[key] = _Bound(self, key)
            return b

    def _default_key(self) -> "tuple[str, ...]":
        if self.label_names:
            raise ValueError(
                f"metric {self.name} declares labels {self.label_names}; "
                "use .labels(...) or pass them as keyword arguments"
            )
        return ()

    # -- recording (family-level conveniences) -------------------------------
    def inc(self, value: float = 1.0, **labels: object) -> None:
        key = (_label_key(self.label_names, labels) if labels
               else self._default_key())
        self._inc(key, value)

    def dec(self, value: float = 1.0, **labels: object) -> None:
        key = (_label_key(self.label_names, labels) if labels
               else self._default_key())
        self._set_delta(key, -value)

    def set(self, value: float, **labels: object) -> None:
        key = (_label_key(self.label_names, labels) if labels
               else self._default_key())
        self._set(key, value)

    def observe(self, value: float, **labels: object) -> None:
        key = (_label_key(self.label_names, labels) if labels
               else self._default_key())
        self._observe(key, value)

    # -- storage -------------------------------------------------------------
    def _inc(self, key: "tuple[str, ...]", value: float) -> None:
        if self.kind == "counter" and value < 0:
            raise ValueError("counters only go up; use a gauge")
        if self.kind == "histogram":
            raise ValueError(f"{self.name} is a histogram; use observe()")
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + value

    def _set_delta(self, key: "tuple[str, ...]", delta: float) -> None:
        if self.kind != "gauge":
            raise ValueError(f"{self.name} is a {self.kind}; dec() is "
                             "gauge-only")
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + delta

    def _set(self, key: "tuple[str, ...]", value: float) -> None:
        if self.kind != "gauge":
            raise ValueError(f"{self.name} is a {self.kind}; set() is "
                             "gauge-only")
        with self._lock:
            self._series[key] = float(value)

    def _observe(self, key: "tuple[str, ...]", value: float) -> None:
        if self.kind != "histogram":
            raise ValueError(f"{self.name} is a {self.kind}; observe() is "
                             "histogram-only")
        with self._lock:
            h = self._series.get(key)
            if h is None:
                h = self._series[key] = _Hist(len(self.bucket_bounds))
            # first bound whose upper edge holds the value (bisect would
            # win past ~64 buckets; linear wins at the ~17 we ship)
            i = 0
            for i, b in enumerate(self.bucket_bounds):
                if value <= b:
                    break
            else:
                i = len(self.bucket_bounds)
            h.counts[i] += 1
            h.sum += value
            h.n += 1

    # -- readout -------------------------------------------------------------
    def _hist_percentile(self, h: _Hist, p: float) -> "float | None":
        """p in [0,100] by linear interpolation inside the owning bucket."""
        if h.n == 0:
            return None
        rank = (p / 100.0) * h.n
        cum = 0
        lo = 0.0
        for i, c in enumerate(h.counts):
            if c == 0:
                if i < len(self.bucket_bounds):
                    lo = self.bucket_bounds[i]
                continue
            if cum + c >= rank:
                hi = (self.bucket_bounds[i]
                      if i < len(self.bucket_bounds) else lo)
                frac = (rank - cum) / c
                return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
            cum += c
            if i < len(self.bucket_bounds):
                lo = self.bucket_bounds[i]
        return lo

    def _copy_series(self) -> "list[tuple[tuple[str, ...], float | _Hist]]":
        """Consistent point-in-time copy: _Hist objects are mutable, so
        they are deep-copied UNDER the lock — a scrape racing observe()
        must never see sum/count/buckets torn mid-update."""
        with self._lock:
            out = []
            for key, v in self._series.items():
                if isinstance(v, _Hist):
                    c = _Hist(len(self.bucket_bounds))
                    c.counts = list(v.counts)
                    c.sum, c.n = v.sum, v.n
                    v = c
                out.append((key, v))
            return out

    def snapshot_values(self) -> dict:
        out = {}
        for key, v in self._copy_series():
            label_str = _render_labels(self.label_names, key)
            if isinstance(v, _Hist):
                out[label_str] = {
                    "count": v.n,
                    "sum": v.sum,
                    "mean": (v.sum / v.n) if v.n else None,
                    "p50": self._hist_percentile(v, 50),
                    "p95": self._hist_percentile(v, 95),
                    "p99": self._hist_percentile(v, 99),
                }
            else:
                out[label_str] = v
        return out

    def count_below(self, bound: float) -> "tuple[float, int]":
        """Histogram-only: ``(observations <= bound, total observations)``
        summed across every label series, interpolating linearly inside
        the bucket that straddles ``bound`` — the same linearity as the
        percentile readout, and the SLO tracker's compliance source
        ("what fraction of requests beat the latency objective").
        Overflow-bucket observations (> the last finite bound) are never
        counted good: conservative when the objective exceeds the bucket
        range."""
        if self.kind != "histogram":
            raise ValueError(
                f"{self.name} is a {self.kind}; count_below() is "
                "histogram-only"
            )
        good = 0.0
        total = 0
        for _key, v in self._copy_series():
            total += v.n
            lo = 0.0
            for i, b in enumerate(self.bucket_bounds):
                c = v.counts[i]
                if bound >= b:
                    good += c
                else:
                    if bound > lo and b > lo:
                        good += c * (bound - lo) / (b - lo)
                    break
                lo = b
        return good, total

    def hist_series(self) -> "list[tuple[dict, dict]]":
        """Histogram-only structured readout: one ``(labels, stats)``
        pair per label series, where ``labels`` maps label name → value
        and ``stats`` is ``{count, sum, mean, p50, p95, p99}`` — the
        accessor programmatic consumers (per-tier SLO attribution, the
        bench's phase breakdown) use instead of parsing rendered
        ``snapshot_values`` label strings (a format coupling)."""
        if self.kind != "histogram":
            raise ValueError(
                f"{self.name} is a {self.kind}; hist_series() is "
                "histogram-only"
            )
        out = []
        for key, v in self._copy_series():
            out.append((dict(zip(self.label_names, key)), {
                "count": v.n,
                "sum": v.sum,
                "mean": (v.sum / v.n) if v.n else None,
                "p50": self._hist_percentile(v, 50),
                "p95": self._hist_percentile(v, 95),
                "p99": self._hist_percentile(v, 99),
            }))
        return out

    def labelled_values(self, label: str) -> dict:
        """Scalar series keyed by ONE label dimension's value —
        the structured accessor for programmatic consumers (parsing the
        rendered ``snapshot_values`` label strings is a format
        coupling). Series that collide on the chosen dimension (the
        family has other label dimensions too) are summed, never
        silently overwritten. Histogram series are skipped."""
        idx = self.label_names.index(label)
        out: dict = {}
        for key, v in self._copy_series():
            if isinstance(v, _Hist):
                continue
            out[key[idx]] = out.get(key[idx], 0.0) + v
        return out

    def render_prometheus(self, lines: "list[str]") -> None:
        items = sorted(self._copy_series())
        if not items:
            return
        if self.help:
            lines.append(f"# HELP {self.name} {self.help}")
        lines.append(f"# TYPE {self.name} {self.kind}")
        for key, v in items:
            label_str = _render_labels(self.label_names, key)
            if not isinstance(v, _Hist):
                sfx = "{%s}" % label_str if label_str else ""
                lines.append(f"{self.name}{sfx} {_fmt(v)}")
                continue
            cum = 0
            for i, bound in enumerate(self.bucket_bounds):
                cum += v.counts[i]
                ls = (label_str + "," if label_str else "") + \
                    f'le="{_fmt(bound)}"'
                lines.append(f"{self.name}_bucket{{{ls}}} {cum}")
            ls = (label_str + "," if label_str else "") + 'le="+Inf"'
            lines.append(f"{self.name}_bucket{{{ls}}} {v.n}")
            sfx = "{%s}" % label_str if label_str else ""
            lines.append(f"{self.name}_sum{sfx} {_fmt(v.sum)}")
            lines.append(f"{self.name}_count{sfx} {v.n}")


def _fmt(v: float) -> str:
    """Prometheus value formatting: integral floats render bare."""
    if math.isnan(v):
        return "NaN"
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if float(v) == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


class MetricsRegistry:
    """Collection of :class:`MetricFamily` keyed by name.

    ``counter``/``gauge``/``histogram`` are get-or-create: the first call
    declares the family (help text, label names, buckets), later calls
    return the same object and must agree on kind and label names —
    mismatches raise instead of silently splitting a metric.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._families: "dict[str, MetricFamily]" = {}
        #: bumped by reset(); delta-reporting instrumentation (e.g. the
        #: queue-depth gauge) compares it to know its baseline was wiped
        self.generation = 0

    # -- declaration ---------------------------------------------------------
    def counter(self, name: str, help: str = "",
                labels: Iterable[str] = ()) -> MetricFamily:
        return self._get_or_create(name, "counter", help, labels, None)

    def gauge(self, name: str, help: str = "",
              labels: Iterable[str] = ()) -> MetricFamily:
        return self._get_or_create(name, "gauge", help, labels, None)

    def histogram(self, name: str, help: str = "",
                  labels: Iterable[str] = (),
                  buckets: "tuple[float, ...] | None" = None) -> MetricFamily:
        return self._get_or_create(name, "histogram", help, labels, buckets)

    def _get_or_create(self, name, kind, help, labels, buckets):
        labels = tuple(labels)
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = self._families[name] = MetricFamily(
                    name, kind, help=help, label_names=labels,
                    buckets=buckets,
                )
                return fam
        if fam.kind != kind or fam.label_names != labels:
            raise ValueError(
                f"metric {name} already registered as {fam.kind} with "
                f"labels {fam.label_names}; requested {kind} with {labels}"
            )
        # buckets=None means "whatever it was declared with"; an explicit
        # disagreeing set would silently land observations in boundaries
        # the caller never asked for
        if buckets is not None and tuple(sorted(buckets)) != fam.bucket_bounds:
            raise ValueError(
                f"histogram {name} already registered with buckets "
                f"{fam.bucket_bounds}; requested {tuple(sorted(buckets))}"
            )
        return fam

    def get(self, name: str) -> "MetricFamily | None":
        with self._lock:
            return self._families.get(name)

    # -- export --------------------------------------------------------------
    def snapshot(self) -> dict:
        """JSON-able point-in-time view of every series.

        ``{name: {"type": ..., "help": ..., "values": {label_str: value}}}``
        — histogram values are ``{count, sum, mean, p50, p95, p99}`` dicts.
        Families with no recorded series are omitted (declaring a metric
        is free; only activity shows up).
        """
        with self._lock:
            fams = list(self._families.values())
        out = {}
        for fam in fams:
            values = fam.snapshot_values()
            if values:
                out[fam.name] = {
                    "type": fam.kind,
                    "help": fam.help,
                    "values": values,
                }
        return out

    def to_prometheus(self) -> str:
        """Prometheus/OpenMetrics text exposition of every series."""
        lines: "list[str]" = []
        with self._lock:
            fams = sorted(self._families.values(), key=lambda f: f.name)
        for fam in fams:
            fam.render_prometheus(lines)
        return "\n".join(lines) + ("\n" if lines else "")

    def reset(self) -> None:
        """Zero every series, KEEPING declarations (test isolation).

        Instrumented modules cache family handles at import; dropping the
        families would orphan those handles, so reset clears values only.
        The generation bump tells delta-reporting callers their previously
        pushed contributions are gone.
        """
        with self._lock:
            fams = list(self._families.values())
            self.generation += 1
        for fam in fams:
            with fam._lock:
                fam._series.clear()


#: The process-global registry every layer reports into.
_REGISTRY = MetricsRegistry()


def registry() -> MetricsRegistry:
    """The process-wide :class:`MetricsRegistry` (the single spine)."""
    return _REGISTRY


def flatten_snapshot(snap: "dict | None" = None) -> "dict[str, float]":
    """Flatten ``registry().snapshot()`` to ``{series_key: float}``.

    Key shape: ``name{labels}`` for scalars, ``name{labels}:field`` for
    histogram fields — the flat numeric dict
    :func:`sparkdl_torch.observability.metrics.aggregate_across_hosts`
    reduces across hosts.
    """
    if snap is None:
        snap = registry().snapshot()
    flat: "dict[str, float]" = {}
    for name, fam in snap.items():
        for label_str, v in fam["values"].items():
            key = f"{name}{{{label_str}}}" if label_str else name
            if isinstance(v, dict):
                for field, fv in v.items():
                    if isinstance(fv, (int, float)):
                        flat[f"{key}:{field}"] = float(fv)
            elif isinstance(v, (int, float)):
                flat[key] = float(v)
    return flat


def snapshot_across_hosts() -> dict:
    """All-ranks mean/min/max of every numeric series, over the default
    process group (every rank must call it, like any collective).

    ``aggregate_across_hosts`` needs an IDENTICAL key set on every rank,
    but registries diverge under data-dependent instrumentation (a
    failure counter exists only on the rank that saw a failure), so the
    key sets are unioned first (an all-gather of each rank's keys) and a
    missing series rides as None (NaN in the reduce). The runner's
    epilogue (``TorchRunner(metrics_summary=True)``) rolls the ranks'
    registries up with it.
    """
    import torch.distributed as dist

    from sparkdl_torch.observability.metrics import aggregate_across_hosts

    flat = flatten_snapshot()
    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        key_lists: "list[list[str] | None]" = [None] * dist.get_world_size()
        dist.all_gather_object(key_lists, sorted(flat))
        union = sorted({k for ks in key_lists for k in (ks or [])})
        flat = {k: flat.get(k) for k in union}
    return aggregate_across_hosts(flat)
