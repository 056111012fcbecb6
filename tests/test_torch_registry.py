"""MetricsRegistry semantics: counters/gauges/histograms, threads, export.

The port's copy (sparkdl_torch/observability), after the JAX package's
suite tests/observability/test_registry.py; the cases of modules the
port does not carry (the exporters' HTTP server, the serving queue) are
left out.
"""

import json
import threading
import urllib.request

import pytest

from sparkdl_torch.observability.registry import (
    MetricsRegistry,
    flatten_snapshot,
    registry,
)


class TestFamilies:
    def test_counter_accumulates_and_rejects_negative(self):
        r = MetricsRegistry()
        c = r.counter("requests_total", "help")
        c.inc()
        c.inc(2.5)
        assert r.snapshot()["requests_total"]["values"][""] == 3.5
        with pytest.raises(ValueError, match="only go up"):
            c.inc(-1)

    def test_gauge_set_inc_dec(self):
        r = MetricsRegistry()
        g = r.gauge("depth")
        g.set(10)
        g.inc(5)
        g.dec(2)
        assert r.snapshot()["depth"]["values"][""] == 13.0

    def test_labels_split_series_and_validate(self):
        r = MetricsRegistry()
        c = r.counter("reqs_total", labels=("outcome",))
        c.inc(outcome="ok")
        c.inc(2, outcome="fail")
        c.labels(outcome="ok").inc()
        vals = r.snapshot()["reqs_total"]["values"]
        assert vals['outcome="ok"'] == 2.0
        assert vals['outcome="fail"'] == 2.0
        with pytest.raises(ValueError, match="do not match"):
            c.inc(wrong="x")
        with pytest.raises(ValueError, match="use .labels"):
            c.inc()  # labeled family needs its labels

    def test_labelled_values_structured_access(self):
        r = MetricsRegistry()
        c = r.counter("shed_total", labels=("reason", "site"))
        c.inc(reason="expired", site="q")
        c.inc(3, reason="closed", site="q")
        # keyed by ONE label's raw value — no parsing of rendered
        # 'reason="..."' strings
        assert r.get("shed_total").labelled_values("reason") == {
            "expired": 1.0, "closed": 3.0,
        }
        # series colliding on the chosen dimension are SUMMED (here:
        # reason="expired" across two sites), never silently last-wins
        c.inc(5, reason="expired", site="other")
        assert r.get("shed_total").labelled_values("reason") == {
            "expired": 6.0, "closed": 3.0,
        }
        with pytest.raises(ValueError):
            r.get("shed_total").labelled_values("nope")

    def test_redeclaration_must_agree(self):
        r = MetricsRegistry()
        c1 = r.counter("n_total", "first help")
        assert r.counter("n_total") is c1  # get-or-create
        with pytest.raises(ValueError, match="already registered"):
            r.gauge("n_total")
        with pytest.raises(ValueError, match="already registered"):
            r.counter("n_total", labels=("x",))

    def test_kind_method_mismatch_raises(self):
        r = MetricsRegistry()
        with pytest.raises(ValueError, match="histogram"):
            r.counter("c_total").observe(1.0)
        with pytest.raises(ValueError, match="observe"):
            r.histogram("h_seconds").inc()
        with pytest.raises(ValueError, match="gauge-only"):
            r.counter("c2_total").set(3)

    def test_invalid_names_rejected(self):
        r = MetricsRegistry()
        with pytest.raises(ValueError, match="invalid metric name"):
            r.counter("bad-name")
        with pytest.raises(ValueError, match="invalid label name"):
            r.counter("ok_total", labels=("bad-label",))

    def test_histogram_buckets_and_percentiles(self):
        r = MetricsRegistry()
        h = r.histogram("lat_seconds", buckets=(0.01, 0.1, 1.0))
        for v in (0.005, 0.05, 0.5, 2.0):
            h.observe(v)
        snap = r.snapshot()["lat_seconds"]["values"][""]
        assert snap["count"] == 4
        assert snap["sum"] == pytest.approx(2.555)
        assert snap["mean"] == pytest.approx(2.555 / 4)
        # interpolated within owning buckets, monotone in p
        assert 0.01 <= snap["p50"] <= 0.1
        assert snap["p50"] <= snap["p95"] <= snap["p99"]

    def test_histogram_redeclaration_must_agree_on_buckets(self):
        r = MetricsRegistry()
        h = r.histogram("lat_seconds", buckets=(0.1, 0.5))
        # None = "whatever it was declared with"; explicit same set OK
        assert r.histogram("lat_seconds") is h
        assert r.histogram("lat_seconds", buckets=(0.5, 0.1)) is h
        with pytest.raises(ValueError, match="already registered with "
                                             "buckets"):
            r.histogram("lat_seconds", buckets=(1.0, 2.0))

    def test_empty_families_omitted_from_snapshot(self):
        r = MetricsRegistry()
        r.counter("declared_total")
        assert r.snapshot() == {}


class TestThreads:
    def test_counter_exact_under_contention(self):
        r = MetricsRegistry()
        c = r.counter("hits_total", labels=("t",))
        n_threads, per = 8, 5000

        def work(i):
            bound = c.labels(t=str(i % 2))
            for _ in range(per):
                bound.inc()

        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        vals = r.snapshot()["hits_total"]["values"]
        assert vals['t="0"'] + vals['t="1"'] == n_threads * per

    def test_histogram_exact_count_under_contention(self):
        r = MetricsRegistry()
        h = r.histogram("obs_seconds", buckets=(0.5,))
        n_threads, per = 8, 5000

        def work():
            for i in range(per):
                h.observe(i % 2)  # half under, half over the bound

        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        snap = r.snapshot()["obs_seconds"]["values"][""]
        assert snap["count"] == n_threads * per
        assert snap["sum"] == n_threads * per / 2


class TestPrometheus:
    def test_exposition_golden(self):
        """Full text-format output, byte for byte (scrapers are picky)."""
        r = MetricsRegistry()
        c = r.counter("sparkdl_requests_total", "finished requests",
                      labels=("outcome",))
        c.inc(3, outcome="ok")
        c.inc(outcome="fail")
        r.gauge("sparkdl_queue_depth", "queued now").set(7)
        h = r.histogram("sparkdl_wait_seconds", "queue wait",
                        buckets=(0.01, 0.1, 1.0))
        for v in (0.005, 0.05, 0.5, 0.25):
            h.observe(v)
        assert r.to_prometheus() == (
            "# HELP sparkdl_queue_depth queued now\n"
            "# TYPE sparkdl_queue_depth gauge\n"
            "sparkdl_queue_depth 7\n"
            "# HELP sparkdl_requests_total finished requests\n"
            "# TYPE sparkdl_requests_total counter\n"
            'sparkdl_requests_total{outcome="fail"} 1\n'
            'sparkdl_requests_total{outcome="ok"} 3\n'
            "# HELP sparkdl_wait_seconds queue wait\n"
            "# TYPE sparkdl_wait_seconds histogram\n"
            'sparkdl_wait_seconds_bucket{le="0.01"} 1\n'
            'sparkdl_wait_seconds_bucket{le="0.1"} 2\n'
            'sparkdl_wait_seconds_bucket{le="1"} 4\n'
            'sparkdl_wait_seconds_bucket{le="+Inf"} 4\n'
            "sparkdl_wait_seconds_sum 0.805\n"
            "sparkdl_wait_seconds_count 4\n"
        )

    def test_nan_and_inf_values_render(self):
        r = MetricsRegistry()
        r.gauge("weird").set(float("nan"))
        r.gauge("hot").set(float("inf"))
        text = r.to_prometheus()  # a NaN gauge must not break scrapes
        assert "weird NaN" in text
        assert "hot +Inf" in text

    def test_label_value_escaping(self):
        r = MetricsRegistry()
        r.counter("esc_total", labels=("k",)).inc(k='a"b\\c\nd')
        text = r.to_prometheus()
        assert 'esc_total{k="a\\"b\\\\c\\nd"} 1' in text

class TestGlobalRegistry:
    def test_reset_keeps_declarations(self):
        """Instrumented modules cache family handles at import; reset()
        must zero values without orphaning those handles."""
        r = registry()
        fam = r.counter("sparkdl_reset_probe_total")
        fam.inc(3)
        r.reset()
        assert "sparkdl_reset_probe_total" not in r.snapshot()
        fam.inc()  # the cached handle still reaches the registry
        assert r.snapshot()["sparkdl_reset_probe_total"]["values"][""] == 1

    def test_flatten_snapshot(self):
        r = MetricsRegistry()
        r.counter("a_total").inc(2)
        h = r.histogram("b_seconds", buckets=(1.0,))
        h.observe(0.5)
        flat = flatten_snapshot(r.snapshot())
        assert flat["a_total"] == 2.0
        assert flat["b_seconds:count"] == 1.0
        assert flat["b_seconds:sum"] == 0.5


def test_cross_host_rollup_is_not_ported():
    """The roll-up is ported (ROADMAP A8, TorchRunner): with no process
    group it is this process's series as mean = min = max
    (tests/test_torch_runner.py rolls two ranks up)."""
    from sparkdl_torch.observability.registry import (
        flatten_snapshot,
        snapshot_across_hosts,
    )

    registry().counter("sparkdl_rollup_probe_total").inc(3)
    agg = snapshot_across_hosts()
    flat = flatten_snapshot()
    assert set(agg) <= set(flat)
    assert agg["sparkdl_rollup_probe_total"]["mean"] == \
        agg["sparkdl_rollup_probe_total"]["min"] == \
        flat["sparkdl_rollup_probe_total"]


def test_snapshot_and_exposition_match_the_jax_registry():
    """The same declarations and observations in both registries: the
    same snapshot and the same Prometheus text."""
    from sparkdl_tpu.observability.registry import MetricsRegistry as JaxRegistry

    def fill(r):
        c = r.counter("t_reqs_total", "requests", labels=("outcome",))
        c.inc(outcome="ok")
        c.inc(2.5, outcome="fail")
        r.gauge("t_depth", "depth").set(7)
        h = r.histogram("t_lat_seconds", "latency", buckets=(0.01, 0.1, 1.0))
        for v in (0.005, 0.05, 0.05, 0.5, 2.0):
            h.observe(v)
        return r

    mine, theirs = fill(MetricsRegistry()), fill(JaxRegistry())
    assert mine.snapshot() == theirs.snapshot()
    assert mine.to_prometheus() == theirs.to_prometheus()
