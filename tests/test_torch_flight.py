"""Flight recorder: ring semantics, postmortem bundles, healthz.

The port's copy (sparkdl_torch/observability), after the JAX package's
suite tests/observability/test_flight.py.
"""

import json
import os
import time

import pytest

from sparkdl_torch.observability import flight, tracing
from sparkdl_torch.observability.flight import FlightRecorder


def _read_json(path):
    with open(path) as f:
        return json.load(f)


class TestRing:
    def test_events_ordered_and_bounded(self):
        rec = FlightRecorder(capacity=4)
        for i in range(10):
            rec.record("k", i=i)
        evs = rec.events()
        assert len(evs) == 4
        assert [e["i"] for e in evs] == [6, 7, 8, 9]
        # seq is monotone and survives eviction
        assert [e["seq"] for e in evs] == [7, 8, 9, 10]
        assert rec.events_total == 10

    def test_event_shape(self):
        rec = FlightRecorder()
        rec.record("replica.quarantined", replica=3, failures=2)
        (ev,) = rec.events()
        assert ev["kind"] == "replica.quarantined"
        assert ev["replica"] == 3 and ev["failures"] == 2
        assert ev["t"] == pytest.approx(time.time(), abs=5.0)

    def test_events_last_n(self):
        rec = FlightRecorder()
        for i in range(6):
            rec.record("k", i=i)
        assert [e["i"] for e in rec.events(last=2)] == [4, 5]

    def test_configure_capacity_keeps_events(self):
        rec = FlightRecorder(capacity=8)
        for i in range(5):
            rec.record("k", i=i)
        rec.configure(capacity=3)
        assert [e["i"] for e in rec.events()] == [2, 3, 4]


class TestDump:
    def test_bundle_contents(self):
        rec = FlightRecorder()
        rec.record("fault.injected", site="dispatch")
        name = flight.add_context_provider(
            "test-bundle-ctx", lambda: {"depth": 7})
        try:
            bundle = rec.dump("unit_test", extra={"note": "hi"})
        finally:
            flight.remove_context_provider(name)
        assert bundle["reason"] == "unit_test"
        assert bundle["events"][-1]["kind"] == "fault.injected"
        assert bundle["context"]["test-bundle-ctx"] == {"depth": 7}
        assert isinstance(bundle["registry"], dict)
        assert bundle["extra"] == {"note": "hi"}

    def test_provider_error_captured_not_raised(self):
        rec = FlightRecorder()

        def broken():
            raise RuntimeError("provider died")

        name = flight.add_context_provider("test-broken-ctx", broken)
        try:
            bundle = rec.dump("unit_test")
        finally:
            flight.remove_context_provider(name)
        assert "provider died" in bundle["context"]["test-broken-ctx"]["error"]

    def test_inflight_traces_resolved(self):
        tracing.enable_tracing()
        tracing.clear_trace()
        try:
            rid = tracing.next_request_id()
            ctx = tracing.request_context(rid)
            tracing.record_span("serving.queue_wait", 0.0, 0.001,
                                parent=ctx, request_id=rid)
            name = flight.add_context_provider(
                "test-inflight-ctx",
                lambda: {"inflight_request_ids": [rid]})
            try:
                bundle = FlightRecorder().dump("unit_test")
            finally:
                flight.remove_context_provider(name)
            spans = bundle["inflight_traces"][str(rid)]
            assert any(s["name"] == "serving.queue_wait" for s in spans)
        finally:
            tracing.disable_tracing()
            tracing.clear_trace()

    def test_write_postmortem_and_retention(self, tmp_path):
        rec = FlightRecorder(directory=str(tmp_path), max_bundles=2)
        rec.record("k")
        paths = [rec.write_postmortem(f"r{i}") for i in range(3)]
        assert all(p is not None for p in paths)
        kept = sorted(os.listdir(tmp_path))
        assert len(kept) == 2  # pruned to max_bundles
        bundle = json.loads((tmp_path / kept[-1]).read_text())
        assert bundle["reason"] == "r2"
        assert rec.last_path == paths[-1]

    def test_write_postmortem_without_directory(self):
        rec = FlightRecorder(directory=None)
        rec.record("k")
        assert rec.write_postmortem("no_dir") is None
        assert rec.last_bundle["reason"] == "no_dir"


class TestTriggers:
    def test_trigger_records_event_and_dumps_inline(self, tmp_path):
        rec = FlightRecorder(directory=str(tmp_path), settle_s=0.0,
                             min_interval_s=0.0)
        rec.trigger_dump("replica_quarantined", replica=1)
        assert rec.events()[0]["kind"] == "trigger"
        assert rec.events()[0]["reason"] == "replica_quarantined"
        assert rec.last_path is not None
        bundle = _read_json(rec.last_path)
        assert bundle["reason"] == "replica_quarantined"

    def test_trigger_rate_limited(self, tmp_path):
        rec = FlightRecorder(directory=str(tmp_path), settle_s=0.0,
                             min_interval_s=60.0)
        rec.trigger_dump("first")
        rec.trigger_dump("second")  # inside min_interval: suppressed
        assert len(os.listdir(tmp_path)) == 1
        # both trigger EVENTS are still in the ring
        assert [e["reason"] for e in rec.events()
                if e["kind"] == "trigger"] == ["first", "second"]

    def test_settle_override_dumps_inline(self, tmp_path):
        # the fatal-error form (checkpoint corruption raises right after
        # the trigger): settle_s=0 must write BEFORE returning, else the
        # daemon timer dies with the process
        rec = FlightRecorder(directory=str(tmp_path), settle_s=60.0,
                             min_interval_s=0.0)
        rec.trigger_dump("checkpoint_corrupt", settle_s=0)
        assert rec.last_path is not None
        assert len(os.listdir(tmp_path)) == 1

    def test_inline_override_beats_coalesce_and_rate_limit(self, tmp_path):
        # a pending settled trigger AND an active rate-limit window must
        # not suppress the fatal-path inline dump — "a recent bundle
        # covers this" is never true when the process is about to die
        rec = FlightRecorder(directory=str(tmp_path), settle_s=60.0,
                             min_interval_s=3600.0)
        rec.trigger_dump("replica_quarantined")     # schedules 60s timer
        assert rec.last_path is None                # nothing written yet
        rec.trigger_dump("checkpoint_corrupt", settle_s=0)
        assert rec.last_path is not None
        bundle = _read_json(rec.last_path)
        assert bundle["reason"] == "checkpoint_corrupt"
        assert len(os.listdir(tmp_path)) == 1  # pending timer cancelled

    def test_settled_trigger_coalesces(self, tmp_path):
        rec = FlightRecorder(directory=str(tmp_path), settle_s=0.05,
                             min_interval_s=0.0)
        rec.trigger_dump("a")
        rec.trigger_dump("b")  # coalesces into a's pending dump
        deadline = time.monotonic() + 5.0
        while rec.last_path is None and time.monotonic() < deadline:
            time.sleep(0.01)
        assert rec.last_path is not None
        time.sleep(0.1)  # no second dump materializes
        assert len(os.listdir(tmp_path)) == 1
        # the settle window captured BOTH trigger events
        reasons = [e["reason"] for e in rec.last_bundle["events"]
                   if e["kind"] == "trigger"]
        assert reasons == ["a", "b"]


class TestHealthz:
    def test_ok_with_no_pools(self):
        # the integrity fact is process-sticky (checkpoint-corruption
        # tests legitimately set it earlier in the run): isolate it
        prev = flight.health_facts().get("checkpoint_integrity")
        flight.set_health_fact("checkpoint_integrity", None)
        try:
            report = flight.healthz_report()
            assert report["status"] in ("ok", "degraded")  # providers may
            assert report["retry_budget"]["initial"] >= 0  # be left over
        finally:
            flight.set_health_fact("checkpoint_integrity", prev)

    def test_pool_states_drive_status(self):
        name = flight.add_context_provider(
            "test-hz-pool",
            lambda: {"replica_count": 2, "healthy_count": 1})
        try:
            report = flight.healthz_report()
            (pool,) = [p for p in report["replica_pools"]
                       if p.get("provider") == "test-hz-pool"]
            assert pool["quarantined_count"] == 1
            assert report["status"] in ("degraded", "unhealthy")
        finally:
            flight.remove_context_provider(name)

    def test_zero_healthy_is_unhealthy(self):
        name = flight.add_context_provider(
            "test-hz-dead-pool",
            lambda: {"replica_count": 2, "healthy_count": 0})
        try:
            assert flight.healthz_report()["status"] == "unhealthy"
        finally:
            flight.remove_context_provider(name)

    def test_corrupt_checkpoint_fact_is_unhealthy(self):
        prev = flight.health_facts().get("checkpoint_integrity")
        flight.set_health_fact(
            "checkpoint_integrity", {"verdict": "corrupt"})
        try:
            assert flight.healthz_report()["status"] == "unhealthy"
        finally:
            flight.set_health_fact("checkpoint_integrity", prev)

    def test_soft_checkpoint_verdicts_only_degrade(self):
        # pinned-step corruption and ambiguous every-candidate failures
        # must not 503 a host that can still serve (and may still have
        # intact newer history / a caller-side template bug)
        prev = flight.health_facts().get("checkpoint_integrity")
        try:
            for fact in ({"verdict": "corrupt", "pinned": True},
                         {"verdict": "unreadable"},
                         {"verdict": "fallback"}):
                flight.set_health_fact("checkpoint_integrity", fact)
                status = flight.healthz_report()["status"]
                assert status != "unhealthy", (fact, status)
        finally:
            flight.set_health_fact("checkpoint_integrity", prev)

    def test_dead_provider_owner_self_prunes(self):
        class Owner:
            def context(self):
                return {"depth": 1}

        owner = Owner()
        name = flight.add_context_provider("test-hz-weak", owner.context)
        try:
            assert any(n == "test-hz-weak"
                       for n, _ in flight._providers_snapshot())
            del owner  # dropped WITHOUT remove_context_provider
            import gc

            gc.collect()
            assert not any(n == "test-hz-weak"
                           for n, _ in flight._providers_snapshot())
        finally:
            flight.remove_context_provider("test-hz-weak")

    def test_provider_error_degrades_not_pollutes(self):
        def broken():
            raise RuntimeError("hz provider died")

        prev = flight.health_facts().get("checkpoint_integrity")
        flight.set_health_fact("checkpoint_integrity", None)
        name = flight.add_context_provider("test-hz-broken", broken)
        try:
            report = flight.healthz_report()
            # unknown-shape errors never masquerade as pools...
            assert not any(p.get("provider") == "test-hz-broken"
                           for p in report["replica_pools"])
            (err,) = [e for e in report["provider_errors"]
                      if e["provider"] == "test-hz-broken"]
            assert "hz provider died" in err["error"]
            # ...but unobservable state must not read as healthy
            assert report["status"] in ("degraded", "unhealthy")
        finally:
            flight.remove_context_provider(name)
            flight.set_health_fact("checkpoint_integrity", prev)

    def test_span_events_ride_their_own_ring(self):
        from sparkdl_torch.observability.flight import FlightRecorder

        rec = FlightRecorder(capacity=4)
        rec.record("replica.quarantined", replica=1)
        for i in range(100):  # a span storm
            rec.record_span_event("serving.device_step", span_id=i)
        # the reliability event SURVIVES; spans are bounded separately
        assert [e["kind"] for e in rec.events()] == ["replica.quarantined"]
        assert len(rec.span_events()) == 4
        assert rec.events_total == 101
        bundle = rec.dump("unit")
        assert bundle["events"][0]["kind"] == "replica.quarantined"
        assert bundle["span_events"][-1]["name"] == "serving.device_step"

    def test_engine_provider_not_mistaken_for_pool(self):
        # engine-level providers (no healthy_count) must not show as pools
        name = flight.add_context_provider(
            "test-hz-engine", lambda: {"queue_depth": 3})
        try:
            report = flight.healthz_report()
            assert not any(p.get("provider") == "test-hz-engine"
                           for p in report["replica_pools"])
        finally:
            flight.remove_context_provider(name)


class TestOverhead:
    def test_append_stays_cheap(self):
        """The disabled-path guard: record() sits next to
        retries and span completions. Generous CI bound; the strict
        share-of-a-dispatch guard lives in run-tests.sh."""
        rec = FlightRecorder()
        n = 20_000
        best = float("inf")
        for _ in range(5):
            t0 = time.perf_counter()
            for _ in range(n):
                rec.record("overhead", site="x")
            best = min(best, (time.perf_counter() - t0) / n)
        assert best < 5e-6, f"flight append costs {best * 1e9:.0f}ns"
