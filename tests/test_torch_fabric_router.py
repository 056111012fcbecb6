"""Router unit tests over scripted fake hosts: placement scoring,
spillover, sticky sessions, quarantine/probation, failover, fault
sites — every contract that does not need a live engine (those live in
test_fabric_engines.py / test_fabric_chaos.py).
"""

import threading
import time
from concurrent.futures import Future

import pytest

from sparkdl_torch.fabric import (
    AllHostsUnavailableError,
    HostDrainingError,
    HostHandle,
    Router,
)
from sparkdl_torch.fabric.digest import prompt_block_hashes
from sparkdl_torch.observability import flight
from sparkdl_torch.observability.registry import registry
from sparkdl_torch.reliability.faults import fault_point, inject
from sparkdl_torch.serving import QueueFullError

from torch_fabric_fakes import FakeHost, fast_postmortems  # noqa: F401
from torch_fabric_fakes import gpt_payload as _gpt_payload
from torch_fabric_fakes import make_router as _router
from torch_fabric_fakes import metric as _metric

BS = 4


# -- construction validation --------------------------------------------------

def test_router_validation():
    with pytest.raises(ValueError, match="policy"):
        _router([FakeHost("a")], policy="random")
    with pytest.raises(ValueError, match="at least one host"):
        _router([])
    with pytest.raises(ValueError, match="duplicate host ids"):
        _router([FakeHost("a"), FakeHost("a")])
    with pytest.raises(ValueError, match="affinity_cap_blocks"):
        _router([FakeHost("a")], affinity_cap_blocks=-1)
    with pytest.raises(ValueError, match="max_failures"):
        _router([FakeHost("a")], max_failures=0)
    with pytest.raises(ValueError, match="probation_s"):
        _router([FakeHost("a")], probation_s=0.0)


def test_closed_router_rejects_submit():
    r = _router([FakeHost("a")])
    r.close()
    with pytest.raises(RuntimeError, match="closed"):
        r.submit(_gpt_payload())
    r.close()  # idempotent


# -- load / weighting ---------------------------------------------------------

def test_least_outstanding_work_spreads_load():
    a, b = FakeHost("a"), FakeHost("b")
    hold = threading.Event()
    a.hold = b.hold = hold
    with _router([a, b]) as r:
        futs = [r.submit(_gpt_payload()) for _ in range(8)]
        hold.set()
        assert sorted(f.result(5) for f in futs) == ["a"] * 4 + ["b"] * 4


def test_capacity_weighting_absorbs_proportionally():
    """A 4-slot host legitimately absorbs 4x a 1-slot host's depth
    before looking equally busy."""
    big = FakeHost("big", n_slots=4)
    small = FakeHost("small", n_slots=1)
    hold = threading.Event()
    big.hold = small.hold = hold
    with _router([big, small]) as r:
        futs = [r.submit(_gpt_payload()) for _ in range(10)]
        hold.set()
        got = [f.result(5) for f in futs]
    assert got.count("big") == 8 and got.count("small") == 2


def test_round_robin_policy_alternates():
    a, b = FakeHost("a"), FakeHost("b")
    with _router([a, b], policy="round_robin") as r:
        got = [r.submit(_gpt_payload()).result(5) for _ in range(6)]
    assert got.count("a") == 3 and got.count("b") == 3


# -- affinity -----------------------------------------------------------------

def test_affinity_prefers_digest_holder():
    prompt = list(range(9))
    hs = prompt_block_hashes(prompt, BS)
    warm = FakeHost("warm", digest_hashes=hs)
    cold = FakeHost("cold", digest_hashes=[])
    with _router([cold, warm]) as r:
        got = [r.submit(_gpt_payload(prompt)).result(5)
               for _ in range(3)]
    assert got == ["warm"] * 3
    assert _metric("sparkdl_fabric_affinity_hits_total",
                   'host="warm"') >= 3


def test_affinity_cap_prevents_hotspot():
    """The anti-hotspot trade: past the cap, more cached prefix buys
    nothing, so load drags a hot prefix's overflow onto the cold host
    even while the hot host still holds every block."""
    prompt = list(range(4 * 12 + 1))  # 12 blocks cached on `hot`
    hs = prompt_block_hashes(prompt, BS, max_blocks=64)
    # n_slots=1 -> capacity weight 1: the arithmetic below is in raw
    # outstanding units
    hot = FakeHost("hot", digest_hashes=hs, n_slots=1)
    cold = FakeHost("cold", digest_hashes=[], n_slots=1)
    hold = threading.Event()
    hot.hold = cold.hold = hold
    with _router([hot, cold], affinity_cap_blocks=2,
                 affinity_weight=1.0, load_weight=1.0) as r:
        futs = [r.submit(_gpt_payload(prompt)) for _ in range(10)]
        hold.set()
        got = [f.result(5) for f in futs]
    # bonus(hot)=2: hot wins placements 1-2 (load 0,1), ties at load 2
    # -> the overflow spreads instead of piling onto one host
    assert got.count("cold") >= 4, got


def test_unknown_block_size_scores_zero_affinity():
    """A digest on a grid the prompt was not hashed for is worth zero
    this placement — never a KeyError (the pre-lock hash snapshot can
    race a refresh that swaps in a different block size)."""
    import dataclasses as dc

    prompt = list(range(9))
    weird = FakeHost("weird",
                     digest_hashes=prompt_block_hashes(prompt, 2),
                     block_size=2)
    with _router([weird]) as r:
        r._hosts["weird"].digest = dc.replace(
            r._hosts["weird"].digest, block_size=16)
        assert r.submit(_gpt_payload(prompt)).result(5) == "weird"


# -- sticky sessions ----------------------------------------------------------

def test_sticky_session_follows_host():
    a, b = FakeHost("a"), FakeHost("b")
    with _router([a, b]) as r:
        first = r.submit(_gpt_payload(), session="s1").result(5)
        # pile load on the sticky host: stickiness must still win
        stuck = r._hosts[first]
        with r._lock:
            stuck.outstanding += 3
        assert r.submit(_gpt_payload(), session="s1").result(5) == first
    # stickiness is DERIVED, not remembered: a fresh router
    # over the same hosts sends the same session to the same host, so a
    # router restart (empty LRU) cannot scatter conversations
    with _router([FakeHost("a"), FakeHost("b")]) as r2:
        assert r2.submit(_gpt_payload(), session="s1").result(5) == first


def test_sticky_session_capacity_bounded():
    a = FakeHost("a")
    with _router([a], session_capacity=2) as r:
        for i in range(5):
            r.submit(_gpt_payload(), session=f"s{i}").result(5)
        assert len(r._sessions) == 2


def test_drain_never_transfers_to_quarantined_host():
    """Regression: a drain transfer bypasses the router's
    completion callbacks, so it must never pick a quarantined host as a
    probation probe — the probe slot would leak (permanent quarantine)
    and the requests could land in a dead host's queue, hanging their
    Futures. With every survivor quarantined, the transfer must FAIL
    the requests typed (counted once) rather than hang them."""
    from sparkdl_torch.serving.queue import RequestQueue

    a, b = FakeHost("a"), FakeHost("b")
    b.fail_with = ConnectionError("down")
    with _router([a, b], max_failures=1, probation_s=0.01) as r:
        r.submit(_gpt_payload()).result(5)  # a takes it
        with r._lock:
            r._hosts["a"].outstanding += 5
        r.submit(_gpt_payload()).result(5)  # forced onto b: quarantined
        with r._lock:
            r._hosts["a"].outstanding -= 5
        assert r._hosts["b"].quarantined
        time.sleep(0.03)  # b is now probe-DUE, but transfers must skip it
        src = RequestQueue(max_depth=4)
        fut = src.submit(_gpt_payload())
        src.close()
        r._hosts["a"].draining = True  # only quarantined b remains
        moved = r._requeue_requests(src.extract_pending())
        assert moved == 0
        with pytest.raises(AllHostsUnavailableError):
            fut.result(5)  # failed typed, not hung
        assert not r._hosts["b"].probing  # probe slot never consumed
        assert b.submits == []  # nothing handed to the dead host


def test_sticky_broken_by_drain():
    a, b = FakeHost("a"), FakeHost("b")
    with _router([a, b]) as r:
        first = r.submit(_gpt_payload(), session="s").result(5)
        r.drain_host(first)
        got = r.submit(_gpt_payload(), session="s").result(5)
        assert got != first


# -- spillover / saturation ---------------------------------------------------

def test_spillover_diverts_from_saturated_preferred():
    prompt = list(range(17))  # 4 cached blocks: bonus outbids the load
    hs = prompt_block_hashes(prompt, BS)
    warm = FakeHost("warm", digest_hashes=hs)
    cold = FakeHost("cold", digest_hashes=[])
    hold = threading.Event()
    warm.hold = cold.hold = hold
    with _router([warm, cold], max_outstanding=2) as r:
        futs = [r.submit(_gpt_payload(prompt)) for _ in range(4)]
        hold.set()
        got = [f.result(5) for f in futs]
    assert got.count("warm") == 2 and got.count("cold") == 2
    assert _metric("sparkdl_fabric_spillover_total", 'host="cold"') >= 2


def test_all_saturated_rejects_queuefull():
    a = FakeHost("a")
    a.hold = threading.Event()
    with _router([a], max_outstanding=1) as r:
        fut = r.submit(_gpt_payload())
        with pytest.raises(QueueFullError, match="saturated"):
            r.submit(_gpt_payload())
        a.hold.set()
        fut.result(5)


# -- health / quarantine / probation -----------------------------------------

def test_unhealthy_host_excluded_until_refresh():
    a, b = FakeHost("a"), FakeHost("b")
    with _router([a, b]) as r:
        a.status = "unhealthy"
        r.refresh()
        got = {r.submit(_gpt_payload()).result(5) for _ in range(4)}
        assert got == {"b"}
        a.status = "ok"
        r.refresh()
        got = {r.submit(_gpt_payload()).result(5) for _ in range(4)}
        assert "a" in got


def test_all_hosts_unavailable_raises_and_dumps(wait_until):
    a = FakeHost("a")
    with _router([a]) as r:
        a.status = "unhealthy"
        r.refresh()
        with pytest.raises(AllHostsUnavailableError):
            r.submit(_gpt_payload())

    def _dumped():
        b = flight.flight_recorder().last_bundle
        return b is not None and any(
            e.get("kind") == "fabric.no_hosts" for e in b["events"])

    wait_until(_dumped, timeout_s=5.0)


def test_failover_rides_host_level_error():
    a, b = FakeHost("a"), FakeHost("b")
    a.fail_with = ConnectionError("transport died")
    with _router([a, b]) as r:
        # a starts less loaded -> chosen; failover must land on b
        got = [r.submit(_gpt_payload()).result(5) for _ in range(4)]
        assert set(got) == {"b"}
    assert _metric("sparkdl_fabric_failovers_total") >= 1
    assert _metric("sparkdl_retries_total",
                   'site="host.submit",outcome="recovered"') >= 1


def test_request_level_error_passes_through_once():
    a = FakeHost("a")
    a.fail_with = ValueError("bad prompt")
    with _router([a, FakeHost("b")], max_failovers=2) as r:
        # force placement onto a
        with r._lock:
            r._hosts["b"].outstanding += 10
        fut = r.submit(_gpt_payload())
        with pytest.raises(ValueError, match="bad prompt"):
            fut.result(5)
        assert r._hosts["a"].consecutive_failures == 0


def test_quarantine_probation_rejoin_and_postmortem(wait_until):
    registry().reset()
    a, b = FakeHost("a"), FakeHost("b")
    a.fail_with = ConnectionError("down")
    with _router([a, b], max_failures=2, probation_s=0.05,
                 probation_max_s=0.4) as r:
        for _ in range(4):
            r.submit(_gpt_payload()).result(5)
        assert r._hosts["a"].quarantined
        snap = r.snapshot()
        assert snap["healthy_count"] == 1

        # postmortem bundle captured the failover sequence
        def _bundle_complete():
            b_ = flight.flight_recorder().last_bundle
            if b_ is None:
                return False
            kinds = [e.get("kind") for e in b_["events"]]
            return ("fabric.host_quarantined" in kinds
                    and "fabric.failover" in kinds)

        wait_until(_bundle_complete, timeout_s=5.0)
        # probation: a probe rides a live request after the backoff
        a.fail_with = None
        time.sleep(0.08)
        results = {r.submit(_gpt_payload()).result(5)
                   for _ in range(6)}
        assert "a" in results
        assert not r._hosts["a"].quarantined
    assert _metric("sparkdl_fabric_host_quarantined_total") == 1


def test_probe_failing_with_request_error_releases_probe_slot():
    """Regression: a probation probe whose REQUEST fails for its
    own reasons (deadline, bad prompt) is inconclusive about the host —
    it must release the probe slot (probing=False) so a later probe can
    still rejoin the host; leaking it quarantined the host forever."""
    a, b = FakeHost("a"), FakeHost("b")
    a.fail_with = ConnectionError("down")
    with _router([a, b], max_failures=1, probation_s=0.03) as r:
        r.submit(_gpt_payload()).result(5)
        assert r._hosts["a"].quarantined
        time.sleep(0.05)
        a.fail_with = ValueError("bad prompt")  # request-level verdict
        with r._lock:  # force the probe onto the quarantined host
            r._hosts["b"].outstanding += 3
        with pytest.raises(ValueError):
            r.submit(_gpt_payload()).result(5)
        with r._lock:
            r._hosts["b"].outstanding -= 3
        st = r._hosts["a"]
        assert st.quarantined and not st.probing  # slot released
        a.fail_with = None
        time.sleep(0.05)
        results = {r.submit(_gpt_payload()).result(5) for _ in range(4)}
        assert "a" in results and not r._hosts["a"].quarantined


def test_failed_probe_doubles_backoff():
    a, b = FakeHost("a"), FakeHost("b")
    a.fail_with = ConnectionError("down")
    with _router([a, b], max_failures=1, probation_s=0.05,
                 probation_max_s=1.0) as r:
        r.submit(_gpt_payload()).result(5)
        assert r._hosts["a"].quarantined
        time.sleep(0.08)
        r.submit(_gpt_payload()).result(5)  # the probe fails
        st = r._hosts["a"]
        assert st.quarantined and st.probation_backoff_s == pytest.approx(0.1)


# -- caller-side edge cases ---------------------------------------------------

def test_cancelled_caller_future_dropped_silently():
    a = FakeHost("a")
    a.hold = threading.Event()
    with _router([a]) as r:
        fut = r.submit(_gpt_payload())
        assert fut.cancel()
        a.hold.set()
        # the host-side result lands nowhere; the router must not raise
        # InvalidStateError on the worker thread or hang close()
        deadline = time.monotonic() + 5
        while r._hosts["a"].outstanding and time.monotonic() < deadline:
            time.sleep(0.005)
        assert r._hosts["a"].outstanding == 0


def test_deadline_bounds_failover():
    """An already-expired request gets NO failover hops: re-routing
    work the caller stopped waiting for just burns surviving hosts."""
    registry().reset()
    a, b = FakeHost("a"), FakeHost("b")
    a.fail_with = ConnectionError("down")
    b.fail_with = ConnectionError("down")
    with _router([a, b], max_failovers=10) as r:
        fut = r.submit(_gpt_payload(), timeout_s=0.0)
        with pytest.raises(ConnectionError):
            fut.result(5)
    assert _metric("sparkdl_fabric_failovers_total") == 0


# -- fault sites --------------------------------------------------------------

def test_router_route_fault_site():
    a = FakeHost("a")
    with _router([a]) as r:
        with inject("router.route@1"):
            with pytest.raises(RuntimeError, match="router.route"):
                r.submit(_gpt_payload())
        assert r.submit(_gpt_payload()).result(5) == "a"


def test_host_submit_fault_site_reroutes():
    """An injected host.submit fault is a host-level failure: the
    request must survive via failover, and the retry lands in the
    spine under the new site."""
    registry().reset()
    a, b = FakeHost("a"), FakeHost("b")
    with _router([a, b]) as r:
        with inject("host.submit:OSError@1"):
            assert r.submit(_gpt_payload()).result(5) in ("a", "b")
    assert _metric("sparkdl_faults_injected_total",
                   'site="host.submit"') == 1
    assert _metric("sparkdl_retries_total",
                   'site="host.submit",outcome="recovered"') == 1


def test_host_drain_fault_site_retries():
    """drain_host retries once through an injected host.drain fault —
    a transient must not strand the host half-drained."""
    registry().reset()
    a, b = FakeHost("a"), FakeHost("b")
    with _router([a, b]) as r:
        with inject("host.drain@1"):
            r.drain_host("a")
        assert r._hosts["a"].draining
    assert _metric("sparkdl_retries_total",
                   'site="host.drain",outcome="recovered"') == 1


# -- snapshot / context provider ---------------------------------------------

def test_snapshot_feeds_healthz():
    a = FakeHost("a")
    with _router([a]) as r:
        report = flight.healthz_report()
        # the router registered as a context provider: its host fleet
        # appears as a replica pool in the aggregate
        pools = report.get("replica_pools") or []
        assert any(p.get("replica_count") == 1 for p in pools)
    report = flight.healthz_report()
    pools = report.get("replica_pools") or []
    assert not any(p.get("policy") == "affinity" for p in pools)
