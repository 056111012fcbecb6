"""PhaseRouter placement + BatchPrefillFiller unit tests over scripted
fake hosts (no live engines — the cross-tier data path is covered by
test_handoff_parity.py / test_handoff_faults.py).

Here: the decode tier's ``headroom`` scoring (free slots discounted by
KV availability), PhaseRouter introspection/lifecycle, and the filler's
one hard rule — offline work never delays a live prompt."""

import threading
from concurrent.futures import Future

import pytest

from sparkdl_torch.disagg import BatchPrefillFiller, PhaseRouter
from sparkdl_torch.fabric import HostHandle, Router


class FakeHost(HostHandle):
    """Scripted capacity; submits resolve instantly with the host id."""

    def __init__(self, host_id, *, free_slots=4, kv_free=None,
                 kv_total=None, queue_depth=0):
        self.host_id = host_id
        self.free_slots = free_slots
        self.kv_free = kv_free
        self.kv_total = kv_total
        self.queue_depth = queue_depth
        self.submits = []

    def submit(self, payload, *, timeout_s=None):
        self.submits.append(payload)
        fut = Future()
        fut.set_result(self.host_id)
        return fut

    def capacity(self):
        return {"host_id": self.host_id, "replica_count": 1,
                "n_slots": 4, "free_slots": self.free_slots,
                "kv_blocks_free": self.kv_free,
                "kv_blocks_total": self.kv_total,
                "queue_depth": self.queue_depth,
                "max_queue_depth": 16, "draining": False}

    def health(self):
        return {"status": "ok", "host_id": self.host_id}

    def snapshot(self):
        return {"host_id": self.host_id, "capacity": self.capacity()}

    def prefix_digest(self, max_entries=1024):
        return None

    def drain(self):
        return []

    def close(self, *, timeout_s=30.0):
        pass


def _router(hosts, **kw):
    kw.setdefault("auto_refresh", False)
    return Router(hosts, **kw)


# -- headroom policy (Router-level, decode-tier placement) --------------------

def test_headroom_prefers_the_host_with_free_slots():
    a = FakeHost("a", free_slots=4)
    b = FakeHost("b", free_slots=1)
    r = _router([a, b], policy="headroom")
    try:
        r.refresh()
        for _ in range(3):
            r.submit({"prompt": [1, 2], "max_new_tokens": 1}).result(5)
        assert len(a.submits) == 3 and not b.submits
    finally:
        r.close()


def test_headroom_discounts_slots_by_kv_availability():
    """Slots without blocks are not headroom: a host with 4 free slots
    but a nearly-exhausted pool (4 × 1/10 = 0.4) must lose to one with
    a single slot and a full pool (1 × 1.0)."""
    starved = FakeHost("starved", free_slots=4, kv_free=1, kv_total=10)
    fed = FakeHost("fed", free_slots=1, kv_free=10, kv_total=10)
    r = _router([starved, fed], policy="headroom")
    try:
        r.refresh()
        r.submit({"prompt": [1, 2], "max_new_tokens": 1}).result(5)
        assert len(fed.submits) == 1 and not starved.submits
    finally:
        r.close()


def test_headroom_outstanding_keeps_the_score_live():
    """Between capacity refreshes the router's own outstanding count
    erodes a host's room — round-tripping every request to one stale
    free_slots reading would pile onto a single host."""
    a = FakeHost("a", free_slots=2)
    b = FakeHost("b", free_slots=2)
    hold = threading.Event()

    def slow_submit(payload, *, timeout_s=None, _h=a):
        _h.submits.append(payload)
        fut = Future()
        threading.Thread(
            target=lambda: (hold.wait(5), fut.set_result("a")),
            daemon=True).start()
        return fut

    a.submit = slow_submit
    r = _router([a, b], policy="headroom")
    try:
        r.refresh()
        f1 = r.submit({"prompt": [1], "max_new_tokens": 1})
        f2 = r.submit({"prompt": [2], "max_new_tokens": 1})
        # a absorbed one in-flight request; with equal capacity
        # readings the second submit must spread to b
        assert len(b.submits) == 1
        hold.set()
        f1.result(5), f2.result(5)
    finally:
        r.close()


def test_headroom_policy_is_validated():
    with pytest.raises(ValueError, match="policy"):
        _router([FakeHost("a")], policy="roomiest")


# -- PhaseRouter introspection / lifecycle ------------------------------------

def _phase_router(**kw):
    kw.setdefault("auto_refresh", False)
    return PhaseRouter(
        [FakeHost("p0", queue_depth=2), FakeHost("p1", queue_depth=1)],
        [FakeHost("d0", kv_free=8, kv_total=8)], **kw)


def test_tier_depths_sums_live_queue_depth_per_tier():
    pr = _phase_router()
    try:
        assert pr.tier_depths() == {"prefill": 3, "decode": 0}
    finally:
        pr.close()


def test_snapshot_counts_and_tier_shapes():
    pr = _phase_router()
    try:
        snap = pr.snapshot()["disagg"]
        assert snap["submitted"] == 0 and snap["requeues"] == 0
        assert snap["prefill_hosts"] == 2
        assert snap["decode_hosts"] == 1
        assert {h["host"] for h in snap["prefill"]["hosts"]} == \
            {"p0", "p1"}
        assert {h["host"] for h in snap["decode"]["hosts"]} == {"d0"}
        assert snap["decode"]["policy"] == "headroom"
    finally:
        pr.close()


def test_phase_router_validates_and_closes_idempotently():
    with pytest.raises(ValueError, match="max_handoff_retries"):
        _phase_router(max_handoff_retries=-1)
    pr = _phase_router()
    pr.close()
    pr.close()  # idempotent
    with pytest.raises(RuntimeError, match="closed"):
        pr.submit([1, 2], 4)


def test_phase_router_is_a_context_manager():
    with _phase_router() as pr:
        assert pr.tier_depths()["decode"] == 0
    with pytest.raises(RuntimeError, match="closed"):
        pr.submit([1], 1)


def test_construction_failure_closes_the_prefill_router():
    """A bad decode tier must not leak the already-built prefill
    Router (its refresh thread / flight provider)."""
    with pytest.raises(ValueError, match="at least one host"):
        PhaseRouter([FakeHost("p0")], [], auto_refresh=False)


# -- batch-prefill filler -----------------------------------------------------

class StubPhaseRouter:
    """Just the two surfaces the filler touches: live tier depth and
    submit(). Futures resolve when the test says so."""

    def __init__(self, *, depth=0):
        self.depth = depth
        self.futs = []
        self.submit_error = None

    def tier_depths(self):
        return {"prefill": self.depth, "decode": 0}

    def submit(self, prompt, max_new, **kw):
        if self.submit_error is not None:
            raise self.submit_error
        fut = Future()
        self.futs.append((fut, prompt, max_new))
        return fut


def _source(n, start=0):
    return (([start + i], 2) for i in range(n))


def test_filler_fills_idle_capacity_up_to_max_inflight():
    spr = StubPhaseRouter()
    f = BatchPrefillFiller(spr, _source(10), max_inflight=3)
    assert f.pump() == 3
    assert f.pump() == 0  # inflight cap holds
    spr.futs[0][0].set_result([7, 8])
    assert f.pump() == 1  # freed slot refills
    assert f.submitted == 4 and f.completed == 1
    assert f.results == [[7, 8]]


def test_filler_stands_down_when_interactive_work_is_queued():
    """The hard rule: ANY queued prefill work pauses offline
    admission; it resumes the moment the tier is idle again."""
    spr = StubPhaseRouter(depth=2)
    f = BatchPrefillFiller(spr, _source(4), max_inflight=4)
    assert f.pump() == 0
    assert f.submitted == 0
    spr.depth = 0  # the burst drained
    assert f.pump() == 4


def test_filler_holds_the_item_when_submit_refuses():
    """A refused submit is NOT a consumed item: the filler retries the
    same prompt on a later pump, so offline work is never dropped by a
    transiently overloaded tier."""
    spr = StubPhaseRouter()
    spr.submit_error = RuntimeError("tier closing")
    f = BatchPrefillFiller(spr, _source(2), max_inflight=2)
    assert f.pump() == 0
    spr.submit_error = None
    assert f.pump() == 2
    assert [p for _, p, _ in spr.futs] == [[0], [1]]  # nothing skipped


def test_filler_counts_failures_without_retrying():
    spr = StubPhaseRouter()
    collected = []
    f = BatchPrefillFiller(spr, _source(2), max_inflight=2,
                           on_result=collected.append)
    assert f.pump() == 2
    spr.futs[0][0].set_exception(RuntimeError("boom"))
    spr.futs[1][0].set_result([1])
    assert f.failed == 1 and f.completed == 1
    assert collected == [[1]]
    assert f.results == []  # on_result takes them instead
    assert f.pump() == 0  # discovers the dry source
    assert f.drained  # source dry + nothing outstanding


def test_filler_drained_lifecycle_and_validation():
    with pytest.raises(ValueError, match="max_inflight"):
        BatchPrefillFiller(StubPhaseRouter(), _source(1), max_inflight=0)
    spr = StubPhaseRouter()
    f = BatchPrefillFiller(spr, _source(1), max_inflight=2)
    assert not f.drained
    f.pump()
    assert not f.drained  # one still outstanding
    spr.futs[0][0].set_result([3])
    assert f.drained


def test_filler_thread_drains_the_source_then_exits():
    spr = StubPhaseRouter()
    done = threading.Event()

    def resolve(fut):  # resolve each submit from another thread
        fut.set_result([0])
        if len(spr.futs) == 3:
            done.set()

    orig = spr.submit

    def submit(prompt, max_new, **kw):
        fut = orig(prompt, max_new, **kw)
        threading.Thread(target=resolve, args=(fut,),
                         daemon=True).start()
        return fut

    spr.submit = submit
    f = BatchPrefillFiller(spr, _source(3), max_inflight=1,
                           interval_s=0.005).start()
    try:
        assert done.wait(5)
        deadline = threading.Event()
        for _ in range(200):
            if f.drained:
                break
            deadline.wait(0.01)
        assert f.drained and f.completed == 3
    finally:
        f.stop()
