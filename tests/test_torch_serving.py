"""The port's serving front door: RequestQueue admission, deadlines,
backpressure and drain; tenancy quotas and priority classes; the
ServingEngine/MicroBatcher over the port's BatchedRunner (per-request
error isolation, coalescing, drain); the copied observability pieces
(percentiles, SLO trackers, the exporter) against the reference's.

Everything runs on the CPU: the runner's plain path, no card.
"""

import threading
import time
from concurrent.futures import wait

import numpy as np
import pytest
import torch

from sparkdl_torch.serving import (
    PRIORITY_BACKGROUND,
    BrownoutShedError,
    DeadlineExceededError,
    EngineClosedError,
    OverloadController,
    QueueFullError,
    ReplicaPool,
    RequestQueue,
    ServingEngine,
    TenantRegistry,
    TenantThrottledError,
    failure_reason,
)
from sparkdl_torch.serving import tenancy
from sparkdl_torch.transformers._inference import BatchedRunner


def _runner(batch_size=16, **kw):
    return BatchedRunner(lambda b: b["x"] * 2.0 + 1.0,
                         batch_size=batch_size, device="cpu", **kw)


# -- the queue ---------------------------------------------------------------

def test_fifo_order_take_bound_and_payloads():
    q = RequestQueue(max_depth=8)
    futs = [q.submit(i) for i in range(5)]
    assert [r.payload for r in q.take(3, 0.0)] == [0, 1, 2]
    reqs = q.take(10, max_wait_s=0.0)
    assert [r.payload for r in reqs] == [3, 4] and q.depth == 0
    assert [r.future for r in reqs] == futs[3:]
    assert all(hasattr(f, "request_id") for f in futs)


def test_backpressure_rejects_past_capacity():
    q = RequestQueue(max_depth=3)
    for i in range(3):
        q.submit(i)
    with pytest.raises(QueueFullError, match="max depth 3"):
        q.submit(99)
    assert q.rejected == 1 and q.submitted == 3
    q.take(3, 0.0)
    q.submit(100)  # draining reopens admission


def test_full_queue_of_expired_requests_admits_live_traffic():
    q = RequestQueue(max_depth=2)
    dead = [q.submit(i, timeout_s=0.01) for i in range(2)]
    time.sleep(0.05)
    fut = q.submit("live")  # the sweep evicts the expired instead
    assert q.expired == 2
    for f in dead:
        with pytest.raises(DeadlineExceededError):
            f.result(timeout=0)
    assert [r.payload for r in q.take(5, 0.0)] == ["live"]
    assert not fut.done()


def test_deadline_expiry_mid_queue_and_cancelled_skipped():
    q = RequestQueue(max_depth=8)
    f_dead = q.submit("dead", timeout_s=0.01)
    f_gone = q.submit("gone")
    f_live = q.submit("live")
    assert f_gone.cancel()
    time.sleep(0.05)
    assert [r.payload for r in q.take(5, 0.0)] == ["live"]
    with pytest.raises(DeadlineExceededError, match="deadline exceeded"):
        f_dead.result(timeout=0)
    assert not f_live.done() and q.expired == 1


def test_take_blocks_until_submit_and_times_out_empty():
    q = RequestQueue(max_depth=8)
    t0 = time.monotonic()
    assert q.take(4, max_wait_s=0.05) == []
    assert time.monotonic() - t0 < 1.0
    got = []
    t = threading.Thread(target=lambda: got.extend(q.take(1, max_wait_s=5.0)))
    t.start()
    time.sleep(0.05)
    q.submit("x")
    t.join(timeout=5)
    assert not t.is_alive() and [r.payload for r in got] == ["x"]


def test_close_keeps_queued_takeable_and_fail_pending_fails_the_rest():
    q = RequestQueue(max_depth=8)
    q.submit("queued")
    futs = [q.submit(i) for i in range(3)]
    q.close()
    with pytest.raises(EngineClosedError):
        q.submit("late")
    assert [r.payload for r in q.take(1, 0.0)] == ["queued"]
    assert q.fail_pending() == 3
    for f in futs:
        with pytest.raises(EngineClosedError):
            f.result(timeout=0)
    with pytest.raises(ValueError, match="max_depth"):
        RequestQueue(max_depth=0)


def test_requeue_and_transfer_keep_identity_fifo_ahead():
    src, dst = RequestQueue(max_depth=4), RequestQueue(max_depth=2)
    fd = dst.submit("resident")
    fa = src.submit("moved-1", timeout_s=30.0)
    (taken,) = src.take(1, 0.0)
    src.requeue([taken])  # a deferral: back at the head, still started
    fb = src.submit("moved-2")
    src.close()
    moved = src.extract_pending()
    assert [r.payload for r in moved] == ["moved-1", "moved-2"]
    assert moved[0].started and moved[0].deadline is not None
    dst.requeue(moved)
    assert dst.depth == 3  # accepted traffic may exceed max_depth ...
    with pytest.raises(QueueFullError):
        dst.submit("new")  # ... new work may not
    got = dst.take(3, 0.0)
    assert [r.future for r in got] == [fa, fb, fd]


def test_failure_reasons():
    assert failure_reason(EngineClosedError("x")) == "closed"
    assert failure_reason(DeadlineExceededError("x")) == "expired"
    assert failure_reason(ValueError("x")) == "error"


# -- tenancy -------------------------------------------------------------------

def test_tenant_quota_sheds_typed_and_counted():
    reg = TenantRegistry()
    reg.configure("flood", rate=1e-6, burst=2)
    q = RequestQueue(max_depth=64, tenants=reg)
    for _ in range(2):
        q.submit("ok", tenant="flood")
    with pytest.raises(TenantThrottledError) as e:
        q.submit("over", tenant="flood")
    assert e.value.tenant == "flood"
    q.submit("free", tenant="other")  # unconfigured tenants pass freely
    snap = reg.snapshot()
    assert snap["flood"]["admitted"] == 2 and snap["flood"]["shed"] == 1


def test_priority_classes_before_fair_share_and_requeue_stays_in_class():
    reg = TenantRegistry()
    reg.configure("a", weight=1.0)
    reg.configure("b", weight=1.0)
    q = RequestQueue(max_depth=64, tenants=reg)
    for i in range(3):
        q.submit(f"bg{i}", tenant="a", priority=PRIORITY_BACKGROUND)
    for i in range(2):
        q.submit(f"a{i}", tenant="a")
        q.submit(f"b{i}", tenant="b")
    assert q.highest_waiting_priority() == 0
    first = q.take(4, 0.0)
    assert sorted(r.payload for r in first) == ["a0", "a1", "b0", "b1"]
    assert [r.tenant for r in first[:2]] in (["a", "b"], ["b", "a"])
    bg = q.take(1, 0.0)
    q.submit("late", tenant="b")
    q.requeue(bg)  # back at the head of its OWN class, behind interactive
    assert [r.payload for r in q.take(3, 0.0)] == ["late", "bg0", "bg1"]


def test_brownout_sheds_background_then_recovers():
    ctrl = OverloadController(hysteresis=1, recovery_ticks=1,
                              cooldown_ticks=0)
    prev = tenancy.set_process_overload(ctrl)
    try:
        q = RequestQueue(max_depth=64)
        ctrl.evaluate(burn_rate=10.0)
        assert tenancy.overload_level() >= 1
        with pytest.raises(BrownoutShedError) as e:
            q.submit("bg", priority=PRIORITY_BACKGROUND)
        assert e.value.level >= 1
        q.submit("interactive")  # still served
        for _ in range(4):
            ctrl.evaluate(burn_rate=0.0, queue_frac=0.0)
        assert tenancy.overload_level() == 0
        q.submit("bg again", priority=PRIORITY_BACKGROUND)
    finally:
        tenancy.set_process_overload(prev)


# -- ServingEngine over the port's BatchedRunner -----------------------------

def test_results_match_apply_fn_per_request_and_metrics():
    with ServingEngine(_runner(), max_wait_s=0.002) as eng:
        rows = [np.full((3,), float(i), np.float32) for i in range(20)]
        futs = [eng.submit({"x": r}) for r in rows]
        for r, f in zip(rows, futs):
            np.testing.assert_allclose(f.result(timeout=30), r * 2.0 + 1.0)
    snap = eng.snapshot()
    assert snap["completed"] == 20 and snap["failed"] == 0
    assert snap["latency_s"]["p95"] is not None
    assert snap["capacity"]["replica_count"] == 1


def test_burst_coalesces_into_batches():
    with ServingEngine(_runner(batch_size=16), max_wait_s=0.05) as eng:
        futs = [eng.submit({"x": np.ones((2,), np.float32) * i})
                for i in range(16)]
        wait(futs, timeout=30)
    snap = eng.snapshot()
    assert snap["completed"] == 16 and snap["batches"] < 16
    assert snap["batch_occupancy_pct"] > 100.0 / 16


def test_bad_request_degrades_to_its_own_error():
    def extract(payload):
        x = np.asarray(payload["x"], np.float32)
        if x.shape != (2,):
            raise ValueError(f"bad row shape {x.shape}")
        return {"x": x}

    with ServingEngine(_runner(), extract=extract) as eng:
        good = [eng.submit({"x": np.ones((2,), np.float32) * i})
                for i in range(4)]
        bad = eng.submit({"x": np.ones((5,), np.float32)})
        for i, f in enumerate(good):
            np.testing.assert_allclose(f.result(timeout=30),
                                       np.ones((2,)) * i * 2.0 + 1.0)
        with pytest.raises(ValueError, match="bad row shape"):
            bad.result(timeout=30)
    snap = eng.snapshot()
    assert snap["completed"] == 4 and snap["failed"] == 1


def test_poison_row_in_a_batch_fails_alone():
    """A batch whose dispatch fails is retried row by row: only the
    culprit errors."""
    def apply_fn(b):
        if (b["x"] < 0).any():
            raise ValueError("negative input")
        return b["x"] * 2.0

    runner = BatchedRunner(apply_fn, batch_size=8, device="cpu")
    with ServingEngine(runner, max_wait_s=0.05) as eng:
        futs = [eng.submit({"x": np.full((2,), v, np.float32)})
                for v in (1.0, 2.0, -1.0, 3.0)]
        wait(futs, timeout=30)
    assert [float(f.result()[0]) for i, f in enumerate(futs) if i != 2] == [
        2.0, 4.0, 6.0]
    with pytest.raises(ValueError, match="negative"):
        futs[2].result()


def test_backpressure_and_deadline_behind_a_stalled_batcher():
    ev = threading.Event()

    def slow_extract(payload):
        ev.wait(5.0)
        return {"x": np.asarray(payload["x"], np.float32)}

    eng = ServingEngine(_runner(batch_size=1), max_queue_depth=2,
                        max_wait_s=0.001, extract=slow_extract)
    try:
        blocker = eng.submit({"x": np.ones((2,), np.float32)})
        deadline = time.time() + 5
        while eng.queue.depth > 0 and time.time() < deadline:
            time.sleep(0.005)
        assert eng.queue.depth == 0, "the batcher never took the blocker"
        doomed = eng.submit({"x": np.ones((2,), np.float32)}, timeout_s=0.02)
        live = eng.submit({"x": np.ones((2,), np.float32)})
        with pytest.raises(QueueFullError):
            eng.submit({"x": np.ones((2,), np.float32)})
        assert eng.snapshot()["rejected"] == 1
        time.sleep(0.1)
    finally:
        ev.set()
        eng.close()
    assert blocker.result(timeout=30) is not None
    assert live.result(timeout=30) is not None
    with pytest.raises(DeadlineExceededError):
        doomed.result(timeout=30)


def test_graceful_drain_and_non_graceful_close():
    eng = ServingEngine(_runner(), max_wait_s=0.01)
    futs = [eng.submit({"x": np.full((2,), float(i), np.float32)})
            for i in range(12)]
    eng.close(drain=True)
    for i, f in enumerate(futs):
        np.testing.assert_allclose(f.result(timeout=0),
                                   np.full((2,), float(i)) * 2.0 + 1.0)
    with pytest.raises(EngineClosedError):
        eng.submit({"x": np.zeros((2,), np.float32)})

    ev = threading.Event()
    eng = ServingEngine(_runner(batch_size=1), max_wait_s=0.001,
                        extract=lambda p: (ev.wait(5.0), p)[1])
    eng.submit({"x": np.zeros((2,), np.float32)})
    queued = eng.submit({"x": np.zeros((2,), np.float32)})
    time.sleep(0.05)
    ev.set()
    eng.close(drain=False)
    with pytest.raises(EngineClosedError):
        queued.result(timeout=30)


def test_tuple_output_apply_fn():
    runner = BatchedRunner(lambda b: (b["x"] * 2.0, b["x"].sum(dim=-1)),
                           batch_size=8, device="cpu")
    with ServingEngine(runner) as eng:
        doubled, summed = eng.submit(
            {"x": np.ones((3,), np.float32)}).result(timeout=30)
    np.testing.assert_allclose(doubled, np.full((3,), 2.0))
    np.testing.assert_allclose(summed, 3.0)


def test_serving_engine_runs_where_its_runner_runs():
    """The engine takes the runner's device: a runner's default is the
    card, which raises without CUDA instead of serving on the CPU, and so
    is a pool's (every visible card)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default does not raise here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServingEngine(BatchedRunner(lambda b: b["x"], batch_size=4))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ReplicaPool(lambda b: b["x"])


# -- observability copies vs the reference -----------------------------------

def test_percentiles_and_step_meter_match_the_reference():
    from sparkdl_torch.observability import metrics as tm
    from sparkdl_tpu.observability import metrics as jm

    rng = np.random.default_rng(0)
    xs = rng.random(37).tolist()
    for p in (0, 1, 50, 95, 99, 100):
        assert tm.percentile(xs, p) == jm.percentile(xs, p)
        assert tm.percentile(xs, p) == pytest.approx(np.percentile(xs, p))
    assert tm.percentile([], 50) is None
    a = tm.StepMeter(n_chips=1, window=16, warmup_steps=1)
    b = jm.StepMeter(n_chips=1, window=16, warmup_steps=1)
    for x in xs:
        a.record(x, examples=3)
        b.record(x, examples=3)
    assert a.step_time_percentiles() == b.step_time_percentiles()
    assert a.mean_step_time() == b.mean_step_time()
    assert a.examples_per_sec() == b.examples_per_sec()


def test_ttft_rides_the_serving_metrics():
    from sparkdl_torch.serving import ServingMetrics

    m = ServingMetrics()
    for s in (0.1, 0.2, 0.3):
        m.record_first_token(s)
    assert m.snapshot()["ttft_s"]["p50"] == pytest.approx(0.2)


def test_slo_tracker_and_metrics_server_serve_the_engine():
    import json
    import urllib.request

    from sparkdl_torch.observability.exporters import MetricsServer
    from sparkdl_torch.observability.slo import SLO

    eng = ServingEngine(_runner(), max_wait_s=0.001,
                        slo=SLO("t_serving", latency_threshold_s=5.0, availability_target=0.99))
    srv = MetricsServer(port=0, host="127.0.0.1")
    try:
        eng.submit({"x": np.ones((2,), np.float32)}).result(timeout=30)
        assert eng.snapshot()["slo"] is not None
        with urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/metrics", timeout=10) as r:
            assert b"sparkdl_serving_requests_total" in r.read()
        with urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/slo.json", timeout=10) as r:
            assert "slos" in json.loads(r.read())
    finally:
        srv.close()
        eng.close()
