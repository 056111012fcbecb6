"""The port's ReplicaPool against the JAX package's, on the CPU.

The pool routes WHOLE micro-batches, so its rows are bitwise one port
runner's, and within float32 rounding of the JAX pool's on the same
``tanh(x @ W)`` apply. The reliability contract is the reference's:
re-route-once rider protection, the probation circuit breaker (driven
here by a fake clock), the hung-dispatch watchdog, drain, elasticity; the
same injected ``replica.execute`` faults give the same outcomes, snapshot
counts and retry-metric increments in both packages. Replicas run on
``torch.device("cpu")`` (several per device, as several share a card).
"""

import threading
import time

import numpy as np
import pytest
import torch

from sparkdl_torch.observability.registry import registry as tregistry
from sparkdl_torch.partition import SingleDevicePartitioner
from sparkdl_torch.reliability import faults as tfaults
from sparkdl_torch.reliability.breaker import ProbationBreaker
from sparkdl_torch.serving import ServingEngine
from sparkdl_torch.serving import replicas as treplicas
from sparkdl_torch.serving.replicas import (
    AllReplicasQuarantinedError,
    HungDispatchError,
    ReplicaPool,
)
from sparkdl_torch.transformers._inference import BatchedRunner

torch.set_num_threads(2)

DIM = 6
_W = np.random.default_rng(3).standard_normal((DIM, DIM)).astype(np.float32)
_TW = torch.as_tensor(_W)
CPU = torch.device("cpu")
POOL_TOL = 1e-6  # float32 tanh(x @ W) in torch vs XLA: the sums may round apart


def _apply(b):
    return torch.tanh(b["x"] @ _TW)


def _batch(n, seed=0):
    rng = np.random.default_rng(seed)
    return {"x": rng.standard_normal((n, DIM)).astype(np.float32)}


def _runner(**kw):
    return BatchedRunner(_apply, batch_size=8, device="cpu", **kw)


def _pool(n=2, **kw):
    kw.setdefault("batch_size", 8)
    return ReplicaPool(_apply, devices=[CPU] * n, n_replicas=n, **kw)


class _Scripted:
    """Runner wrapper: dispatches fail while ``failing``, the first
    ``hang_s`` > 0 dispatch sleeps that long (then raises if
    ``hang_raises``); counts calls."""

    def __init__(self, inner, hang_s=0.0, hang_raises=False):
        self._inner = inner
        self.failing = False
        self.hang_s = hang_s
        self.hang_raises = hang_raises
        self.calls = 0
        self.chunk_size = inner.chunk_size

    def run_batch(self, arrays):
        self.calls += 1
        if self.calls == 1 and self.hang_s:
            time.sleep(self.hang_s)
            if self.hang_raises:
                raise RuntimeError("wedged program aborted")
        if self.failing:
            raise RuntimeError("scripted executor failure")
        return self._inner.run_batch(arrays)


def _scripted_pool(n=2, hang=(), hang_raises=False, **kw):
    runners = []

    def make_runner(device):
        r = _Scripted(_runner(partitioner=SingleDevicePartitioner(device)),
                      hang_s=hang[len(runners)] if len(hang) > len(runners)
                      else 0.0, hang_raises=hang_raises)
        runners.append(r)
        return r

    kw.setdefault("max_failures", 2)
    return ReplicaPool(make_runner=make_runner, devices=[CPU] * n,
                       n_replicas=n, **kw), runners


def _counter(reg, name, **labels):
    fam = reg().get(name)
    if fam is None:
        return 0.0
    key = ",".join(f'{k}="{v}"' for k, v in labels.items())
    return fam.snapshot_values().get(key, 0.0)


class _Clock:
    """A fake ``time`` module for the pool's probation schedule."""

    def __init__(self):
        self.now = 1000.0

    def monotonic(self):
        return self.now

    perf_counter = staticmethod(time.perf_counter)


# -- rows ----------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 3])
def test_pool_rows_bitwise_one_runner_and_near_the_jax_pool(n):
    import jax.numpy as jnp

    from sparkdl_tpu.serving.replicas import ReplicaPool as JaxPool

    jw = jnp.asarray(_W)
    single = _runner()
    with _pool(n) as pool, JaxPool(lambda b: jnp.tanh(b["x"] @ jw),
                                   batch_size=8, n_replicas=n) as jpool:
        for seed in range(6):
            b = _batch(5, seed)
            got = pool.run_batch(b)
            np.testing.assert_array_equal(got, single.run_batch(b))
            np.testing.assert_allclose(got, jpool.run_batch(b), rtol=0,
                                       atol=POOL_TOL)
        assert pool.snapshot()["replica_count"] == n


def test_routing_spreads_load_over_replicas():
    with _pool(2) as pool:
        pool.warmup(_batch(8))
        futs = [pool.run_batch_async(_batch(8, seed=i)) for i in range(24)]
        for f in futs:
            f.result()
        snap = pool.snapshot()
    dispatched = [r["dispatched"] for r in snap["replicas"]]
    assert all(d > 1 for d in dispatched), dispatched
    assert snap["replica_count"] == 2 and snap["healthy_count"] == 2


def test_least_outstanding_routing():
    gate = threading.Event()

    class _Gated:
        chunk_size = 8

        def __init__(self):
            self.inner = _runner()

        def run_batch(self, arrays):
            gate.wait(10)
            return self.inner.run_batch(arrays)

    pool = ReplicaPool(make_runner=lambda d: _Gated(), devices=[CPU] * 4,
                       n_replicas=4)
    try:
        # nothing finishes until the gate opens: 8 batches over 4 idle
        # replicas land two on each (least work, ties round-robin)
        futs = [pool.run_batch_async(_batch(4, seed=i)) for i in range(8)]
        assert [r.outstanding for r in pool.replicas] == [2, 2, 2, 2]
        gate.set()
        for f in futs:
            f.result()
        assert [r["dispatched"] for r in pool.snapshot()["replicas"]] == [2] * 4
    finally:
        gate.set()
        pool.close()


def test_drain_serves_all_then_zero_depth():
    single = _runner()
    pool = _pool(2)
    futs = [pool.run_batch_async(_batch(3, seed=i)) for i in range(12)]
    pool.close(drain=True)
    for i, f in enumerate(futs):
        np.testing.assert_array_equal(
            f.result(timeout=0), single.run_batch(_batch(3, seed=i)))
    snap = pool.snapshot()
    assert all(r["depth"] == 0 and r["in_flight"] == 0
               for r in snap["replicas"])
    with pytest.raises(RuntimeError, match="closed"):
        pool.run_batch_async(_batch(2))


def test_close_without_drain_fails_queued(wait_until):
    gate = threading.Event()

    class _Gated:
        chunk_size = 8

        def run_batch(self, arrays):
            gate.wait(10)
            return arrays["x"]

    pool = ReplicaPool(make_runner=lambda d: _Gated(), devices=[CPU],
                       n_replicas=1)
    running = pool.run_batch_async(_batch(2))
    wait_until(lambda: pool.replicas[0].current_work is not None,
               desc="the worker took the first batch")
    queued = [pool.run_batch_async(_batch(2, seed=i)) for i in range(3)]
    closer = threading.Thread(target=pool.close, kwargs={"drain": False})
    closer.start()
    for f in queued:
        with pytest.raises(RuntimeError, match="ReplicaPool closed"):
            f.result(timeout=10)
    gate.set()
    closer.join(10)
    np.testing.assert_array_equal(running.result(timeout=10), _batch(2)["x"])
    with pytest.raises(RuntimeError, match="closed"):
        pool.run_batch_async(_batch(2))


def test_quarantine_after_repeated_failures_pool_survives():
    pool, runners = _scripted_pool(probation_s=600.0)
    try:
        runners[0].failing = True
        results = [(i, pool.run_batch(_batch(4, seed=i))) for i in range(16)]
        snap = pool.snapshot()
        assert snap["healthy_count"] == 1
        assert snap["replicas"][0]["quarantined"] is True
        single = _runner()
        for i, out in results:
            np.testing.assert_array_equal(out, single.run_batch(_batch(4, seed=i)))
    finally:
        pool.close()


def test_all_replicas_quarantined_raises():
    pool, runners = _scripted_pool(max_failures=1, probation_s=600.0)
    try:
        for r in runners:
            r.failing = True
        with pytest.raises(RuntimeError, match="scripted executor failure"):
            pool.run_batch(_batch(2, seed=0))
        with pytest.raises(AllReplicasQuarantinedError):
            pool.run_batch(_batch(2))
    finally:
        pool.close()


# -- the same faults, the same accounting as the reference ---------------------

FAULT_PLANS = {
    # (plan, n_replicas, pool knobs, batches, clock advance before batch i)
    "reroute_then_exhaust": ("replica.execute:RuntimeError@1*3", 2,
                             dict(max_failures=2, probation_s=600.0), 8, {}),
    "three_replicas_streak": ("replica.execute:RuntimeError@2*4", 3,
                              dict(max_failures=1, probation_s=600.0), 8, {}),
    "probation_probe_rejoins": ("replica.execute:RuntimeError@1*2", 2,
                                dict(max_failures=1, probation_s=1.0,
                                     probation_max_s=4.0), 6, {2: 1.0}),
    "failed_probes_back_off": ("replica.execute:RuntimeError@1*4", 2,
                               dict(max_failures=1, probation_s=1.0,
                                    probation_max_s=4.0),
                               7, {2: 1.0, 3: 2.0, 5: 4.0}),
}


def _fault_run(pkg, name, monkeypatch):
    plan, n, knobs, batches, advance = FAULT_PLANS[name]
    clock = _Clock()
    if pkg == "torch":
        mod, faults, reg = treplicas, tfaults, tregistry
        pool = ReplicaPool(make_runner=lambda d: _runner(), devices=[CPU] * n,
                           n_replicas=n, **knobs)
    else:
        import jax.numpy as jnp

        from sparkdl_tpu.observability.registry import registry as reg
        from sparkdl_tpu.reliability import faults
        from sparkdl_tpu.serving import replicas as mod
        from sparkdl_tpu.transformers._inference import BatchedRunner as JR

        jw = jnp.asarray(_W)
        pool = mod.ReplicaPool(
            make_runner=lambda d: JR(lambda b: jnp.tanh(b["x"] @ jw),
                                     batch_size=8, data_parallel=False,
                                     device=d), n_replicas=n, **knobs)
    monkeypatch.setattr(mod, "time", clock)
    metrics = [("sparkdl_retries_total", dict(site="replica.execute",
                                               outcome=o))
               for o in ("retried", "recovered", "exhausted")] + [
        ("sparkdl_replica_quarantined_total", {}),
        ("sparkdl_replica_reintegrated_total", {})]
    before = [_counter(reg, m, **lab) for m, lab in metrics]
    outcomes = []
    try:
        with faults.inject(plan):
            for i in range(batches):
                clock.now += advance.get(i, 0.0)
                try:
                    out = pool.run_batch(_batch(3, seed=i))
                    outcomes.append(("ok", out.shape))
                except Exception as e:  # noqa: BLE001 - compared below
                    outcomes.append((type(e).__name__, None))
        snap = pool.snapshot()
    finally:
        pool.close()
    added = [_counter(reg, m, **lab) - b
             for (m, lab), b in zip(metrics, before)]
    keep = ("dispatched", "consecutive_failures", "quarantined", "probing",
            "next_probe_in_s")
    return (outcomes, [{k: r[k] for k in keep} for r in snap["replicas"]],
            snap["healthy_count"], added,
            [r.breaker.probation_backoff_s for r in pool.replicas])


@pytest.mark.parametrize("name", sorted(FAULT_PLANS))
def test_injected_faults_give_the_reference_accounting(name, monkeypatch):
    got = _fault_run("torch", name, monkeypatch)
    want = _fault_run("jax", name, monkeypatch)
    assert got == want
    outcomes, reps, healthy, added, backoff = got
    kinds = [o for o, _ in outcomes]
    # added: retried, recovered, exhausted, quarantined, reintegrated
    if name == "reroute_then_exhaust":
        assert kinds == ["RuntimeError"] + ["ok"] * 7
        assert reps[0]["quarantined"] and healthy == 1
    if name == "three_replicas_streak":
        assert healthy == 0 and added[3] == 3
    if name == "probation_probe_rejoins":
        assert kinds[2:] == ["ok"] * 4 and healthy == 2 and added[4] == 2
    if name == "failed_probes_back_off":
        # three failed probes (typed errors), then both rejoin
        assert kinds.count("AllReplicasQuarantinedError") == 3
        assert healthy == 2 and added[4] == 2 and backoff == [1.0, 1.0]


# -- reliability (the reference's probation suite) -----------------------------

def test_single_failure_is_rerouted_not_surfaced():
    pool, runners = _scripted_pool(probation_s=600.0)
    try:
        runners[0].failing = True
        retried0 = _counter(tregistry, "sparkdl_retries_total",
                            site="replica.execute", outcome="retried")
        single = _runner()
        for i in range(8):
            np.testing.assert_array_equal(pool.run_batch(_batch(4, seed=i)),
                                          single.run_batch(_batch(4, seed=i)))
        assert _counter(tregistry, "sparkdl_retries_total",
                        site="replica.execute", outcome="retried") > retried0
        assert pool.snapshot()["replicas"][0]["quarantined"]
    finally:
        pool.close()


def test_probation_probe_reintegrates_replica(monkeypatch):
    clock = _Clock()
    monkeypatch.setattr(treplicas, "time", clock)
    pool, runners = _scripted_pool(probation_s=0.05, probation_max_s=1.0)
    try:
        runners[0].failing = True
        for i in range(4):
            pool.run_batch(_batch(4, seed=i))
        assert pool.snapshot()["healthy_count"] == 1
        runners[0].failing = False
        rejoined0 = _counter(tregistry, "sparkdl_replica_reintegrated_total")
        pool.run_batch(_batch(4, seed=99))  # not due yet: no probe
        assert pool.snapshot()["healthy_count"] == 1
        clock.now += 0.05
        pool.run_batch(_batch(4, seed=99))  # this one is the probe
        snap = pool.snapshot()
        assert snap["healthy_count"] == 2 and not snap["replicas"][0]["quarantined"]
        assert _counter(tregistry,
                        "sparkdl_replica_reintegrated_total") == rejoined0 + 1
        before = runners[0].calls
        for i in range(8):
            pool.run_batch(_batch(4, seed=i))
        assert runners[0].calls > before
    finally:
        pool.close()


def test_failed_probe_backs_off_exponentially(monkeypatch):
    clock = _Clock()
    monkeypatch.setattr(treplicas, "time", clock)
    pool, runners = _scripted_pool(probation_s=0.05, probation_max_s=0.15)
    try:
        runners[0].failing = True
        for i in range(4):
            pool.run_batch(_batch(4, seed=i))
        seen = []
        for _ in range(4):
            clock.now += pool.replicas[0].probation_backoff_s
            pool.run_batch(_batch(2, seed=7))  # rides the due probe, re-routed
            seen.append(pool.replicas[0].probation_backoff_s)
        assert seen == [0.1, 0.15, 0.15, 0.15]  # doubled, capped
        assert pool.snapshot()["replicas"][0]["quarantined"]
    finally:
        pool.close()


def test_all_quarantined_recovers_via_probe(monkeypatch):
    clock = _Clock()
    monkeypatch.setattr(treplicas, "time", clock)
    pool, runners = _scripted_pool(probation_s=0.05, max_failures=1)
    try:
        for r in runners:
            r.failing = True
        with pytest.raises(RuntimeError):
            pool.run_batch(_batch(2))
        with pytest.raises(AllReplicasQuarantinedError):
            pool.run_batch(_batch(2))
        for r in runners:
            r.failing = False
        clock.now += 0.05
        out = pool.run_batch(_batch(3, seed=1))  # served as a probe
        np.testing.assert_array_equal(out, _runner().run_batch(_batch(3, seed=1)))
        assert pool.snapshot()["healthy_count"] >= 1
    finally:
        pool.close()


def test_failed_last_ditch_probe_surfaces_typed_error(monkeypatch):
    clock = _Clock()
    monkeypatch.setattr(treplicas, "time", clock)
    pool, runners = _scripted_pool(probation_s=0.05, max_failures=1)
    try:
        for r in runners:
            r.failing = True
        with pytest.raises(RuntimeError):
            pool.run_batch(_batch(2))
        clock.now += 0.05
        with pytest.raises(AllReplicasQuarantinedError) as ei:
            pool.run_batch(_batch(2, seed=1))
        assert "scripted executor failure" in str(ei.value.__cause__)
    finally:
        pool.close()


def test_probation_none_is_permanent_quarantine(monkeypatch):
    clock = _Clock()
    monkeypatch.setattr(treplicas, "time", clock)
    pool, runners = _scripted_pool(probation_s=None, max_failures=1)
    try:
        for r in runners:
            r.failing = True
        with pytest.raises(RuntimeError):
            pool.run_batch(_batch(2))
        clock.now += 1e6
        with pytest.raises(AllReplicasQuarantinedError):
            pool.run_batch(_batch(2))
    finally:
        pool.close()


def test_hung_dispatch_watchdog_fails_work_and_pool_survives(wait_until):
    hung0 = _counter(tregistry, "sparkdl_replica_hung_total")
    pool, _ = _scripted_pool(hang=(1.0,), dispatch_timeout_s=0.15,
                             probation_s=600.0, max_reroutes=0)
    try:
        t0 = time.monotonic()
        with pytest.raises(HungDispatchError):
            pool.warmup(_batch(8))
        assert time.monotonic() - t0 < 0.9
        assert _counter(tregistry, "sparkdl_replica_hung_total") > hung0
        snap = pool.snapshot()
        assert snap["replicas"][0]["quarantined"] and snap["replicas"][0]["hung"]
        single = _runner()
        np.testing.assert_array_equal(pool.run_batch(_batch(4, seed=1)),
                                      single.run_batch(_batch(4, seed=1)))
        wait_until(lambda: pool.snapshot()["healthy_count"] == 2,
                   interval_s=0.05, desc="wedged replica rejoined")
        np.testing.assert_array_equal(pool.run_batch(_batch(3, seed=2)),
                                      single.run_batch(_batch(3, seed=2)))
    finally:
        pool.close()


def test_hung_replica_rejoins_when_wedged_dispatch_errors(wait_until):
    pool, _ = _scripted_pool(hang=(0.5,), hang_raises=True,
                             dispatch_timeout_s=0.1, probation_s=0.05,
                             probation_max_s=1.0)
    try:
        with pytest.raises(HungDispatchError):
            pool.warmup(_batch(8))
        assert pool.snapshot()["replicas"][0]["hung"]

        def healed():
            pool.run_batch(_batch(4, seed=3))  # traffic carries the probe
            return pool.snapshot()["healthy_count"] == 2

        wait_until(healed, interval_s=0.02, desc="probe reintegrated replica 0")
        assert not pool.snapshot()["replicas"][0]["hung"]
    finally:
        pool.close()


def test_hung_dispatch_rerouted_rider_gets_result(wait_until):
    hang = threading.Event()
    made = []

    def make_runner(device):
        inner = _runner()

        class _R:
            chunk_size = inner.chunk_size
            sleepy = not made

            def run_batch(self, arrays):
                if self.sleepy and hang.is_set():
                    time.sleep(1.0)
                return inner.run_batch(arrays)

        made.append(_R())
        return made[-1]

    pool = ReplicaPool(make_runner=make_runner, devices=[CPU] * 2,
                       n_replicas=2, dispatch_timeout_s=0.15,
                       probation_s=600.0)
    try:
        pool.warmup(_batch(8))
        single = _runner()
        recovered0 = _counter(tregistry, "sparkdl_retries_total",
                              site="replica.execute", outcome="recovered")
        hang.set()
        futs = [pool.run_batch_async(_batch(4, seed=s)) for s in range(2)]
        for s, f in enumerate(futs):
            np.testing.assert_array_equal(f.result(timeout=10),
                                          single.run_batch(_batch(4, seed=s)))
        assert pool.snapshot()["replicas"][0]["hung"]
        hang.clear()
        wait_until(lambda: not pool.snapshot()["replicas"][0]["hung"],
                   interval_s=0.05, desc="hung-freeze lifted")
        assert _counter(tregistry, "sparkdl_retries_total",
                        site="replica.execute",
                        outcome="recovered") == recovered0 + 1
    finally:
        pool.close()


def test_no_probe_when_reroutes_disabled(monkeypatch):
    clock = _Clock()
    monkeypatch.setattr(treplicas, "time", clock)
    pool, runners = _scripted_pool(max_reroutes=0, probation_s=0.05,
                                   probation_max_s=0.5)
    try:
        runners[0].failing = True
        for _ in range(8):  # ties round-robin: replica 0 takes every other
            if pool.snapshot()["replicas"][0]["quarantined"]:
                break
            try:
                pool.run_batch(_batch(4, seed=1))
            except RuntimeError:
                pass
        assert pool.snapshot()["replicas"][0]["quarantined"]
        calls = runners[0].calls
        clock.now += 10.0  # probation long elapsed
        single = _runner()
        for seed in range(8):
            np.testing.assert_array_equal(pool.run_batch(_batch(4, seed=seed)),
                                          single.run_batch(_batch(4, seed=seed)))
        assert runners[0].calls == calls
    finally:
        pool.close()


def test_warmup_failure_surfaces_not_rerouted():
    pool, runners = _scripted_pool()
    try:
        runners[1].failing = True
        with pytest.raises(RuntimeError, match="scripted"):
            pool.warmup(_batch(8))
    finally:
        pool.close()


@pytest.mark.parametrize("kw,match", [
    (dict(probation_s=0.0), "probation_s"),
    (dict(max_reroutes=-1), "max_reroutes"),
    (dict(dispatch_timeout_s=0.0), "dispatch_timeout_s"),
])
def test_reliability_knob_validation(kw, match):
    # validated before any device is looked at: the same error with no card
    with pytest.raises(ValueError, match=match):
        ReplicaPool(_apply, n_replicas=1, **kw)


def test_snapshot_carries_reliability_fields():
    with _pool(2) as pool:
        snap = pool.snapshot()
        r0 = pool.replicas[0]
        assert isinstance(r0.breaker, ProbationBreaker)
        r0.breaker.record_failure(now=0.0)
        assert r0.consecutive_failures == 1
    r = snap["replicas"][0]
    assert {"quarantined", "hung", "probing", "next_probe_in_s", "device",
            "latency_s"} <= set(r)
    assert r["device"] == "cpu"


# -- elasticity ----------------------------------------------------------------

def test_add_and_remove_replica_lose_nothing():
    single = _runner()
    with _pool(2) as pool:
        idx = pool.add_replica(warmup_arrays=_batch(4))
        assert idx == 2 and pool.snapshot()["replica_count"] == 3
        futs = [pool.run_batch_async(_batch(3, seed=i)) for i in range(12)]
        with tfaults.inject("replica.scale_down:RuntimeError@1"):
            with pytest.raises(RuntimeError):
                pool.remove_replica()  # the fault aborts before any state moves
        assert pool.snapshot()["replica_count"] == 3
        gone = pool.remove_replica(0)
        assert gone == 0 and [r.index for r in pool.replicas] == [1, 2]
        for i, f in enumerate(futs):
            np.testing.assert_array_equal(f.result(timeout=30),
                                          single.run_batch(_batch(3, seed=i)))
        pool.remove_replica()
        with pytest.raises(ValueError, match="below one replica"):
            pool.remove_replica()


# -- the runner placement and the ServingEngine over a pool ---------------------

def test_pool_devices_and_the_single_device_partitioner():
    from sparkdl_tpu.partition import SingleDevicePartitioner as JaxSDP

    part = SingleDevicePartitioner("cpu")
    runner = BatchedRunner(_apply, batch_size=4, partitioner=part)
    assert runner.device == CPU
    assert set(part.describe()) == set(JaxSDP().describe())
    assert part.wrap_apply(_apply) is _apply
    moved = part.shard_batch({"x": np.ones((2, DIM), np.float32)})
    assert moved["x"].device == CPU
    with pytest.raises(ValueError, match="one or the other"):
        BatchedRunner(_apply, partitioner=_FakeCudaPart(), device="cpu")
    with pytest.raises(TypeError, match="LocalDevicePartitioner"):
        BatchedRunner(_apply, partitioner=object(), device="cpu")
    # the reference's rule: device= pins one device, dp is the pool's job
    with pytest.raises(ValueError, match="ReplicaPool's job"):
        BatchedRunner(_apply, data_parallel=True, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            SingleDevicePartitioner()
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ReplicaPool(_apply)


class _FakeCudaPart(SingleDevicePartitioner):
    """A partitioner that claims the card, built without one."""

    def __init__(self):
        self.device = torch.device("cuda", 0)


def test_serving_engine_over_pool_end_to_end():
    with _pool(2) as pool:
        pool.warmup(_batch(8))
        with ServingEngine(pool, max_wait_s=0.002) as eng:
            futs = [eng.submit({"x": np.full((DIM,), float(i), np.float32)})
                    for i in range(48)]
            for i, f in enumerate(futs):
                np.testing.assert_allclose(
                    f.result(timeout=30),
                    np.tanh(np.full((DIM,), float(i), np.float32) @ _W),
                    rtol=1e-6)
            snap = eng.snapshot()
        assert snap["replica_count"] == 2 and snap["capacity"]["replica_count"] == 2
        assert {"depth", "in_flight", "quarantined"} <= set(snap["replicas"][0])
        assert snap["completed"] == 48


def test_engine_poison_row_retry_routes_through_pool():
    class _Poison:
        def __init__(self):
            self.inner = _runner()
            self.chunk_size = self.inner.chunk_size

        def run_batch(self, arrays):
            if np.isnan(arrays["x"]).any():
                raise RuntimeError("poison batch")
            return self.inner.run_batch(arrays)

    pool = ReplicaPool(make_runner=lambda d: _Poison(), devices=[CPU] * 2,
                       n_replicas=2)
    try:
        with ServingEngine(pool, max_wait_s=0.05) as eng:
            good = [eng.submit({"x": np.full((DIM,), 1.0, np.float32)})
                    for _ in range(3)]
            bad = eng.submit({"x": np.full((DIM,), np.nan, np.float32)})
            for f in good:
                assert f.result(timeout=30) is not None
            with pytest.raises(RuntimeError, match="poison batch"):
                bad.result(timeout=30)
    finally:
        pool.close()


def test_replica_pool_soak_small():
    """Bursty load over a 2-replica pool through the ServingEngine: every
    request served, rows bitwise the single runner's, pool drains clean."""
    single = _runner()
    rng = np.random.default_rng(11)
    rows = [rng.standard_normal(DIM).astype(np.float32) for _ in range(200)]
    with _pool(2) as pool:
        pool.warmup(_batch(8))
        with ServingEngine(pool, max_queue_depth=1024, max_wait_s=0.001) as eng:
            futs = []
            for i, r in enumerate(rows):
                futs.append(eng.submit({"x": r}))
                if i % 50 == 49:
                    time.sleep(0.005)  # bursty arrival
            expect = list(single.run({"x": r} for r in rows))
            for i, f in enumerate(futs):
                np.testing.assert_array_equal(f.result(timeout=60), expect[i])
            snap = eng.snapshot()
    assert snap["completed"] == 200 and snap["failed"] == 0
    assert all(r["depth"] == 0 for r in snap["replicas"])
    assert all(r["dispatched"] > 0 for r in snap["replicas"])
