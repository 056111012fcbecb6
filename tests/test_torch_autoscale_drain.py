"""Runtime elasticity on the port's REAL actuators: ReplicaPool
add/remove under live traffic (the drain contract — zero accepted
batches lost, every answer the JAX pool's within float32 rounding),
Router add_host/remove_host riding the shared drain-transfer path with
sticky-session/digest purge over a tiny GPT fleet (weights bridged from
the reference's Flax variables; tokens equal to the JAX engine's), and
the AutoScaler driving both through a scale cycle.
"""

import threading

import numpy as np
import pytest
import torch

from sparkdl_torch.autoscale import AutoScaler, AutoscalePolicy
from sparkdl_torch.fabric.host import InProcessHost
from sparkdl_torch.fabric.router import Router
from sparkdl_torch.observability import flight
from sparkdl_torch.observability.registry import registry
from sparkdl_torch.reliability import faults
from sparkdl_torch.reliability.faults import inject
from sparkdl_torch.serving import ContinuousGPTEngine, ReplicaPool, ServingEngine
from sparkdl_torch.transformers._inference import BatchedRunner

DIM = 6
_W = np.random.default_rng(3).standard_normal((DIM, DIM)).astype(np.float32)
_TW = torch.as_tensor(_W)
CPU = torch.device("cpu")
POOL_TOL = 1e-6  # float32 tanh(x @ W) in torch vs numpy: the sums may round apart


def _apply(b):
    return torch.tanh(b["x"] @ _TW)


def _expect(v, rows):
    return np.tanh(np.full((rows, DIM), v, np.float32) @ _W)


def setup_function(_fn):
    faults.disarm()


class _SlowRunner:
    """Wraps a runner with a holdable gate so work piles up in replica
    queues deterministically; records each dispatch's row count."""

    def __init__(self, inner, pool_size):
        self._inner = inner
        self.gate = threading.Event()
        self.gate.set()
        self.chunk_size = inner.chunk_size
        self.served = 0
        self.rows = []
        self.pool_sizes = []
        self._pool_size = pool_size

    def run_batch(self, arrays):
        self.gate.wait(30)
        self.served += 1
        self.rows.append(len(arrays["x"]))
        self.pool_sizes.append(self._pool_size())
        return self._inner.run_batch(arrays)


def _make_pool(n=2, **kw):
    runners = []
    made = []

    def make_runner(device):
        r = _SlowRunner(BatchedRunner(_apply, batch_size=8, device=device),
                        lambda: len(made[0].replicas) if made else 0)
        runners.append(r)
        return r

    made.append(ReplicaPool(make_runner=make_runner, n_replicas=n,
                            devices=[CPU] * n, **kw))
    return made[0], runners


def test_add_replica_joins_routing_and_serves():
    pool, runners = _make_pool(n=1)
    try:
        pool.warmup({"x": np.zeros((4, DIM), np.float32)})
        idx = pool.add_replica(
            warmup_arrays={"x": np.zeros((4, DIM), np.float32)})
        assert idx == 1
        assert len(pool.replicas) == 2
        assert pool.max_inflight_batches == 3
        # both replicas take traffic (least-outstanding + rr ties)
        futs = [pool.run_batch_async(
            {"x": np.zeros((4, DIM), np.float32)}) for _ in range(8)]
        for f in futs:
            f.result(30)
        assert all(r.served > 0 for r in runners)
        # indices are never reused across scale cycles
        pool.remove_replica(index=1)
        assert pool.add_replica() == 2
    finally:
        pool.close()


def test_add_replica_warms_every_bucket_before_it_routes():
    """A list of warmup batches (one per bucket) runs in order on the new
    replica, all before it joins routing: its first live batch finds
    every bucket's program already built."""
    pool, runners = _make_pool(n=1)
    try:
        pool.warmup({"x": np.zeros((1, DIM), np.float32)})
        buckets = (2, 4, 8)
        pool.add_replica(warmup_arrays=[
            {"x": np.zeros((b, DIM), np.float32)} for b in buckets])
        new = runners[1]
        assert new.rows == list(buckets)
        # the pool had ONE routed replica at each warmup dispatch
        assert new.pool_sizes == [1, 1, 1]
        assert len(pool.replicas) == 2
        futs = [pool.run_batch_async({"x": np.ones((1, DIM), np.float32)})
                for _ in range(6)]
        for f in futs:
            f.result(30)
        assert len(new.rows) > len(buckets)  # it routes now
    finally:
        pool.close()


def test_add_replica_failed_warmup_never_joins():
    pool, runners = _make_pool(n=1)
    try:
        with pytest.raises(Exception):
            pool.add_replica(warmup_arrays=[
                {"x": np.zeros((2, DIM), np.float32)},
                {"x": np.zeros((2, DIM + 1), np.float32)}])  # bad width
        assert len(pool.replicas) == 1
    finally:
        pool.close()


def test_remove_replica_transfers_queued_work_zero_lost():
    pool, runners = _make_pool(n=2)
    try:
        pool.warmup({"x": np.zeros((2, DIM), np.float32)})
        # hold replica 1's executor so its queue builds
        runners[1].gate.clear()
        futs = []
        vals = []
        for i in range(12):
            v = float(i % 7)
            vals.append(v)
            futs.append(pool.run_batch_async(
                {"x": np.full((2, DIM), v, np.float32)}))
        # scale down the WEDGED replica: its queued work must transfer
        # to the survivor; the in-flight batch finishes once the gate
        # opens (remove_replica joins the worker)
        t = threading.Timer(0.3, runners[1].gate.set)
        t.start()
        removed = pool.remove_replica(index=1, timeout_s=30.0)
        t.cancel()
        runners[1].gate.set()
        assert removed == 1
        assert len(pool.replicas) == 1
        # ZERO accepted batches lost: every future resolves correctly
        for v, f in zip(vals, futs):
            np.testing.assert_allclose(np.asarray(f.result(30)),
                                       _expect(v, 2), rtol=0, atol=POOL_TOL)
    finally:
        pool.close()


def test_remove_replica_prefers_quarantined_victim():
    pool, runners = _make_pool(n=2, max_failures=1, probation_s=600.0)
    try:
        pool.warmup({"x": np.zeros((2, DIM), np.float32)})
        r0 = pool.replicas[0]
        with pool._lock:
            r0.breaker.record_failure()
        assert r0.quarantined
        assert pool.remove_replica() == 0  # the broken one goes first
        assert [r.index for r in pool.replicas] == [1]
    finally:
        pool.close()


def test_remove_last_replica_refuses():
    pool, _ = _make_pool(n=1)
    try:
        with pytest.raises(ValueError, match="below one replica"):
            pool.remove_replica()
    finally:
        pool.close()


def test_scale_down_fault_aborts_before_any_state_moves():
    """The replica.scale_down site fires BEFORE the victim leaves
    routing: an injected fault defers the whole scale-down — no work
    moves, no replica vanishes, traffic unaffected."""
    pool, _ = _make_pool(n=2)
    try:
        pool.warmup({"x": np.zeros((2, DIM), np.float32)})
        with inject("replica.scale_down:OSError@1"):
            with pytest.raises(OSError):
                pool.remove_replica()
        assert len(pool.replicas) == 2
        futs = [pool.run_batch_async(
            {"x": np.zeros((2, DIM), np.float32)}) for _ in range(4)]
        for f in futs:
            f.result(30)
        # clean retry succeeds
        assert pool.remove_replica() in (0, 1)
        assert len(pool.replicas) == 1
    finally:
        pool.close()


def test_retiring_replica_stays_under_watchdog_scan(wait_until):
    """A victim whose in-flight dispatch wedges DURING retirement must
    stay on the watchdog's scan list: its riders get the same deadline
    re-route every live dispatch gets, instead of hanging forever on a
    removed replica."""
    pool, runners = _make_pool(n=2, dispatch_timeout_s=0.2,
                               probation_s=600.0)
    try:
        pool.warmup({"x": np.zeros((2, DIM), np.float32)})
        runners[1].gate.clear()  # wedge replica 1's executor
        # two concurrent works: least-outstanding spreads one per replica
        futs = [pool.run_batch_async(
            {"x": np.full((2, DIM), 1.0, np.float32)}) for _ in range(2)]
        wait_until(lambda: any(r.current_work is not None
                               for r in pool.replicas
                               if r.index == 1),
                   desc="work in flight on replica 1")
        # retire the wedged replica; the join times out (0.1 < gate)
        assert pool.remove_replica(index=1, timeout_s=0.1) == 1
        # the watchdog must deadline-fail the wedged dispatch and
        # re-route it to the survivor — riders resolve, nothing hangs
        for f in futs:
            np.testing.assert_allclose(np.asarray(f.result(10)),
                                       _expect(1.0, 2), rtol=0, atol=POOL_TOL)
        fam = registry().get("sparkdl_replica_hung_total")
        assert fam is not None and \
            fam.snapshot_values().get("", 0.0) >= 1
    finally:
        runners[1].gate.set()
        pool.close()


def test_scale_events_land_in_flight_ring():
    pool, _ = _make_pool(n=1)
    try:
        pool.add_replica()
        pool.remove_replica()
        kinds = {e.get("kind") for e in flight.flight_recorder().events()
                 if str(e.get("kind", "")).startswith("pool.scale_")}
        assert {"pool.scale_up", "pool.scale_down"} <= kinds
    finally:
        pool.close()


def _jax_rows():
    """The JAX package's ReplicaPool over the same tanh(x @ W): the rows
    each value's request must come back as."""
    import jax.numpy as jnp

    from sparkdl_tpu.serving import ReplicaPool as JaxPool

    jw = jnp.asarray(_W)
    pool = JaxPool(lambda b: jnp.tanh(b["x"] @ jw), batch_size=8,
                   n_replicas=1)
    try:
        return {v: np.asarray(pool.run_batch(
            {"x": np.full((1, DIM), float(v), np.float32)})[0])
            for v in range(5)}
    finally:
        pool.close()


def test_engine_over_elastic_pool_keeps_serving():
    """ServingEngine riding a pool that scales mid-traffic: every
    submitted request resolves with the JAX pool's answer."""
    registry().reset()
    want = _jax_rows()
    pool, _ = _make_pool(n=1)
    engine = ServingEngine(pool, max_queue_depth=4096, max_wait_s=0.001)
    try:
        pool.warmup({"x": np.zeros((1, DIM), np.float32)})
        futs = []
        for i in range(60):
            futs.append(engine.submit(
                {"x": np.full((DIM,), float(i % 5), np.float32)}))
            if i == 20:
                pool.add_replica()
            if i == 40:
                pool.remove_replica()
        for i, f in enumerate(futs):
            np.testing.assert_allclose(np.asarray(f.result(60)),
                                       want[i % 5], rtol=0, atol=POOL_TOL)
        snap = engine.snapshot()
        assert snap["completed"] == 60
        assert snap["failed"] == 0
    finally:
        engine.close()
        pool.close()


def test_autoscaler_scale_cycle_on_a_live_pool_loses_nothing():
    """The controller on the real actuator: sustained queue pressure
    adds a warmed replica, quiet removes it again through the drain
    path, while requests keep flowing — each answer the same row."""
    pool, runners = _make_pool(n=1)
    engine = ServingEngine(pool, max_queue_depth=4096, max_wait_s=0.001)
    sig = {"depth": 0.0}
    sc = AutoScaler(pool=pool, signals=lambda: (sig["depth"], 0.0),
                    warmup_arrays=[{"x": np.zeros((b, DIM), np.float32)}
                                   for b in (1, 2, 4, 8)],
                    policy=AutoscalePolicy(max_replicas=2, hysteresis=2,
                                           cooldown_ticks=1))
    log = []
    record = sc._record
    sc._record = lambda a, d, **kw: (log.append((a, d)), record(a, d, **kw))
    try:
        futs = [engine.submit({"x": np.full((DIM,), float(i % 5),
                                            np.float32)}) for i in range(20)]
        sig["depth"] = 40.0
        for _ in range(4):
            sc.tick()
        futs += [engine.submit({"x": np.full((DIM,), float(i % 5),
                                             np.float32)}) for i in range(20)]
        sig["depth"] = 0.0
        for _ in range(4):
            sc.tick()
        futs += [engine.submit({"x": np.full((DIM,), float(i % 5),
                                             np.float32)}) for i in range(20)]
        for i, f in enumerate(futs):
            np.testing.assert_allclose(np.asarray(f.result(60)),
                                       _expect(float(i % 5), 1)[0],
                                       rtol=0, atol=POOL_TOL)
        assert log == [("replica", "up"), ("replica", "down")]
        assert len(pool.replicas) == 1
        # the added replica ran its four warmup batches first
        assert runners[1].rows[:4] == [1, 2, 4, 8]
        assert engine.snapshot()["failed"] == 0
    finally:
        sc.close()
        engine.close()
        pool.close()


# -- fabric tier ---------------------------------------------------------------

MAX_LEN = 32


@pytest.fixture(scope="module")
def gpt():
    """The tiny GPT in both packages (weights bridged by
    gpt_flax_to_torch) and the JAX engine's tokens for the prompts the
    fleet tests send."""
    from torch_parity import gpt_pair

    from sparkdl_tpu.serving import ContinuousGPTEngine as JaxEngine

    jm, variables, module = gpt_pair(0)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, module.config.vocab_size, n).tolist()
               for n in (8, 12, 12, 9, 10, 7, 11, 8)]
    eng = JaxEngine(jm.config, variables, n_slots=2, max_len=MAX_LEN,
                    kv_layout="paged", kv_block_size=4, auto_start=False)
    futs = [eng.submit(p, 3) for p in prompts]
    while not all(f.done() for f in futs):
        eng.tick()
    want = [np.asarray(f.result(0)).tolist() for f in futs]
    eng.close()
    return module.config, module, prompts, want


def _gpt_fleet(gpt, n=2):
    cfg, module = gpt[:2]
    engines = [
        ContinuousGPTEngine(cfg, module, device="cpu", n_slots=2,
                            max_len=MAX_LEN, kv_layout="paged",
                            kv_block_size=4, idle_wait_s=0.001,
                            host_id=f"h{i}")
        for i in range(n)
    ]
    hosts = [InProcessHost(e, host_id=e.host_id) for e in engines]
    router = Router(hosts[:n], auto_refresh=False)
    return engines, hosts, router


def _tokens(fut):
    return np.asarray(fut.result(30)).tolist()


def test_router_remove_host_drains_and_purges_then_add_host_rejoins(gpt):
    cfg, module, prompts, want = gpt
    engines, hosts, router = _gpt_fleet(gpt, 2)
    try:
        payload = {"prompt": prompts[0], "max_new_tokens": 3}
        # pin a sticky session onto h0
        assert _tokens(router.submit(payload, session="s1")) == want[0]
        router.refresh()
        assert router._sessions.get("s1") == "h0"
        # fleet scale-down: drain + forget h0, handle returned
        handle = router.remove_host("h0")
        assert handle is hosts[0]
        assert router.hosts() == ["h1"]
        # sticky session purged: the next turn re-places on a survivor
        assert "s1" not in router._sessions
        assert _tokens(router.submit(payload, session="s1")) == want[0]
        assert router._sessions.get("s1") == "h1"
        # removing the last host refuses
        with pytest.raises(ValueError, match="last fabric host"):
            router.remove_host("h1")
        # a FRESH host joins at runtime and takes traffic
        e2 = ContinuousGPTEngine(cfg, module, device="cpu", n_slots=2,
                                 max_len=MAX_LEN, kv_layout="paged",
                                 kv_block_size=4, idle_wait_s=0.001,
                                 host_id="h2")
        engines.append(e2)
        assert router.add_host(InProcessHost(e2, host_id="h2")) == "h2"
        assert set(router.hosts()) == {"h1", "h2"}
        with pytest.raises(ValueError, match="duplicate host id"):
            router.add_host(InProcessHost(e2, host_id="h2"))
        futs = [router.submit({"prompt": p, "max_new_tokens": 3})
                for p in prompts[1:5]]
        assert [_tokens(f) for f in futs] == want[1:5]
    finally:
        router.close()
        for e in engines:
            e.close(drain=False)


def test_drain_purges_prefix_digest_immediately(gpt):
    cfg, module, prompts, want = gpt
    engines, hosts, router = _gpt_fleet(gpt, 2)
    try:
        assert _tokens(router.submit(
            {"prompt": prompts[1], "max_new_tokens": 3})) == want[1]
        router.refresh()  # digests seeded from the radix caches
        assert any(s.digest is not None and s.digest.hashes
                   for s in router._hosts.values())
        drained = [s for s in router._hosts.values()
                   if s.digest is not None][0]
        router.drain_host(drained.host_id)
        # the departing host's digest is gone THE MOMENT drain begins:
        # affinity can no longer steer placements at a dying cache
        assert router._hosts[drained.host_id].digest is None
    finally:
        router.close()
        for e in engines:
            e.close(drain=False)


def test_autoscaler_parks_and_rejoins_a_live_host(gpt):
    """The fleet tier both ways over real engines: quiet parks the
    least-loaded host on spare_hosts (drained), pressure reopens and
    rejoins it, and every request of the cycle gets the JAX engine's
    tokens — zero lost."""
    cfg, module, prompts, want = gpt
    engines, hosts, router = _gpt_fleet(gpt, 2)
    depth = [0.0]
    sc = AutoScaler(router=router, signals=lambda: (depth[0], 0.0),
                    policy=AutoscalePolicy(hysteresis=1, cooldown_ticks=0,
                                           queue_high=2.0, queue_low=0.5))
    try:
        assert sc.tick() == 1  # quiet -> park one host
        (parked,) = sc.spare_hosts
        assert parked.draining and router.hosts() == [
            h.host_id for h in hosts if h is not parked]
        futs = [router.submit({"prompt": p, "max_new_tokens": 3})
                for p in prompts[:4]]
        depth[0] = 8.0
        assert sc.tick() == 1  # pressure -> reopen + add_host
        assert not sc.spare_hosts and not parked.draining
        assert sorted(router.hosts()) == ["h0", "h1"]
        futs += [router.submit({"prompt": p, "max_new_tokens": 3})
                 for p in prompts[4:]]
        assert [_tokens(f) for f in futs] == want
        assert sc.snapshot()["autoscaler"]["hosts"] == 2
    finally:
        sc.close()
        router.close()
        for e in engines:
            e.close(drain=False)


# -- the KV actuator on a live engine ------------------------------------------

def test_engine_lock_is_granted_in_arrival_order(wait_until):
    """A thread that waits for the engine lock gets it before the loop
    takes it again: the loop re-takes the lock at once after each tick,
    and with a plain lock would win that race every time."""
    from sparkdl_torch.serving.continuous import _FifoLock

    lock = _FifoLock()
    order = []

    def taker(name):
        with lock:
            order.append(name)

    lock.acquire()
    threads = []
    for name in ("first", "second", "third"):
        threads.append(threading.Thread(target=taker, args=(name,)))
        threads[-1].start()
        wait_until(lambda: lock._next == len(threads) + 1,
                   desc=f"{name} queued")
    lock.release()
    with lock:  # the releasing loop's next tick queues behind them
        order.append("loop")
    for t in threads:
        t.join(10)
    assert order == ["first", "second", "third", "loop"]


def test_engine_lock_excludes_under_thread_churn():
    """More threads than cores and a short switch interval: every
    read-modify-write under the lock lands (none lost)."""
    import os
    import sys

    from sparkdl_torch.serving.continuous import _FifoLock

    lock = _FifoLock()
    count = [0]
    n_threads, per = min(4 * (os.cpu_count() or 1) + 4, 36), 100

    def bump():
        for _ in range(per):
            with lock:
                v = count[0]
                count[0] = v + 1

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=bump) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert count[0] == n_threads * per


def test_kv_grow_lands_while_a_live_engine_is_busy(gpt):
    """The scaler thread's KV actuator takes the ENGINE's lock
    (kv_autoscale_binding): it must get it while the engine loop is busy
    deferring admissions, not only once the burst is over — and the
    tokens stay the JAX engine's."""
    import time

    cfg, module, prompts, want = gpt
    eng = ContinuousGPTEngine(cfg, module, device="cpu", n_slots=2,
                              max_len=MAX_LEN, kv_layout="paged",
                              kv_block_size=4, idle_wait_s=0.001)
    pool, lock = eng.kv_autoscale_binding()
    with lock:
        assert pool.shrink(pool.free_count - 4) > 0  # 4 blocks serve
    # a queue deep enough that the scaler never shrinks, never a vote
    sc = AutoScaler(kv_pool=pool, kv_lock=lock, signals=lambda: (1.0, 0.0),
                    interval_s=0.002,
                    policy=AutoscalePolicy(kv_step_blocks=2, cooldown_ticks=0,
                                           hysteresis=1))
    grows = []
    record = sc._record
    sc._record = lambda a, d, **kw: (grows.append(time.monotonic()),
                                     record(a, d, **kw))
    try:
        sc.start()
        futs = [eng.submit(p, 3) for p in prompts * 4]
        got = [_tokens(f) for f in futs]
        done = time.monotonic()
    finally:
        sc.close()
        eng.close()
    assert got == want * 4
    assert grows and grows[0] < done
