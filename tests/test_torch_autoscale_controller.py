"""The port's AutoScaler against the JAX package's: the control law
(hysteresis no-flap, cooldown, veto-revert + tabu, pin convergence,
deferred decisions on injected faults, KV grow/shrink discipline,
fleet-tier scale-down and rejoin), first as the reference's own tests
ported, then tick by tick against the reference controller.

Deterministic: a scripted signal reader, an injected clock and
pure-Python fake actuators drive ``tick()`` by hand; the real actuators
are in ``test_torch_autoscale_drain.py`` and the chaos soak.
"""

import threading

import pytest

from sparkdl_torch.autoscale import AutoScaler, AutoscalePolicy
from sparkdl_torch.observability.flight import healthz_report
from sparkdl_torch.observability.registry import registry
from sparkdl_torch.reliability import faults
from sparkdl_torch.reliability.faults import fault_point, inject
from sparkdl_torch.serving.kv_blocks import KVBlockPool


class _FakeReplica:
    quarantined = False


class _FakePool:
    """ReplicaPool's elasticity surface, counted instead of executed.
    ``site`` is the package's ``fault_point`` the scale-down passes."""

    def __init__(self, n=1, site=fault_point):
        self.replicas = [_FakeReplica() for _ in range(n)]
        self._next = n
        self.adds = 0
        self.removes = 0
        self._site = site

    def add_replica(self, *, warmup_arrays=None):
        self.replicas.append(_FakeReplica())
        self.adds += 1
        self._next += 1
        return self._next - 1

    def remove_replica(self, index=None, *, timeout_s=30.0):
        self._site("replica.scale_down")
        if len(self.replicas) <= 1:
            raise ValueError("cannot scale below one replica")
        self.replicas.pop()
        self.removes += 1
        return len(self.replicas)

    def snapshot(self):
        return {"replica_count": len(self.replicas),
                "healthy_count": len(self.replicas)}


class _Sig:
    def __init__(self, depth=0.0, burn=0.0):
        self.depth = depth
        self.burn = burn

    def __call__(self):
        return self.depth, self.burn


def _scaler(pool=None, *, hysteresis=2, cooldown=2, sig=None, **kw):
    policy = AutoscalePolicy(
        max_replicas=kw.pop("max_replicas", 4),
        min_replicas=kw.pop("min_replicas", 1),
        hysteresis=hysteresis, cooldown_ticks=cooldown,
        veto_window_ticks=kw.pop("veto_window_ticks", 3),
        veto_burn=kw.pop("veto_burn", 2.0),
        tabu_ticks=kw.pop("tabu_ticks", 6),
        kv_step_blocks=kw.pop("kv_step_blocks", 4),
    )
    return AutoScaler(pool=pool, policy=policy, signals=sig or _Sig(),
                      **kw)


def setup_function(_fn):
    faults.disarm()


# -- the reference's controller tests, ported ---------------------------------

def test_needs_at_least_one_actuator():
    with pytest.raises(ValueError, match="actuator"):
        AutoScaler()


def test_kv_pool_needs_its_lock():
    with pytest.raises(ValueError, match="kv_lock"):
        AutoScaler(kv_pool=KVBlockPool(8, 4))


def test_hysteresis_gates_scale_up():
    pool = _FakePool(1)
    sig = _Sig(depth=40.0)
    sc = _scaler(pool, hysteresis=3, sig=sig)
    try:
        assert sc.tick() == 0  # streak 1
        assert sc.tick() == 0  # streak 2
        assert sc.tick() == 1  # streak 3 -> move
        assert pool.adds == 1
        assert len(pool.replicas) == 2
        assert sc.snapshot()["autoscaler"]["last_decision"][
            "direction"] == "up"
    finally:
        sc.close()


def test_alternating_signals_never_flap():
    """A signal that never HOLDS a direction for `hysteresis` ticks
    moves nothing — the no-flap contract."""
    pool = _FakePool(2)
    sig = _Sig()
    sc = _scaler(pool, hysteresis=2, sig=sig)
    try:
        for i in range(20):
            # alternate: up-vote, down-vote, up-vote...
            if i % 2 == 0:
                sig.depth, sig.burn = 40.0, 0.0
            else:
                sig.depth, sig.burn = 0.0, 0.0
            assert sc.tick() == 0
        assert pool.adds == 0 and pool.removes == 0
    finally:
        sc.close()


def test_cooldown_blocks_consecutive_moves():
    pool = _FakePool(1)
    sig = _Sig(depth=40.0)
    sc = _scaler(pool, hysteresis=1, cooldown=3, sig=sig)
    try:
        assert sc.tick() == 1  # move
        assert sc.tick() == 0  # cooldown 3->2
        assert sc.tick() == 0  # 2->1
        assert sc.tick() == 0  # 1->0
        assert sc.tick() == 1  # next move
        assert pool.adds == 2
    finally:
        sc.close()


def test_scale_down_needs_quiet_queue_AND_quiet_burn():
    pool = _FakePool(2)
    # queue quiet but burn hot: the conjunctive gate must not shrink
    sig = _Sig(depth=0.0, burn=0.9)
    sc = _scaler(pool, hysteresis=1, sig=sig)
    try:
        for _ in range(5):
            sc.tick()
        assert pool.removes == 0
        sig.burn = 0.0
        assert sc.tick() == 1
        assert pool.removes == 1
    finally:
        sc.close()


def test_veto_reverts_scale_down_and_tabus_direction():
    registry().reset()
    pool = _FakePool(2)
    sig = _Sig(depth=0.0, burn=0.0)
    sc = _scaler(pool, hysteresis=1, cooldown=2, veto_burn=2.0,
                 tabu_ticks=4, sig=sig)
    try:
        assert sc.tick() == 1  # scale-down
        assert len(pool.replicas) == 1
        # burn spikes inside the veto window -> revert + tabu
        sig.burn = 5.0
        assert sc.tick() == 1
        assert len(pool.replicas) == 2  # the replica came back
        assert sc.state == "vetoed"
        assert healthz_report()["status"] == "degraded"
        fam = registry().get("sparkdl_autoscale_vetoes_total")
        assert fam.snapshot_values().get('actuator="replica"') == 1.0
        # quiet again: the down direction stays tabu while the
        # blocklist holds — no flap back down
        sig.burn = 0.0
        for _ in range(3):
            sc.tick()
        assert pool.removes == 1  # no second scale-down yet
        assert sc.state == "ok"  # recovered after cooldown
        assert healthz_report()["status"] == "ok"
        # tabu expired -> scale-down allowed again
        for _ in range(6):
            sc.tick()
        assert pool.removes == 2
    finally:
        sc.close()


def test_burn_survived_window_disarms_veto():
    registry().reset()
    pool = _FakePool(2)
    sig = _Sig(depth=0.0, burn=0.0)
    sc = _scaler(pool, hysteresis=2, cooldown=1, veto_window_ticks=2,
                 sig=sig)
    try:
        assert sc.tick() == 0  # down streak 1
        assert sc.tick() == 1  # scale-down arms the veto
        for _ in range(3):
            sc.tick()  # window expires quietly
        assert not sc._pending_vetoes
        # a LATE burn spike does not revert a long-settled move (it is
        # merely the first tick of an up-vote streak)
        sig.burn = 9.0
        assert sc.tick() == 0
        assert pool.adds == 0
        assert sc.state == "ok"
        fam = registry().get("sparkdl_autoscale_vetoes_total")
        assert fam is None or not fam.snapshot_values()
    finally:
        sc.close()


def test_injected_decide_fault_defers_and_recovers():
    registry().reset()
    pool = _FakePool(1)
    sig = _Sig(depth=40.0)
    sc = _scaler(pool, hysteresis=1, sig=sig)
    try:
        with inject("autoscale.decide:RuntimeError@1"):
            assert sc.tick() == 0  # deferred, swallowed
            assert sc.state == "deferred"
            hz = healthz_report()
            assert hz["status"] == "degraded"
            assert hz["autoscalers"][0]["state"] == "deferred"
            # next tick retries and the move lands
            assert sc.tick() == 1
        assert sc.state == "ok"
        assert pool.adds == 1
        fam = registry().get("sparkdl_autoscale_deferred_total")
        assert fam.snapshot_values().get("", 0.0) == 1.0
    finally:
        sc.close()


def test_injected_scale_down_fault_defers_nothing_moves():
    pool = _FakePool(2)
    sig = _Sig(depth=0.0, burn=0.0)
    sc = _scaler(pool, hysteresis=1, sig=sig)
    try:
        with inject("replica.scale_down:OSError@1"):
            assert sc.tick() == 0
            assert sc.state == "deferred"
            assert len(pool.replicas) == 2  # nothing moved
        assert sc.tick() == 1  # retried clean
        assert len(pool.replicas) == 1
        assert sc.state == "ok"
    finally:
        sc.close()


def test_pinned_replicas_converge_and_never_react(monkeypatch):
    monkeypatch.setenv("SPARKDL_TORCH_REPLICAS", "3")
    pool = _FakePool(1)
    sig = _Sig(depth=1000.0, burn=50.0)  # screaming signals
    sc = _scaler(pool, hysteresis=1, cooldown=0, sig=sig)
    try:
        snap = sc.snapshot()["autoscaler"]
        assert snap["pinned"] == 3
        assert snap["pin_source"] == "SPARKDL_TORCH_REPLICAS"
        sc.tick()
        sc.tick()
        assert len(pool.replicas) == 3  # converged to the pin
        # signals can never push past the pin
        for _ in range(5):
            sc.tick()
        assert len(pool.replicas) == 3
        # pin down: converges through the drain-safe remove path
        sc._pin = 2
        sc.tick()
        assert len(pool.replicas) == 2
    finally:
        sc.close()


def test_the_reference_pin_does_not_pin_the_port(monkeypatch):
    monkeypatch.setenv("SPARKDL_TPU_REPLICAS", "3")
    monkeypatch.delenv("SPARKDL_TORCH_REPLICAS", raising=False)
    sc = _scaler(_FakePool(1))
    try:
        assert sc.snapshot()["autoscaler"]["pinned"] is None
    finally:
        sc.close()


def test_explicit_and_env_pin_conflict_raises(monkeypatch):
    monkeypatch.setenv("SPARKDL_TORCH_REPLICAS", "3")
    with pytest.raises(ValueError, match="conflicting pins"):
        AutoScaler(pool=_FakePool(1), replicas=2)


def test_kv_grow_on_deferral_streak_and_shrink_on_quiet():
    kvp = KVBlockPool(32, 4)
    sig = _Sig(depth=0.0, burn=0.0)
    sc = AutoScaler(kv_pool=kvp, kv_lock=threading.Lock(),
                    signals=sig, policy=AutoscalePolicy(
        hysteresis=1, cooldown_ticks=0, kv_step_blocks=4))
    try:
        # quiet + headroom -> shrink one step per tick
        assert sc.tick() == 1
        assert kvp.spare_count == 4
        # exhaustion streak -> grow back (and the episode ends)
        kvp.record_deferral(need=2)
        assert sc.tick() == 1
        assert kvp.spare_count == 0
        assert kvp.deferral_streak == 0
        assert sc.snapshot()["autoscaler"]["kv"]["spare"] == 0
        # burn hot blocks shrink even when free headroom exists
        sig.burn = 0.9
        assert sc.tick() == 0
    finally:
        sc.close()


def test_kv_shrink_arms_veto_and_revert_returns_blocks():
    kvp = KVBlockPool(32, 4)
    sig = _Sig(depth=0.0, burn=0.0)
    sc = AutoScaler(kv_pool=kvp, kv_lock=threading.Lock(),
                    signals=sig, policy=AutoscalePolicy(
        hysteresis=1, cooldown_ticks=1, kv_step_blocks=4,
        veto_burn=2.0, veto_window_ticks=3))
    try:
        assert sc.tick() == 1  # shrink
        assert kvp.spare_count == 4
        sig.burn = 3.0  # burn spike inside the window
        assert sc.tick() == 1  # revert
        assert kvp.spare_count == 0
        assert sc.state == "vetoed"
    finally:
        sc.close()


class _FakeRouter:
    def __init__(self, n=2):
        self._hosts = {f"h{i}": 0 for i in range(n)}
        self.removed = []
        self.added = []

    def hosts(self):
        return list(self._hosts)

    def snapshot(self):
        return {
            "healthy_count": len(self._hosts),
            "hosts": [{"host": h, "outstanding": d, "draining": False}
                      for h, d in self._hosts.items()],
        }

    def remove_host(self, host_id, *, drain=True):
        del self._hosts[host_id]
        self.removed.append(host_id)
        return f"handle-{host_id}"

    def add_host(self, handle):
        host = handle.removeprefix("handle-")
        self._hosts[host] = 0
        self.added.append(handle)
        return host


def test_fleet_scale_down_drains_least_loaded_host():
    router = _FakeRouter(3)
    router._hosts["h1"] = 7  # busiest
    sig = _Sig(depth=0.0, burn=0.0)
    sc = AutoScaler(router=router, signals=sig, policy=AutoscalePolicy(
        hysteresis=1, cooldown_ticks=0, min_hosts=2))
    try:
        assert sc.tick() == 1
        assert router.removed == ["h0"]  # least outstanding drains
        assert sc.spare_hosts == ["handle-h0"]
        # min_hosts floor holds
        for _ in range(5):
            sc.tick()
        assert len(router.hosts()) == 2
    finally:
        sc.close()


def test_replica_tier_shrinks_before_fleet_tier():
    pool = _FakePool(2)
    router = _FakeRouter(2)
    sig = _Sig(depth=0.0, burn=0.0)
    sc = AutoScaler(pool=pool, router=router, signals=sig,
                    policy=AutoscalePolicy(hysteresis=1,
                                           cooldown_ticks=0))
    try:
        assert sc.tick() == 1
        assert pool.removes == 1 and router.removed == []
        # at the replica floor, the fleet tier takes over
        assert sc.tick() == 1
        assert router.removed == ["h0"]
    finally:
        sc.close()


def test_snapshot_shape_and_gauge():
    registry().reset()
    pool = _FakePool(2)
    sc = _scaler(pool, sig=_Sig())
    try:
        a = sc.snapshot()["autoscaler"]
        assert {"state", "replicas", "pinned", "decisions",
                "last_decision", "signals", "kv", "hosts",
                "spare_hosts"} <= set(a)
        assert a["replicas"] == 2
        sc.tick()
        fam = registry().get("sparkdl_autoscale_replicas")
        assert fam.snapshot_values().get("", 0.0) == 2.0
        fam = registry().get("sparkdl_autoscale_ticks_total")
        assert fam.snapshot_values().get("", 0.0) >= 1.0
    finally:
        sc.close()
    fam = registry().get("sparkdl_autoscale_replicas")
    assert fam.snapshot_values().get("", 0.0) == 0.0  # close retracts


def test_started_thread_ticks_and_stops(wait_until):
    """The cadence thread: ``start()`` ticks on its own, ``close()``
    stops it and retracts the healthz provider."""
    pool = _FakePool(1)
    sc = _scaler(pool, hysteresis=1, sig=_Sig(depth=40.0),
                 interval_s=0.005)
    try:
        sc.start()
        assert sc.start() is sc  # idempotent
        wait_until(lambda: pool.adds, desc="a scale-up from the thread")
    finally:
        sc.close()
    assert sc._thread is None
    assert not any(a.get("provider", "").startswith("autoscale-")
                   for a in healthz_report()["autoscalers"])


# -- tick by tick against the JAX package's controller ------------------------

def _packages():
    import sparkdl_tpu.autoscale as jax_autoscale
    import sparkdl_tpu.reliability.faults as jax_faults
    import sparkdl_tpu.serving.kv_blocks as jax_kv

    import sparkdl_torch.autoscale as torch_autoscale
    import sparkdl_torch.serving.kv_blocks as torch_kv

    return [("jax", jax_autoscale, jax_faults, jax_kv.KVBlockPool),
            ("torch", torch_autoscale, faults, torch_kv.KVBlockPool)]


class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def _scenario(name):
    """(policy kwargs, actuator kwargs, per-tick script). A
    script step is ``(depth, burn, action)``; ``action`` (or None)
    mutates the actuators before the tick."""
    quiet, busy = (0.0, 0.0), (40.0, 0.0)

    def deferral(need):
        return lambda act: act["kv_pool"].record_deferral(need=need)

    if name == "hysteresis":
        return (dict(hysteresis=3, cooldown_ticks=2),
                dict(pool=1), [(*busy, None)] * 8)
    if name == "alternating":
        return (dict(hysteresis=2), dict(pool=2),
                [(*(busy if i % 2 == 0 else quiet), None)
                 for i in range(12)])
    if name == "cooldown":
        return (dict(hysteresis=1, cooldown_ticks=3), dict(pool=1),
                [(*busy, None)] * 9)
    if name == "veto_tabu":
        return (dict(hysteresis=1, cooldown_ticks=2, veto_burn=2.0,
                     tabu_ticks=4, veto_window_ticks=3),
                dict(pool=2),
                [(*quiet, None), (0.0, 5.0, None)]
                + [(*quiet, None)] * 10)
    if name == "kv_grow_shrink":
        return (dict(hysteresis=1, cooldown_ticks=0, kv_step_blocks=4),
                dict(kv=32),
                [(*quiet, None), (*quiet, None), (*quiet, deferral(2)),
                 (0.0, 0.9, None), (*quiet, None), (*quiet, deferral(9)),
                 (*quiet, None), (*quiet, None), (*quiet, None)])
    if name == "kv_veto":
        return (dict(hysteresis=1, cooldown_ticks=1, kv_step_blocks=4,
                     veto_burn=2.0, veto_window_ticks=3),
                dict(kv=32),
                [(*quiet, None), (0.0, 3.0, None)] + [(*quiet, None)] * 6)
    if name == "pin":
        return (dict(hysteresis=1, cooldown_ticks=0), dict(pool=1, pin=3),
                [(1000.0, 50.0, None)] * 6)
    if name == "fleet_down_rejoin":
        return (dict(hysteresis=1, cooldown_ticks=0, tabu_ticks=2,
                     queue_high=2.0, queue_low=0.5, min_hosts=1),
                dict(router=3),
                [(*quiet, None)] * 3 + [(8.0, 0.0, None)] * 4
                + [(*quiet, None), (0.0, 1.5, None)] + [(*quiet, None)] * 3)
    if name == "replica_then_fleet":
        return (dict(hysteresis=1, cooldown_ticks=0), dict(pool=2, router=2),
                [(*quiet, None)] * 4 + [(40.0, 0.0, None)] * 3)
    raise KeyError(name)


SCENARIOS = ["hysteresis", "alternating", "cooldown", "veto_tabu",
             "kv_grow_shrink", "kv_veto", "pin", "fleet_down_rejoin",
             "replica_then_fleet"]


def _run_scenario(name, mod, faults_mod, pool_cls, fault_plan=None):
    policy_kw, act_kw, script = _scenario(name)
    act = {}
    kw = {}
    if "pool" in act_kw:
        act["pool"] = kw["pool"] = _FakePool(
            act_kw["pool"], site=faults_mod.fault_point)
    if "kv" in act_kw:
        act["kv_pool"] = kw["kv_pool"] = pool_cls(act_kw["kv"], 4)
        kw["kv_lock"] = threading.Lock()
    if "router" in act_kw:
        act["router"] = kw["router"] = _FakeRouter(act_kw["router"])
    if "pin" in act_kw:
        kw["replicas"] = act_kw["pin"]
    sig, clock = _Sig(), _Clock()
    sc = mod.AutoScaler(policy=mod.AutoscalePolicy(**policy_kw),
                        signals=sig, clock=clock, **kw)
    record = sc._record
    moves: list = []

    def logged(actuator, direction, **detail):
        moves.append((actuator, direction))
        record(actuator, direction, **detail)

    sc._record = logged
    ticks = []
    faults_mod.disarm()
    try:
        if fault_plan:
            faults_mod.arm(fault_plan)
        for depth, burn, action in script:
            if action is not None:
                action(act)
            sig.depth, sig.burn = depth, burn
            clock.t += 0.25
            moves.clear()
            n = sc.tick()
            ticks.append((n, tuple(moves), sc.state,
                          len(sc.spare_hosts)))
        snap = sc.snapshot()["autoscaler"]
        end = {k: snap[k] for k in ("state", "replicas", "pinned",
                                    "decisions", "tabu", "hosts",
                                    "spare_hosts", "pending_vetoes")}
        if snap["kv"] is not None:
            end["kv"] = {k: snap["kv"][k] for k in ("serving", "spare",
                                                     "free", "need_peak")}
    finally:
        faults_mod.disarm()
        sc.close()
    return ticks, end


@pytest.mark.parametrize("name", SCENARIOS)
def test_decisions_equal_the_references_every_tick(name):
    (_, jmod, jfaults, jpool), (_, tmod, tfaults, tpool) = _packages()
    want = _run_scenario(name, jmod, jfaults, jpool)
    got = _run_scenario(name, tmod, tfaults, tpool)
    assert got == want
    # each scenario moves something at least once (or, alternating,
    # proves it never flaps)
    moved = [t for t in got[0] if t[1]]
    assert bool(moved) == (name != "alternating"), got[0]


@pytest.mark.parametrize("plan", [
    "autoscale.decide:RuntimeError@2",
    "replica.scale_down:OSError@1",
    "kv_pool.resize:OSError@2",
], ids=["decide", "scale_down", "kv_resize"])
def test_deferred_ticks_equal_the_references(plan):
    """The same counted fault plan in both packages defers the same
    tick, moves nothing on it, and recovers on the same tick."""
    name = {"autoscale": "replica_then_fleet", "replica": "veto_tabu",
            "kv_pool": "kv_grow_shrink"}[plan.split(".")[0]]
    (_, jmod, jfaults, jpool), (_, tmod, tfaults, tpool) = _packages()
    want = _run_scenario(name, jmod, jfaults, jpool, fault_plan=plan)
    got = _run_scenario(name, tmod, tfaults, tpool, fault_plan=plan)
    assert got == want
    states = [t[2] for t in got[0]]
    assert states.count("deferred") == 1, states
    i = states.index("deferred")
    assert got[0][i][:2] == (0, ())  # the deferred tick moved nothing
    assert states[i + 1] != "deferred"
