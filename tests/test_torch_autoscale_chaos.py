"""Chaos scale soak on the port: load + repeated autoscaler-driven
scale-up/scale-down + a COUNTED fault plan hitting the scale machinery
itself (``replica.scale_down``, ``autoscale.decide``,
``kv_pool.resize``) and the dispatch path.

The reference's soak draws its dispatch faults with a seeded
probability; under load that changes which call is hit from run to run.
Here every rule is counted (``site@N``), so each fires exactly once and
the test asserts the exact counts: every accepted request RESOLVES with
its row (zero lost), the engine's counters reconcile exactly with the
client's, every scale decision is visible in the flight recorder, and
/healthz reports the autoscaler state (degraded during a deferred scale
event, ok after recovery). The same plan against the JAX package's
soak fires the same rules the same number of times.
"""

import threading
import time

import numpy as np
import pytest
import torch

from sparkdl_torch.autoscale import AutoScaler, AutoscalePolicy
from sparkdl_torch.observability import flight
from sparkdl_torch.observability.flight import healthz_report
from sparkdl_torch.observability.registry import registry
from sparkdl_torch.reliability import faults
from sparkdl_torch.reliability.faults import inject
from sparkdl_torch.serving import ReplicaPool, ServingEngine
from sparkdl_torch.serving.kv_blocks import KVBlockPool

DIM = 6
_W = np.random.default_rng(17).standard_normal((DIM, DIM)).astype(np.float32)
_TW = torch.as_tensor(_W)
N_REQUESTS = 360
POOL_TOL = 1e-6  # float32 tanh(x @ W): torch and XLA may round the sums apart

#: two dispatch faults (each re-routed, no rider sees it), the second
#: scale-down aborted mid-decision, the fifth decision pass deferred,
#: the third KV resize refused. 360 requests make at least 45 batches.
PLAN = ("dispatch:RuntimeError@11;dispatch:RuntimeError@29;"
        "replica.scale_down:OSError@2;autoscale.decide:RuntimeError@5;"
        "kv_pool.resize:OSError@3")
SITES = {"dispatch": 2, "replica.scale_down": 1, "autoscale.decide": 1,
         "kv_pool.resize": 1}


def _apply(b):
    return torch.tanh(b["x"] @ _TW)


def _soak(pkg):
    """Run the soak against one package's serving stack; return what the
    test asserts on."""
    if pkg == "torch":
        fl, hz, reg, flts = flight, healthz_report, registry, faults
        Scaler, Policy, Pool, Engine, KV = (AutoScaler, AutoscalePolicy,
                                            ReplicaPool, ServingEngine,
                                            KVBlockPool)
        pool = Pool(_apply, batch_size=8, n_replicas=1,
                    devices=[torch.device("cpu")], max_failures=3,
                    probation_s=0.1, probation_max_s=2.0)
        arm = inject
    else:
        import jax.numpy as jnp

        from sparkdl_tpu.autoscale import AutoScaler as Scaler
        from sparkdl_tpu.autoscale import AutoscalePolicy as Policy
        from sparkdl_tpu.observability import flight as fl
        from sparkdl_tpu.observability.flight import healthz_report as hz
        from sparkdl_tpu.observability.registry import registry as reg
        from sparkdl_tpu.reliability import faults as flts
        from sparkdl_tpu.serving import ReplicaPool as Pool
        from sparkdl_tpu.serving import ServingEngine as Engine
        from sparkdl_tpu.serving.kv_blocks import KVBlockPool as KV

        jw = jnp.asarray(_W)
        pool = Pool(lambda b: jnp.tanh(b["x"] @ jw), batch_size=8,
                    n_replicas=1, max_failures=3, probation_s=0.1,
                    probation_max_s=2.0)
        arm = flts.inject
    reg().reset()
    flts.disarm()
    expected = {v: np.tanh(np.full((DIM,), float(v), np.float32) @ _W)
                for v in range(23)}
    warm = {"x": np.zeros((8, DIM), np.float32)}
    pool.warmup(warm)
    engine = Engine(pool, max_queue_depth=8192, max_wait_s=0.002)
    kv = KV(64, 4)
    burn_now = [0.0]
    scaler = Scaler(
        pool=pool, kv_pool=kv, kv_lock=threading.Lock(),
        signals=lambda: (float(engine.queue.depth), burn_now[0]),
        policy=Policy(min_replicas=1, max_replicas=3, queue_high=4.0,
                      queue_low=0.5, hysteresis=1, cooldown_ticks=1,
                      veto_window_ticks=3, veto_burn=2.0, tabu_ticks=3,
                      kv_step_blocks=8),
        # no warmup dispatches on an added replica: a counted dispatch
        # rule must land on a live (re-routable) batch, never on a
        # warmup, whose failure surfaces by design
        warmup_arrays=None)
    states_seen = set()
    deferred_healthz = []
    futs = []
    with arm(PLAN):
        try:
            for i in range(N_REQUESTS):
                futs.append(engine.submit(
                    {"x": np.full((DIM,), float(i % 23), np.float32)}))
                if i % 6 == 5:
                    scaler.tick()
                    states_seen.add(scaler.state)
                    if scaler.state == "deferred":
                        deferred_healthz.append(hz()["status"])
                if i % 60 == 59:
                    # load valleys: enough quiet ticks that the
                    # controller sees BOTH directions (the kv tier
                    # shrinks first; the replica tier follows)
                    for _ in range(30):
                        scaler.tick()
                        states_seen.add(scaler.state)
                        if scaler.state == "deferred":
                            deferred_healthz.append(hz()["status"])
                        if engine.queue.depth:
                            time.sleep(0.005)
                if i == 200:
                    burn_now[0] = 5.0  # burn spike: veto window watch
                if i == 220:
                    burn_now[0] = 0.0
            n_ok = n_err = worst = 0
            for i, f in enumerate(futs):
                try:
                    out = f.result(timeout=60)
                except Exception:
                    n_err += 1
                else:
                    worst = max(worst, float(np.abs(
                        np.asarray(out) - expected[i % 23]).max()))
                    n_ok += 1
            # settle: keep ticking until the controller reads ok
            deadline = time.monotonic() + 10.0
            while scaler.state != "ok" and time.monotonic() < deadline:
                scaler.tick()
                time.sleep(0.01)
            snap = engine.snapshot()
        finally:
            engine.close(drain=True)
            scaler.close()
            pool.close()
    inj = reg().get("sparkdl_faults_injected_total")
    injected = {k.split('"')[1]: v
                for k, v in inj.snapshot_values().items()}
    kinds = [str(e.get("kind")) for e in fl.flight_recorder().events()]
    dec = reg().get("sparkdl_autoscale_decisions_total")
    deferred = reg().get("sparkdl_autoscale_deferred_total")
    return {"ok": n_ok, "err": n_err, "worst": worst, "snap": snap,
            "injected": injected, "kinds": kinds,
            "decisions": sum(dec.snapshot_values().values()),
            "deferred": deferred.snapshot_values().get("", 0.0),
            "states": states_seen, "deferred_healthz": deferred_healthz,
            "healthz": hz()["status"]}


@pytest.mark.parametrize("pkg", ["torch", "jax"])
def test_chaos_scale_soak_zero_lost_and_observable(pkg):
    run = _soak(pkg)
    # every accepted request resolved, with its row: the counted faults
    # are all absorbed (re-route, deferred decisions) — none surfaces
    assert (run["ok"], run["err"]) == (N_REQUESTS, 0)
    assert run["worst"] <= POOL_TOL
    # counters reconcile exactly with the client's counts
    assert run["snap"]["completed"] == run["ok"]
    assert run["snap"]["failed"] == run["err"]
    # each counted rule fired exactly once
    assert run["injected"] == SITES, run["injected"]
    # the soak actually scaled: up AND down decisions in the flight ring
    assert "pool.scale_up" in run["kinds"], "no scale-up happened"
    assert "pool.scale_down" in run["kinds"], "no drain-based scale-down"
    assert "autoscale.decision" in run["kinds"]
    # the injected faults deferred (visible + degraded healthz): the
    # decide and scale-down faults always; the KV resize fault too,
    # unless it hit a veto's revert, which logs it and moves on
    assert run["deferred"] in (2.0, 3.0), run["deferred"]
    assert "autoscale.deferred" in run["kinds"]
    assert "deferred" in run["states"]
    assert run["deferred_healthz"] and all(
        s == "degraded" for s in run["deferred_healthz"])
    # recovered at the end
    assert run["healthz"] == "ok"
    assert run["decisions"] >= 2
