"""Chaos: a killed HOST (not just a killed replica) under open-loop
load. The fabric's end-to-end contract: every request the router
accepted resolves (a result or a typed error — nothing hangs, nothing
is silently lost), the killed host quarantines and rejoins through
probation once revived, a concurrent graceful drain transfers its
unstarted requests to survivors, and the router's postmortem bundle
captures the whole failover sequence (injected faults, drain,
re-routes, quarantine).
"""

import threading
import time

import numpy as np
import pytest
import torch


from sparkdl_torch.fabric import InProcessHost, Router
from sparkdl_torch.observability import flight
from sparkdl_torch.observability.registry import registry
from sparkdl_torch.reliability import faults
from sparkdl_torch.reliability.faults import inject
from sparkdl_torch.serving import ServingEngine
from sparkdl_torch.transformers._inference import BatchedRunner

DIM = 6
_W = torch.from_numpy(
    np.random.default_rng(7).standard_normal((DIM, DIM)).astype(np.float32))


def _apply(b):
    return torch.tanh(b["x"] @ _W)


class _SlowRunner:
    """A runner with a per-dispatch floor so queues actually build
    (otherwise drains never find an unstarted request to transfer)."""

    def __init__(self, inner, floor_s=0.003):
        self._inner = inner
        self._floor_s = floor_s
        self.chunk_size = inner.chunk_size

    def run_batch(self, arrays):
        time.sleep(self._floor_s)
        return self._inner.run_batch(arrays)


class RevivableHost(InProcessHost):
    """An in-process host whose engine can be hard-killed (close with
    no drain: in-flight and queued futures fail with the typed
    EngineClosedError — the same verdict a dropped TCP connection gives
    an HTTP handle) and later revived as a fresh engine, the way a
    restarted host process rejoins the fleet."""

    def __init__(self, make_engine, host_id):
        self._make_engine = make_engine
        super().__init__(make_engine(host_id), host_id=host_id)

    def kill(self):
        self.engine.close(drain=False, timeout_s=5)

    def revive(self):
        self.engine = self._make_engine(self.host_id)


def _make_engine(host_id, floor_s=0.003):
    return ServingEngine(
        _SlowRunner(BatchedRunner(_apply, batch_size=8, device="cpu"),
                    floor_s=floor_s),
        max_queue_depth=8192, max_wait_s=0.002, host_id=host_id)


@pytest.fixture(autouse=True)
def _fast_postmortems():
    rec = flight.flight_recorder()
    prev = (rec.settle_s, rec.min_interval_s)
    rec.configure(settle_s=0.01, min_interval_s=0.0)
    yield
    rec.configure(settle_s=prev[0], min_interval_s=prev[1])


def _expected():
    oracle = BatchedRunner(_apply, batch_size=8, device="cpu")
    return {
        v: np.asarray(oracle.run_batch(
            {"x": np.full((1, DIM), float(v), np.float32)})[0])
        for v in range(31)
    }


def test_host_kill_fast_drill(wait_until):
    """The fast lane's host-kill contract: kill one of two hosts under
    load — zero lost accepted requests, the dead host quarantines with
    a postmortem, and new traffic flows on the survivor."""
    registry().reset()
    faults.disarm()
    expected = _expected()
    hosts = [RevivableHost(_make_engine, "kill-a"),
             RevivableHost(_make_engine, "kill-b")]
    futs = []
    with Router(hosts, max_failures=3, probation_s=0.2,
                auto_refresh=False) as router:
        try:
            for i in range(60):
                futs.append((i, router.submit(
                    {"x": np.full((DIM,), float(i % 31), np.float32)})))
                if i == 25:
                    hosts[0].kill()
            n_ok = 0
            for i, f in futs:
                out = f.result(timeout=30)  # zero lost: all resolve OK
                np.testing.assert_allclose(out, expected[i % 31],
                                           rtol=1e-5)
                n_ok += 1
            assert n_ok == 60
            assert router._hosts["kill-a"].quarantined

            def _bundle_has_failover():
                b = flight.flight_recorder().last_bundle
                if b is None:
                    return False
                kinds = [e.get("kind") for e in b["events"]]
                return ("fabric.host_quarantined" in kinds
                        and "fabric.failover" in kinds)

            wait_until(_bundle_has_failover, timeout_s=5.0)
        finally:
            for h in hosts:
                h.engine.close(drain=False, timeout_s=5)
