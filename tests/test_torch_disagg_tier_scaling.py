"""Per-tier autoscaling on the port: each tier scales on its own
pressure signal, and the fabric tier scales BOTH ways — a drained host
parked on ``AutoScaler.spare_hosts`` rejoins via ``reopen`` +
``Router.add_host`` on a sustained up-vote or a veto revert. The tier
signal readers are held to the JAX package's on the same stub
PhaseRouter state, and the live-engine tests run the tiny GPT with the
reference's weights (``gpt_flax_to_torch``).
"""

from concurrent.futures import Future

import pytest

from sparkdl_torch.autoscale.controller import AutoscalePolicy, AutoScaler
from sparkdl_torch.disagg import (
    PhaseRouter,
    PrefillWorker,
    decode_tier_signals,
    prefill_tier_signals,
    tier_autoscalers,
)
from sparkdl_torch.fabric import HostHandle
from sparkdl_torch.fabric.host import InProcessHost
from sparkdl_torch.observability.registry import registry


@pytest.fixture(scope="module")
def bundle():
    from torch_parity import gpt_pair

    _, _, module = gpt_pair(0)
    return module.config, module


def _kw(**over):
    kw = dict(n_slots=2, max_len=40, auto_start=False,
              kv_block_size=4, prefill_chunk=8)
    kw.update(over)
    return kw


def _stub_host_class(base):
    class StubHost(base):
        """Capacity/health a test mutates; tracks drain/reopen calls."""

        def __init__(self, host_id, *, free_slots=2, n_slots=2,
                     queue_depth=0):
            self.host_id = host_id
            self.free_slots = free_slots
            self.n_slots = n_slots
            self.queue_depth = queue_depth
            self.status = "ok"
            self.reopened = 0
            self.drained = 0

        def submit(self, payload, *, timeout_s=None):
            fut = Future()
            fut.set_result(self.host_id)
            return fut

        def capacity(self):
            return {"host_id": self.host_id, "replica_count": 1,
                    "n_slots": self.n_slots,
                    "free_slots": self.free_slots,
                    "kv_blocks_free": 8, "kv_blocks_total": 8,
                    "queue_depth": self.queue_depth,
                    "max_queue_depth": 16, "draining": False}

        def health(self):
            return {"status": self.status, "host_id": self.host_id}

        def snapshot(self):
            return {"host_id": self.host_id, "capacity": self.capacity()}

        def prefix_digest(self, max_entries=1024):
            return None

        def drain(self):
            self.drained += 1
            return []

        def reopen(self):
            self.reopened += 1

        def close(self, *, timeout_s=30.0):
            pass

    return StubHost


StubHost = _stub_host_class(HostHandle)


def _stub_phase_router(n_prefill=1, n_decode=2, *, host=StubHost,
                       router=PhaseRouter):
    pre = [host(f"p{i}") for i in range(n_prefill)]
    dec = [host(f"d{i}") for i in range(n_decode)]
    return router(pre, dec, auto_refresh=False), pre, dec


def _policy(**over):
    kw = dict(hysteresis=1, cooldown_ticks=0, tabu_ticks=2,
              queue_high=2.0, queue_low=0.5)
    kw.update(over)
    return AutoscalePolicy(**kw)


# -- signal readers ------------------------------------------------------------

def test_prefill_signal_is_the_tier_queue_depth(bundle):
    """Live engines: queued-but-unstarted prompts ARE prefill
    pressure; the burn channel stays quiet (the latency objective
    lives on the decode tier)."""
    cfg, module = bundle
    pre = PrefillWorker(cfg, module, **_kw(n_slots=1))
    pr = PhaseRouter([InProcessHost(pre, host_id="p0")],
                     [StubHost("d0")], auto_refresh=False)
    read = prefill_tier_signals(pr)
    try:
        assert read() == (0.0, 0.0)
        futs = [pre.submit([1, 2, 3], 2) for _ in range(3)]
        depth, burn = read()
        assert depth == 3.0 and burn == 0.0
        while not all(f.done() for f in futs):
            pre.tick()
        assert read() == (0.0, 0.0)
    finally:
        pr.close()
        pre.close()


def test_decode_signal_counts_occupancy_plus_queued_handoffs():
    spr, _, dec = _stub_phase_router(n_decode=2)
    read = decode_tier_signals(spr)
    try:
        assert read() == (0.0, 0.0)
        dec[0].free_slots = 0      # 2 slots camped on
        dec[1].queue_depth = 3     # 3 handoffs waiting
        pressure, burn = read()
        assert pressure == 5.0 and burn == 0.0
    finally:
        spr.close()


def test_decode_burn_saturates_on_kv_exhaustion_health():
    """A degraded host (what a KV deferral streak sets) maps to
    burn=1.0 — block starvation scales the tier up even while slots
    look free."""
    spr, _, dec = _stub_phase_router(n_decode=2)
    read = decode_tier_signals(spr)
    try:
        dec[1].status = "degraded"
        pressure, burn = read()
        assert pressure == 0.0 and burn == 1.0
        dec[1].status = "ok"
        assert read() == (0.0, 0.0)
    finally:
        spr.close()


# the reference's state mutations, replayed on both packages' stubs
_STATES = {
    "idle": [],
    "camped_and_queued": [("d", 0, "free_slots", 0), ("d", 1, "queue_depth", 3)],
    "degraded": [("d", 1, "status", "degraded")],
    "prefill_backlog": [("p", 0, "queue_depth", 5), ("p", 1, "queue_depth", 2)],
    "everything": [("p", 0, "queue_depth", 4), ("d", 0, "free_slots", 1),
                   ("d", 1, "queue_depth", 2), ("d", 0, "status", "degraded")],
}


class _Raising:
    """A host handle whose capacity poll fails: the readers skip it."""

    def __init__(self, base):
        self.base = base

    def __getattr__(self, name):
        return getattr(self.base, name)

    def capacity(self):
        raise OSError("host unreachable")


@pytest.mark.parametrize("state", sorted(_STATES) + ["unreachable"])
def test_tier_signals_equal_the_references(state):
    from sparkdl_tpu.disagg import PhaseRouter as JaxPhaseRouter
    from sparkdl_tpu.disagg import decode_tier_signals as jax_decode
    from sparkdl_tpu.disagg import prefill_tier_signals as jax_prefill
    from sparkdl_tpu.fabric import HostHandle as JaxHostHandle
    from sparkdl_tpu.observability.registry import registry as jax_registry

    out = []
    for host, router, pre_sig, dec_sig, reg in (
            (_stub_host_class(JaxHostHandle), JaxPhaseRouter, jax_prefill,
             jax_decode, jax_registry),
            (StubHost, PhaseRouter, prefill_tier_signals,
             decode_tier_signals, registry)):
        spr, pre, dec = _stub_phase_router(2, 2, host=host, router=router)
        try:
            for tier, i, attr, value in _STATES.get(state, _STATES["everything"]):
                setattr((pre if tier == "p" else dec)[i], attr, value)
            if state == "unreachable":
                for r in (spr.prefill, spr.decode):
                    hs = r.host_handles()
                    r.host_handles = lambda hs=hs: [_Raising(hs[0]), *hs[1:]]
            got = (pre_sig(spr)(), dec_sig(spr)())
            depth = reg().get("sparkdl_disagg_tier_depth").snapshot_values()
            out.append((got, {k: depth[k] for k in sorted(depth)}))
        finally:
            spr.close()
    assert out[1] == out[0]


# -- fabric-tier scale-down / scale-up ----------------------------------------

def test_scale_down_parks_then_pressure_rejoins_the_spare_host():
    """The full round trip on one tier: quiet signals drain + park a
    host as spare capacity; sustained pressure re-opens it and rejoins
    via Router.add_host — the scaler grows the tier again, not just
    shrinks it."""
    spr, pre_hosts, _ = _stub_phase_router(n_prefill=2)
    depth = [0.0]
    scaler = AutoScaler(router=spr.prefill, policy=_policy(),
                        signals=lambda: (depth[0], 0.0))
    try:
        assert scaler.tick() == 1  # quiet -> park one host
        assert len(spr.prefill.hosts()) == 1
        assert len(scaler.spare_hosts) == 1
        parked = scaler.spare_hosts[0]
        assert parked.drained == 1
        scaler.tick()  # still quiet, but min_hosts floors the tier
        assert len(scaler.spare_hosts) == 1
        depth[0] = 8.0  # a burst: 8 queued vs queue_high=2
        assert scaler.tick() == 1  # up-vote -> reopen + add_host
        assert len(spr.prefill.hosts()) == 2
        assert not scaler.spare_hosts
        assert parked.reopened == 1
        # the rejoined host routes again
        spr.prefill.refresh()
        assert parked.host_id in spr.prefill.hosts()
    finally:
        scaler.close()
        spr.close()


def test_rejoined_live_host_serves_requests_again(bundle):
    """Engine-backed round trip: park a real InProcessHost, rejoin it,
    and verify it actually SERVES — reopen restarts the drained
    engine's queue before add_host exposes it to placement."""
    cfg, module = bundle
    engines = [PrefillWorker(cfg, module, host_id=f"p{i}",
                             **_kw(auto_start=True)) for i in range(2)]
    hosts = [InProcessHost(e, host_id=e.host_id) for e in engines]
    pr = PhaseRouter(hosts, [StubHost("d0")], auto_refresh=False)
    depth = [0.0]
    scaler = AutoScaler(router=pr.prefill, policy=_policy(),
                        signals=lambda: (depth[0], 0.0))
    try:
        assert scaler.tick() == 1
        (parked,) = scaler.spare_hosts
        assert parked.draining
        depth[0] = 8.0
        assert scaler.tick() == 1
        assert not parked.draining  # reopen reversed the drain
        assert len(pr.prefill.hosts()) == 2
        # the tier still prefills end to end through both hosts
        futs = [pr.prefill.submit(
            {"prompt": [1, 2, 3, i], "max_new_tokens": 2})
            for i in range(4)]
        handoffs = [f.result(timeout=30) for f in futs]
        assert all(h.n_blocks >= 1 for h in handoffs)
    finally:
        scaler.close()
        pr.close()
        for e in engines:
            e.close()


def test_veto_revert_rejoins_the_parked_decode_host():
    """A scale-down whose veto window sees SLO burn (here: KV
    exhaustion flipping a survivor to degraded) REVERTS — the parked
    handle comes back instead of the tier limping until an operator
    notices."""
    spr, _, dec = _stub_phase_router(n_decode=2)
    scaler = AutoScaler(router=spr.decode,
                        policy=_policy(veto_window_ticks=3),
                        signals=decode_tier_signals(spr))
    try:
        assert scaler.tick() == 1  # quiet -> park one decode host
        assert len(scaler.spare_hosts) == 1
        parked = scaler.spare_hosts[0]
        survivor = dec[0] if dec[1] is parked else dec[1]
        survivor.status = "degraded"  # exhaustion inside the window
        assert scaler.tick() >= 1  # veto fires -> revert rejoins
        assert not scaler.spare_hosts
        assert parked.reopened == 1
        assert len(spr.decode.hosts()) == 2
        snap = scaler.snapshot()["autoscaler"]
        assert snap["hosts"] == 2 and snap["spare_hosts"] == 0
    finally:
        scaler.close()
        spr.close()


def test_min_hosts_floors_the_tier():
    spr, _, _ = _stub_phase_router(n_prefill=1)
    scaler = AutoScaler(router=spr.prefill,
                        policy=_policy(min_hosts=1),
                        signals=lambda: (0.0, 0.0))
    try:
        for _ in range(4):
            scaler.tick()
        assert len(spr.prefill.hosts()) == 1
        assert not scaler.spare_hosts
    finally:
        scaler.close()
        spr.close()


def test_tier_autoscalers_binds_one_scaler_per_tier():
    spr, _, dec = _stub_phase_router(n_prefill=1, n_decode=2)
    pre_s, dec_s = tier_autoscalers(
        spr, prefill_policy=_policy(), decode_policy=_policy())
    try:
        assert pre_s.router is spr.prefill
        assert dec_s.router is spr.decode
        # each scaler reads ITS tier: decode pressure is invisible to
        # the prefill scaler's signal channel
        dec[0].free_slots = 0
        dec[0].queue_depth = 4
        assert pre_s._signals()[0] == 0.0
        assert dec_s._signals()[0] >= 6.0
    finally:
        pre_s.close()
        dec_s.close()
        spr.close()


def test_tier_autoscalers_decide_as_the_references_do():
    """Both packages' tier scalers over stub tiers, driven through the
    same quiet -> burst -> quiet script: the same moves on every tick."""
    from sparkdl_tpu.autoscale import AutoscalePolicy as JaxPolicy
    from sparkdl_tpu.disagg import PhaseRouter as JaxPhaseRouter
    from sparkdl_tpu.disagg import tier_autoscalers as jax_tiers
    from sparkdl_tpu.fabric import HostHandle as JaxHostHandle

    script = [{}] * 2 + [{"p0": 6, "d0": 3}] * 3 + [{}] * 3
    runs = []
    for host, router, tiers, policy in (
            (_stub_host_class(JaxHostHandle), JaxPhaseRouter, jax_tiers,
             JaxPolicy),
            (StubHost, PhaseRouter, tier_autoscalers, AutoscalePolicy)):
        spr, pre, dec = _stub_phase_router(2, 2, host=host, router=router)
        kw = dict(hysteresis=1, cooldown_ticks=0, tabu_ticks=2,
                  queue_high=2.0, queue_low=0.5)
        scalers = tiers(spr, prefill_policy=policy(**kw),
                        decode_policy=policy(**kw))
        ticks = []
        try:
            for step in script:
                for h in pre + dec:
                    h.queue_depth = step.get(h.host_id, 0)
                ticks.append(tuple(
                    (s.tick(), s.state, sorted(s.router.hosts()),
                     len(s.spare_hosts)) for s in scalers))
        finally:
            for s in scalers:
                s.close()
            spr.close()
        runs.append(ticks)
    assert runs[1] == runs[0]
    assert any(t[0][0] for t in runs[1]) and any(t[1][0] for t in runs[1])
