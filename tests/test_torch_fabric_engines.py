"""Fabric over REAL engines: affinity wins on shared-prefix traffic,
stale digests degrade to load routing (never a wrong answer), drain
transfers live requests queue-to-queue, and the engine snapshot carries
the router's weighting inputs.
"""

import time

import numpy as np
import pytest

from sparkdl_torch.fabric import InProcessHost, Router
import torch

from sparkdl_torch.models.gpt import generate
from sparkdl_torch.observability.registry import registry
from sparkdl_torch.serving import ContinuousGPTEngine

MAX_LEN = 32
BS = 4


@pytest.fixture(scope="module")
def bundle():
    from torch_parity import gpt_pair

    _, _, module = gpt_pair(0)
    return module.config, module


def _oracle(module, prompt, max_new):
    # the port's generate: held to the JAX package's in test_torch_gpt
    out = generate(module, torch.as_tensor([prompt]), max_new)
    return out[0, len(prompt):].numpy()


def _engine(cfg, module, host_id, **kw):
    kw.setdefault("n_slots", 2)
    kw.setdefault("max_len", MAX_LEN)
    kw.setdefault("kv_block_size", BS)
    kw.setdefault("idle_wait_s", 0.001)
    return ContinuousGPTEngine(cfg, module, host_id=host_id, **kw)


def _payload(prompt, max_new=3):
    return {"prompt": list(prompt), "max_new_tokens": max_new}


def _hit_rate(engines):
    hits = miss = 0
    for e in engines:
        kv = e.snapshot()["kv"]
        hits += kv["prefix_hits"]
        miss += kv["prefix_misses"]
    return hits / max(1, hits + miss)


# Two groups of prompts sharing an 8-token (2-block) prefix each; the
# follower requests are where affinity pays
_GROUPS = [
    [1, 7, 3, 9, 2, 8, 4, 6],
    [5, 5, 2, 2, 7, 7, 1, 1],
]


def _workload():
    """(seed prompts, follower prompts): followers extend their group's
    shared prefix with distinct tails."""
    seeds = [g + [10 + i] for i, g in enumerate(_GROUPS)]
    # grouped by group, NOT interleaved: an interleaved order would let
    # round-robin land every follower on its seed's host by accident
    # (2 groups, 2 hosts, alternating placements)
    followers = [g + [20 + i, j] for i, g in enumerate(_GROUPS)
                 for j in range(3)]
    return seeds, followers


def _run_fleet(cfg, module, policy, tag):
    engines = [_engine(cfg, module, f"{tag}-{i}") for i in range(2)]
    hosts = [InProcessHost(e) for e in engines]
    seeds, followers = _workload()
    with Router(hosts, policy=policy, auto_refresh=False) as router:
        for p in seeds:
            router.submit(_payload(p)).result(30)
        router.refresh()  # publish the freshly seeded digests
        futs = [router.submit(_payload(p)) for p in followers]
        toks = [f.result(30) for f in futs]
    rate = _hit_rate(engines)
    for e in engines:
        e.close()
    return rate, toks


def test_affinity_beats_round_robin_on_shared_prefixes(bundle):
    """The headline contract: cache-aware routing lands shared-prefix
    requests where their blocks live, so the fleet-wide prefix hit rate
    beats blind round-robin on the identical workload — and tokens are
    oracle-exact under both policies (routing is placement, never
    approximation)."""
    cfg, module = bundle
    rr_rate, rr_toks = _run_fleet(cfg, module, "round_robin", "rr")
    af_rate, af_toks = _run_fleet(cfg, module, "affinity", "af")
    assert af_rate > rr_rate, (af_rate, rr_rate)
    assert af_rate > 0.3
    _, followers = _workload()
    for p, got_af, got_rr in zip(followers, af_toks, rr_toks):
        want = _oracle(module, p, 3)
        np.testing.assert_array_equal(got_af, want)
        np.testing.assert_array_equal(got_rr, want)


def test_stale_digest_degrades_to_load_routing(bundle):
    """A digest whose blocks were since evicted costs one cold prefill
    on the 'wrong' host — exactly what a digest-less router pays —
    never a failure or a wrong token."""
    cfg, module = bundle
    # a tiny pool: unrelated traffic evicts the seeded prefix
    warm = _engine(cfg, module, "stale-warm", kv_blocks=16)
    cold = _engine(cfg, module, "stale-cold", kv_blocks=16)
    hosts = [InProcessHost(warm), InProcessHost(cold)]
    shared = _GROUPS[0]
    with Router(hosts, auto_refresh=False) as router:
        with router._lock:  # pin the seed onto `warm`
            router._hosts["stale-cold"].outstanding += 10
        router.submit(_payload(shared + [11])).result(30)
        with router._lock:
            router._hosts["stale-cold"].outstanding -= 10
        router.refresh()
        assert router._hosts["stale-warm"].digest.hashes
        # evict warm's cache from under the published digest
        for j in range(6):
            p = [30 + j] * 10 + [j]
            warm.submit(p, 2).result(30)
        warm_kv = warm.snapshot()["kv"]
        assert warm_kv["prefix_evictions"] > 0
        # the shared-prefix request still routes to warm (stale digest
        # says the blocks are there) and must simply prefill cold
        fut = router.submit(_payload(shared + [12]))
        got = fut.result(30)
    np.testing.assert_array_equal(
        got, _oracle(module, shared + [12], 3))
    for e in (warm, cold):
        e.close()


def test_drain_transfers_unstarted_requests(bundle):
    """Graceful drain: unstarted requests move queue-to-queue onto the
    surviving host with identity intact (same Future, same request_id),
    every one completes oracle-exact, and NOTHING lands in
    sparkdl_requests_failed_total — moving is not dying."""
    cfg, module = bundle
    a = _engine(cfg, module, "drain-a", auto_start=False)
    b = _engine(cfg, module, "drain-b", auto_start=False)
    hosts = {h.host_id: h for h in (InProcessHost(a), InProcessHost(b))}
    registry().reset()
    cases = [([4, 2, 7, 1], 3), ([9, 9, 1], 2), ([3, 8, 5, 5], 3),
             ([6, 1], 2)]
    with Router(list(hosts.values()), auto_refresh=False) as router:
        futs = [router.submit(_payload(p, n)) for p, n in cases]
        rids = [f.request_id for f in futs
                if hasattr(f, "request_id")]  # inner ids via engines
        qa, qb = a.queue.depth, b.queue.depth
        assert qa + qb == 4 and qa and qb  # load spread both ways
        moved = router.drain_host("drain-a")
        assert moved == qa
        assert a.queue.depth == 0 and b.queue.depth == 4
        assert hosts["drain-a"].capacity()["draining"]
        # placements now skip the drained host entirely
        fut_extra = router.submit(_payload([2, 4, 6], 2))
        assert b.queue.depth == 5 and a.queue.depth == 0
        # the drained host's engine loop never ran; the survivor works
        # the merged queue off
        while not (all(f.done() for f in futs) and fut_extra.done()):
            b.tick()
        for (p, n), fut in zip(cases, futs):
            np.testing.assert_array_equal(
                fut.result(0), _oracle(module, p, n))
        fut_extra.result(0)
    fam = registry().snapshot().get("sparkdl_requests_failed_total")
    assert fam is None or not any((fam.get("values") or {}).values())
    assert (registry().snapshot()["sparkdl_fabric_requeued_total"]
            ["values"][""]) == moved
    a.close(drain=False)
    b.close(drain=False)
    del rids


def test_drain_transfers_despite_saturated_survivor(bundle):
    """Regression: a drain during a traffic spike — exactly when
    rolling restarts happen — must still transfer: router-side
    saturation never re-rejects already-accepted requests (the target
    queue's cross-queue requeue absorbs past max_depth by contract)."""
    cfg, module = bundle
    a = _engine(cfg, module, "sat-a", auto_start=False)
    b = _engine(cfg, module, "sat-b", auto_start=False)
    registry().reset()
    with Router([InProcessHost(a), InProcessHost(b)],
                auto_refresh=False, max_outstanding=2) as router:
        futs = [router.submit(_payload([i + 1, 2, 3], 2))
                for i in range(4)]  # exactly saturates both hosts
        qa = a.queue.depth
        assert qa == 2 and b.queue.depth == 2
        moved = router.drain_host("sat-a")
        assert moved == qa  # transferred, NOT failed as QueueFull
        assert b.queue.depth == 4
        while not all(f.done() for f in futs):
            b.tick()
        for i, fut in enumerate(futs):
            np.testing.assert_array_equal(
                fut.result(0),
                _oracle(module, [i + 1, 2, 3], 2))
    fam = registry().snapshot().get("sparkdl_requests_failed_total")
    assert fam is None or not any((fam.get("values") or {}).values())
    a.close(drain=False)
    b.close(drain=False)


def test_snapshot_carries_host_identity_and_capacity(bundle,
                                                     monkeypatch):
    """One structure for the router's weighting — stable
    host_id plus replica/slot/KV-capacity fields — instead of poking
    three subsystems."""
    cfg, module = bundle
    eng = _engine(cfg, module, None, auto_start=False)
    try:
        snap = eng.snapshot()
        assert snap["host_id"] == eng.host_id
        cap = snap["capacity"]
        assert cap["host_id"] == eng.host_id
        assert cap["replica_count"] == 1
        assert cap["n_slots"] == 2 and cap["free_slots"] == 2
        assert cap["kv_blocks_total"] == cap["kv_blocks_free"] > 0
        assert cap["max_queue_depth"] == 256
        assert cap["draining"] is False
        eng.submit([1, 2, 3], 2)
        assert eng.capacity()["queue_depth"] == 1
    finally:
        eng.close(drain=False)
    # the id is stable and operator-pinnable
    monkeypatch.setenv("SPARKDL_TORCH_HOST_ID", "pod-7")
    pinned = _engine(cfg, module, None, auto_start=False)
    try:
        assert pinned.host_id == "pod-7"
        assert pinned.snapshot()["capacity"]["host_id"] == "pod-7"
    finally:
        pinned.close(drain=False)


def test_explicit_host_id_wins_and_digest_names_it(bundle):
    cfg, module = bundle
    eng = _engine(cfg, module, "named-host", auto_start=False)
    try:
        eng.submit([5, 1, 4, 4, 2, 8, 8, 3, 9], 2)
        eng.tick()
        while eng.active_slots:
            eng.tick()
        dig = eng.prefix_digest()
        assert dig["host_id"] == "named-host"
        assert dig["block_size"] == BS
        assert dig["hashes"], "prefilled blocks must be published"
        # version is the trie MUTATION counter (it anchors
        # digest deltas), not a per-call publish counter: reading the
        # digest again must NOT advance it
        assert dig["version"] > 0
        assert eng.prefix_digest()["version"] == dig["version"]
    finally:
        eng.close(drain=False)


def test_dense_engine_publishes_no_digest(bundle):
    cfg, module = bundle
    eng = ContinuousGPTEngine(
        cfg, module, n_slots=1, max_len=MAX_LEN, kv_layout="dense",
        host_id="dense-host", auto_start=False)
    try:
        assert eng.prefix_digest() is None
        cap = eng.capacity()
        assert cap["kv_blocks_total"] is None
        assert cap["host_id"] == "dense-host"
    finally:
        eng.close(drain=False)


def test_begin_drain_idempotent_and_closes_admission(bundle):
    cfg, module = bundle
    eng = _engine(cfg, module, "drain-solo", auto_start=False)
    try:
        f1 = eng.submit([1, 2, 3], 2)
        reqs = eng.begin_drain()
        assert [r.future for r in reqs] == [f1]
        assert eng.begin_drain() == []  # second call: nothing left
        with pytest.raises(Exception):
            eng.submit([4, 5], 2)  # admission closed
    finally:
        eng.close(drain=False)


def test_serving_engine_capacity_surface():
    """The micro-batching engine exposes the same capacity shape (None
    where it has no slots/pool) so the router never special-cases."""
    from sparkdl_torch.serving import ServingEngine
    from sparkdl_torch.transformers._inference import BatchedRunner

    runner = BatchedRunner(lambda b: b["x"], batch_size=4, device="cpu")
    eng = ServingEngine(runner, host_id="mb-host")
    try:
        cap = eng.capacity()
        assert cap["host_id"] == "mb-host"
        assert cap["n_slots"] is None and cap["kv_blocks_total"] is None
        assert cap["replica_count"] >= 1
        assert eng.prefix_digest() is None
        assert eng.snapshot()["host_id"] == "mb-host"
        reqs = eng.begin_drain()
        assert reqs == []
    finally:
        eng.close(drain=False, timeout_s=5)
