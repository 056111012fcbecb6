"""Digest deltas: the journal on the host side
(``PrefixCache.block_hash_delta``), the fold on the router side
(``HostDigest.apply_delta``), and the delta-first refresh between them
— including every degraded path (gap, replay, torn fetch) ending in a
wholesale re-sync, because digests are advisory and the fallback IS the
pre-delta behavior.
"""

import numpy as np
import pytest

from sparkdl_torch.fabric import HostDigest, Router
from sparkdl_torch.fabric.digest import prompt_block_hashes
from sparkdl_torch.observability.registry import registry
from sparkdl_torch.reliability.faults import inject
from sparkdl_torch.serving.kv_blocks import KVBlockPool
from sparkdl_torch.serving.prefix_cache import PrefixCache

from torch_fabric_fakes import FakeHost, fast_postmortems  # noqa: F401
from torch_fabric_fakes import gpt_payload as _gpt_payload
from torch_fabric_fakes import make_router as _router
from torch_fabric_fakes import metric as _metric


def _metric(name, label=""):
    fam = registry().snapshot().get(name) or {}
    return (fam.get("values") or {}).get(label, 0)


def _cache(journal_limit=1024):
    pool = KVBlockPool(32, 2)
    return PrefixCache(pool, journal_limit=journal_limit), pool


def _register(prefix, pool, tokens):
    bids = pool.allocate(len(tokens) // pool.block_size)
    prefix.register(tuple(tokens), bids)
    prefix.release(bids)  # refcount 0: cold, cached, evictable
    return bids


# -- host side: the journal ---------------------------------------------------

def test_delta_reports_adds_then_evictions():
    prefix, pool = _cache()
    _register(prefix, pool, [1, 2])
    _register(prefix, pool, [3, 4])
    v0 = prefix.digest_version
    delta = prefix.block_hash_delta(0)
    assert delta["since"] == 0 and delta["version"] == v0
    assert sorted(delta["added"]) == sorted(prefix.block_hashes())
    assert delta["removed"] == []
    # an eviction journals a removal relative to v0
    assert prefix.evict(1) == 1
    delta = prefix.block_hash_delta(v0)
    assert len(delta["removed"]) == 1
    assert delta["added"] == []
    assert delta["version"] == prefix.digest_version > v0


def test_delta_caught_up_is_empty_noop():
    prefix, pool = _cache()
    _register(prefix, pool, [1, 2])
    v = prefix.digest_version
    delta = prefix.block_hash_delta(v)
    assert delta == {"since": v, "version": v,
                     "added": [], "removed": []}


def test_delta_coalesces_add_then_evict_to_nothing():
    """A block added AND evicted inside one window nets out — the
    caller never sees churn it could not have acted on."""
    prefix, pool = _cache()
    _register(prefix, pool, [1, 2])
    v0 = prefix.digest_version
    _register(prefix, pool, [3, 4])
    prefix.evict(1)  # evicts [3,4], the LRU cold leaf? stamp order: [1,2] older
    delta = prefix.block_hash_delta(v0)
    # whichever leaf was evicted, adds and removes must not overlap
    assert not (set(delta["added"]) & set(delta["removed"]))
    # and folding the delta onto the v0 membership gives the current one
    base = set(prefix.block_hashes()) - set(delta["added"])
    base |= set(delta["removed"])
    assert ((base - set(delta["removed"])) | set(delta["added"])
            == set(prefix.block_hashes()))


def test_delta_gap_when_journal_rolled_past_caller():
    prefix, pool = _cache(journal_limit=2)
    for toks in ([1, 2], [3, 4], [5, 6], [7, 8]):
        _register(prefix, pool, toks)
    assert prefix.block_hash_delta(0) is None  # journal kept only 2
    # the freshest window is still answerable
    assert prefix.block_hash_delta(prefix.digest_version - 1) is not None


def test_delta_gap_when_caller_claims_future_version():
    prefix, pool = _cache()
    _register(prefix, pool, [1, 2])
    assert prefix.block_hash_delta(prefix.digest_version + 5) is None


def test_delta_gap_when_larger_than_max_entries():
    prefix, pool = _cache()
    for i in range(4):
        _register(prefix, pool, [10 * i + 1, 10 * i + 2])
    assert prefix.block_hash_delta(0, max_entries=2) is None


# -- router side: the fold ----------------------------------------------------

def _digest(version, hashes):
    return HostDigest(host_id="h", block_size=4,
                      hashes=frozenset(hashes), version=version)


def test_apply_delta_advances_membership_and_version():
    d = _digest(3, {10, 20})
    out = d.apply_delta({"since": 3, "version": 5, "block_size": 4,
                         "added": [30], "removed": [10]})
    assert out is not d
    assert out.hashes == frozenset({20, 30})
    assert out.version == 5


def test_apply_delta_replay_is_idempotent():
    """A stale delta (history we already folded) returns self
    UNCHANGED — applying the same journal window twice must not
    double-remove (out-of-order delivery tolerance)."""
    d = _digest(3, {10, 20})
    adv = d.apply_delta({"since": 3, "version": 5, "block_size": 4,
                        "added": [30], "removed": [10]})
    # the same delta arrives again, now behind adv's version
    assert adv.apply_delta(
        {"since": 3, "version": 5, "block_size": 4,
         "added": [30], "removed": [10]}) is adv
    # and an even older empty window is equally inert
    assert adv.apply_delta(
        {"since": 0, "version": 2, "block_size": 4,
         "added": [99], "removed": []}) is adv


def test_apply_delta_gap_and_grid_change_demand_wholesale():
    d = _digest(3, {10})
    # since-mismatch with a NEWER version: we missed history
    assert d.apply_delta({"since": 4, "version": 6, "block_size": 4,
                          "added": [], "removed": []}) is None
    # block grid changed under us: membership is incomparable
    assert d.apply_delta({"since": 3, "version": 4, "block_size": 8,
                          "added": [], "removed": []}) is None
    assert d.apply_delta(None) is None


# -- the refresh loop: delta-first, wholesale on every degraded path ----------

class DeltaHost(FakeHost):
    """A FakeHost with a scripted journal endpoint."""

    def __init__(self, host_id, **kw):
        super().__init__(host_id, **kw)
        self.version = 1
        self.delta_script = None  # None => gap; dict => served verbatim
        self.delta_calls = 0
        self.delta_raises = None

    def prefix_digest(self, max_entries=1024):
        snap = super().prefix_digest(max_entries)
        if snap is not None:
            snap["version"] = self.version
        return snap

    def prefix_digest_delta(self, since_version, max_entries=1024):
        self.delta_calls += 1
        if self.delta_raises is not None:
            raise self.delta_raises
        if self.delta_script is not None:
            return self.delta_script
        return {"since": since_version, "version": self.version,
                "host_id": self.host_id, "block_size": self.block_size,
                "added": [], "removed": []}


def test_router_refresh_consumes_deltas_after_first_wholesale():
    prompt = list(range(9))
    h = DeltaHost("a", digest_hashes=prompt_block_hashes(prompt, 4))
    wholesale0 = _metric("sparkdl_fabric_digest_wholesale_bytes_total")
    delta0 = _metric("sparkdl_fabric_digest_delta_bytes_total")
    with _router([h]) as r:
        # construction refreshed once: wholesale (no prior digest)
        assert h.delta_calls == 0
        assert (_metric("sparkdl_fabric_digest_wholesale_bytes_total")
                > wholesale0)
        base = r._hosts["a"].digest
        # steady state: the delta path carries an add
        new_hash = 777
        h.version = 2
        h.delta_script = {"since": base.version, "version": 2,
                          "host_id": "a", "block_size": 4,
                          "added": [new_hash], "removed": []}
        r.refresh()
        dig = r._hosts["a"].digest
        assert new_hash in dig.hashes and dig.version == 2
        assert base.hashes < dig.hashes  # old membership kept
        assert (_metric("sparkdl_fabric_digest_delta_bytes_total")
                > delta0)
        assert _metric("sparkdl_fabric_digest_delta_applied_total",
                       'outcome="applied"') >= 1


def test_router_refresh_gap_and_torn_delta_fall_back_wholesale():
    prompt = list(range(9))
    h = DeltaHost("a", digest_hashes=prompt_block_hashes(prompt, 4))
    with _router([h]) as r:
        # server-side gap (None): wholesale, membership still correct
        h.delta_script = None

        def gap(since, max_entries=1024, _h=h):
            _h.delta_calls += 1
            return None
        h.prefix_digest_delta = gap
        before = _metric("sparkdl_fabric_digest_wholesale_bytes_total")
        r.refresh()
        assert h.delta_calls >= 1
        assert (_metric("sparkdl_fabric_digest_wholesale_bytes_total")
                > before)
        assert r._hosts["a"].digest is not None
        # torn delta fetch (a non-host-level error): outcome=error,
        # wholesale re-sync, digest intact
        del h.prefix_digest_delta
        h.delta_raises = ValueError("torn journal read")
        errs = _metric("sparkdl_fabric_digest_delta_applied_total",
                       'outcome="error"')
        r.refresh()
        assert _metric("sparkdl_fabric_digest_delta_applied_total",
                       'outcome="error"') > errs
        assert r._hosts["a"].digest is not None
        # detected-gap on apply (host restarted at a higher version)
        h.delta_raises = None
        h.delta_script = {"since": 99, "version": 100, "host_id": "a",
                          "block_size": 4, "added": [], "removed": []}
        gaps = _metric("sparkdl_fabric_digest_delta_applied_total",
                       'outcome="gap"')
        r.refresh()
        assert _metric("sparkdl_fabric_digest_delta_applied_total",
                       'outcome="gap"') > gaps


# -- the real engine journal behind the same loop -----------------------------

@pytest.fixture(scope="module")
def engine_bundle():
    from torch_parity import gpt_pair

    _, _, module = gpt_pair(0)
    return module.config, module


def _drain(eng, futs):
    while not all(f.done() for f in futs):
        eng.tick()


def test_engine_delta_tracks_new_prefills_and_survives_fault(
        engine_bundle):
    """End-to-end over a live engine: a router that already synced
    wholesale advances by delta as new prompts prefill; an injected
    ``digest.delta`` fault (torn journal read) degrades to a wholesale
    re-sync with the digest still exactly the engine's membership."""
    from sparkdl_torch.fabric import InProcessHost
    from sparkdl_torch.serving import ContinuousGPTEngine

    cfg, module = engine_bundle
    eng = ContinuousGPTEngine(
        cfg, module, n_slots=2, max_len=32, kv_block_size=4,
        auto_start=False, host_id="delta-host")
    try:
        rng = np.random.default_rng(11)
        p1 = rng.integers(1, cfg.vocab_size, size=9).tolist()
        _drain(eng, [eng.submit(p1, 2)])
        with _router([InProcessHost(eng)]) as r:
            state = r._hosts["delta-host"]
            v1 = state.digest.version
            assert state.digest.hashes
            # a new prompt prefills: the next refresh rides the journal
            p2 = rng.integers(1, cfg.vocab_size, size=9).tolist()
            _drain(eng, [eng.submit(p2, 2)])
            applied = _metric(
                "sparkdl_fabric_digest_delta_applied_total",
                'outcome="applied"')
            r.refresh()
            assert state.digest.version > v1
            assert set(state.digest.hashes) == set(eng._prefix
                                                   .block_hashes())
            assert _metric(
                "sparkdl_fabric_digest_delta_applied_total",
                'outcome="applied"') > applied
            # torn delta: the fault site fires, wholesale re-syncs
            p3 = rng.integers(1, cfg.vocab_size, size=9).tolist()
            _drain(eng, [eng.submit(p3, 2)])
            errs = _metric(
                "sparkdl_fabric_digest_delta_applied_total",
                'outcome="error"')
            with inject("digest.delta:RuntimeError@1"):
                r.refresh()
            assert _metric(
                "sparkdl_fabric_digest_delta_applied_total",
                'outcome="error"') > errs
            assert set(state.digest.hashes) == set(eng._prefix
                                                   .block_hashes())
    finally:
        eng.close(drain=False)
