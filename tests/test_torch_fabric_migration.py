"""Parked-session migration: on drain/scale-down, parked
sessions serialize through the handoff raw-storage codec and re-park on
a survivor picked by the fleet-agreed rendezvous hash. The headline
contract mirrors the tier store's own: a migrated-then-resumed session
is BITWISE identical to one that never parked, across storage dtypes —
because the wire moves raw storage bytes, never recomputed values. A
torn migration (``kv.migrate`` fault) degrades to re-prefill on resume:
the pre-migration cost, never a lost request.
"""

import numpy as np
import pytest

from sparkdl_torch.fabric import InProcessHost, Router
from sparkdl_torch.observability.registry import registry
from sparkdl_torch.reliability.faults import inject
from sparkdl_torch.serving import ContinuousGPTEngine

MAX_LEN = 32


@pytest.fixture(scope="module")
def bundle():
    from torch_parity import gpt_pair

    _, _, module = gpt_pair(0)
    return module.config, module


def _engine(cfg, module, host_id, **kw):
    kw.setdefault("n_slots", 2)
    kw.setdefault("max_len", MAX_LEN)
    kw.setdefault("auto_start", False)
    kw.setdefault("kv_block_size", 4)
    kw.setdefault("kv_blocks", 24)
    kw.setdefault("host_kv_blocks", 64)
    kw.setdefault("disk_kv_blocks", 16)
    return ContinuousGPTEngine(cfg, module, host_id=host_id, **kw)


def _drain(eng, futs):
    while not all(f.done() for f in futs):
        eng.tick()


def _metric(name, label=""):
    fam = registry().snapshot().get(name) or {}
    return (fam.get("values") or {}).get(label, 0)


def _turn1(eng, prompts):
    futs = [eng.submit(p, 4) for p in prompts]
    _drain(eng, futs)
    return [f.result(timeout=0).tolist() for f in futs]


def _prompts(cfg, seed, n=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, cfg.vocab_size, size=9).tolist()
            for _ in range(n)]


@pytest.mark.parametrize("kv_dtype", [
    "fp32",
    "int8",
])
def test_migrated_resume_bitwise_identical_to_never_parked(
        bundle, kv_dtype):
    """Park on host A, drain A through the router (migration on), run
    turn 2 on host B: greedy tokens must equal the never-parked
    single-engine run exactly, and B must have PAGED the blocks in
    (unparks > 0), not re-prefilled."""
    cfg, module = bundle
    prompts = _prompts(cfg, 7)

    # never-parked control: both turns on one engine, no parking
    with _engine(cfg, module, "ctrl", kv_dtype=kv_dtype) as ctrl:
        replies = _turn1(ctrl, prompts)
        futs = [ctrl.submit(p + r + [5], 4)
                for p, r in zip(prompts, replies)]
        _drain(ctrl, futs)
        want = [f.result(timeout=0).tolist() for f in futs]

    eng_a = _engine(cfg, module, "host-a", kv_dtype=kv_dtype)
    eng_b = _engine(cfg, module, "host-b", kv_dtype=kv_dtype)
    try:
        assert _turn1(eng_a, prompts) == replies
        assert eng_a.park_cold() > 0
        sessions_a = eng_a.capacity()["kv_parked_sessions"]
        assert sessions_a >= len(prompts)
        exported0 = _metric("sparkdl_kv_migrations_total",
                            'outcome="exported"')
        r = Router([InProcessHost(eng_a), InProcessHost(eng_b)],
                   auto_refresh=False)
        try:
            r.drain_host("host-a")
        finally:
            r.close()
        assert (_metric("sparkdl_kv_migrations_total",
                        'outcome="exported"') - exported0) >= 3
        assert eng_a.capacity()["kv_parked_sessions"] == 0
        assert eng_b.capacity()["kv_parked_sessions"] >= len(prompts)
        # resume every session on B: bitwise parity with never-parked
        futs = [eng_b.submit(p + r2 + [5], 4)
                for p, r2 in zip(prompts, replies)]
        _drain(eng_b, futs)
        assert [f.result(timeout=0).tolist() for f in futs] == want
        tiers_b = eng_b._kv_snapshot()["tiers"]
        assert tiers_b["unparks"] > 0  # paged in, not re-prefilled
    finally:
        eng_a.close(drain=False)
        eng_b.close(drain=False)


def test_torn_migration_degrades_to_reprefill_zero_lost(bundle):
    """An injected ``kv.migrate`` fault mid-export tears one session
    out of the bundle: that session re-prefills on resume (the
    pre-migration cost), the others page in — every request still
    completes bitwise-correct."""
    cfg, module = bundle
    prompts = _prompts(cfg, 9)

    with _engine(cfg, module, "ctrl2") as ctrl:
        replies = _turn1(ctrl, prompts)
        futs = [ctrl.submit(p + r + [5], 4)
                for p, r in zip(prompts, replies)]
        _drain(ctrl, futs)
        want = [f.result(timeout=0).tolist() for f in futs]

    eng_a = _engine(cfg, module, "torn-a")
    eng_b = _engine(cfg, module, "torn-b")
    try:
        _turn1(eng_a, prompts)
        eng_a.park_cold()
        failed0 = _metric("sparkdl_kv_migrations_total",
                          'outcome="export_failed"')
        r = Router([InProcessHost(eng_a), InProcessHost(eng_b)],
                   auto_refresh=False)
        try:
            with inject("kv.migrate:RuntimeError@1"):
                r.drain_host("torn-a")
            assert (_metric("sparkdl_kv_migrations_total",
                            'outcome="export_failed"') - failed0) >= 1
            # the surviving host still serves EVERY turn-2 request —
            # migrated sessions page in, the torn one re-prefills
            r.refresh()
            futs = [r.submit({"prompt": p + r2 + [5],
                              "max_new_tokens": 4})
                    for p, r2 in zip(prompts, replies)]
            _drain(eng_b, futs)  # drained A is out: B serves them all
            got = [np.asarray(f.result(5)).tolist() for f in futs]
            assert got == want
        finally:
            r.close()
    finally:
        eng_a.close(drain=False)
        eng_b.close(drain=False)


def test_import_refuses_mismatched_grid_and_dtype(bundle):
    """A bundle on a different block grid or storage dtype cannot
    install bitwise-identically — import must skip it whole (those
    sessions re-prefill) rather than corrupt the cache."""
    cfg, module = bundle
    prompts = _prompts(cfg, 13, n=2)
    with _engine(cfg, module, "grid-a") as eng:
        _turn1(eng, prompts)
        eng.park_cold()
        bundle_out = eng.export_parked_sessions()
        assert bundle_out and len(bundle_out["sessions"]) >= 2
        assert bundle_out["kv_dtype"] == "fp32"
        wrong_grid = dict(bundle_out, block_size=8)
        assert eng.import_parked_sessions(wrong_grid) == 0
        wrong_dtype = dict(bundle_out, kv_dtype="int8")
        assert eng.import_parked_sessions(wrong_dtype) == 0
        assert eng.import_parked_sessions(None) == 0
        # the matching bundle re-imports cleanly (self-adoption after
        # the export pruned the parked paths)
        assert eng.import_parked_sessions(bundle_out) >= 2
        assert eng.capacity()["kv_parked_sessions"] >= 2
