"""The port's sequence-parallel ContinuousGPTEngine (``sp=2`` over
``["cpu"] * 2``) against the JAX package, on the same tiny GPT weights:
greedy tokens bitwise those of the JAX ``generate`` oracle, of the
port's ``sp=1`` engine and of the dense engine, across prefix hits,
copy-on-write tails, chained decode, speculative decode and int8 pools;
once, the JAX engine at ``sp=2`` on the conftest mesh. Plus the staging
pool's bookkeeping, the ``sp.permute`` / ``sp.gather`` chaos contract
(an injected collective fault re-queues the request, loses nothing and
lands in the flight ring), and the ``sp_prefill`` dispatch metrics.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import gpt_pair

from sparkdl_torch.models.gpt import GPTConfig
from sparkdl_torch.observability.flight import flight_recorder
from sparkdl_torch.observability.registry import registry
from sparkdl_torch.reliability import faults
from sparkdl_torch.serving import ContinuousGPTEngine as TorchEngine
from sparkdl_tpu.models.gpt import generate as jax_generate
from sparkdl_tpu.serving import ContinuousGPTEngine as JaxEngine

MAX_LEN = 64
SHARED = [5, 3, 9, 2, 7, 11, 4, 8]
CASES = [
    (SHARED + [1, 6], 6),
    (SHARED + [2, 2, 9], 5),       # a prefix hit
    ([6, 8, 6], 4),                # no shared prefix
    (SHARED + [1, 6], 3),          # the whole prompt but its last token
    (list(range(1, 20)), 5),       # three chunks at prefill_chunk=8
]


@pytest.fixture(scope="module")
def pair():
    jm, variables, tm = gpt_pair(0)
    return jm, variables, tm


@pytest.fixture(scope="module")
def oracle(pair):
    """The JAX ``generate`` stream of a (prompt, max_new), memoized."""
    jm, variables, _ = pair
    memo = {}

    def stream(prompt, max_new):
        key = (tuple(prompt), max_new)
        if key not in memo:
            out = jax_generate(jm, variables, jnp.asarray([prompt], jnp.int32),
                               max_new)
            memo[key] = np.asarray(out[0, len(prompt):]).tolist()
        return memo[key]

    return stream


def _engine(module, **kw):
    kw.setdefault("n_slots", 2)
    kw.setdefault("max_len", MAX_LEN)
    kw.setdefault("kv_block_size", 4)
    kw.setdefault("prefill_chunk", 8)
    return TorchEngine(module.config, module, auto_start=False, **kw)


def _drain(eng, futs):
    for _ in range(500):
        eng.tick()
        if all(f.done() for f in futs):
            break


def _run(module, cases=CASES, **kw):
    eng = _engine(module, **kw)
    futs = [eng.submit(p, n) for p, n in cases]
    _drain(eng, futs)
    snap = eng.snapshot()
    eng.close()
    return [f.result(timeout=0).tolist() for f in futs], snap


# -- parity ------------------------------------------------------------------

@pytest.mark.parametrize("decode_kw", [
    {},                        # plain per-token decode
    {"chain_tokens": 4},       # chained decode
    {"spec_k": 4},             # speculative verify
], ids=["plain", "chain4", "spec4"])
def test_sp2_bitwise_vs_sp1_and_oracle(pair, oracle, decode_kw):
    """Greedy tokens identical across sp in {1, 2} and to the JAX
    oracle under every decode mode: the handoff leaves the per-token
    loop untouched."""
    _, _, module = pair
    sp1, _ = _run(module, **decode_kw)
    sp2, snap = _run(module, sp=2, **decode_kw)
    assert sp2 == sp1
    assert sp2 == [oracle(p, n) for p, n in CASES]
    kv = snap["kv"]
    assert kv["sp"]["axis"] == 2 and kv["sp"]["devices"] == ["cpu", "cpu"]
    assert kv["sp"]["handoffs"] == len(CASES)
    assert kv["prefix_hits"] > 0  # the hit survived the sharded gather


def test_sp2_matches_the_jax_engine_at_sp2(pair):
    """The reference's own sp=2 engine (conftest's CPU mesh) on the same
    weights and requests: the same tokens, hits, chunks and handoffs."""
    jm, variables, module = pair
    jeng = JaxEngine(jm.config, variables, n_slots=2, max_len=MAX_LEN,
                     kv_block_size=4, prefill_chunk=8, sp=2, auto_start=False)
    futs = [jeng.submit(p, n) for p, n in CASES]
    _drain(jeng, futs)
    jsnap = jeng.snapshot()
    jeng.close()
    want = [np.asarray(f.result(timeout=0)).tolist() for f in futs]
    got, snap = _run(module, sp=2)
    assert got == want
    for key in ("prefix_hits", "prefix_misses", "prefill_chunks",
                "deferrals_total"):
        assert snap["kv"][key] == jsnap["kv"][key], key
    for key in ("axis", "handoffs", "staging_blocks_total",
                "staging_blocks_used", "shard_used"):
        assert snap["kv"]["sp"][key] == jsnap["kv"]["sp"][key], key


def test_sp2_bitwise_vs_dense(pair):
    _, _, module = pair
    dense, _ = _run(module, kv_layout="dense", kv_block_size=16,
                    prefill_chunk=None)
    sp2, _ = _run(module, sp=2)
    assert sp2 == dense


def test_sp2_quantized_pool_matches_sp1(pair):
    """int8 decode pools under sp: staging stays in the compute dtype and
    the handoff install quantizes once, so sp=2 tokens equal sp=1's."""
    _, _, module = pair
    sp1, _ = _run(module, kv_dtype="int8")
    sp2, snap = _run(module, sp=2, kv_dtype="int8")
    assert sp2 == sp1
    assert snap["kv"]["dtype"] == "int8"


def test_sp2_learned_positions_match_sp1_and_oracle():
    """GPT-2's learned position table (the card's configuration): each
    shard embeds its rows at their global positions."""
    jm, variables, module = gpt_pair(0, positions="learned")
    sp1, _ = _run(module)
    sp2, _ = _run(module, sp=2)
    assert sp2 == sp1
    for (p, n), got in zip(CASES, sp2):
        want = jax_generate(jm, variables, jnp.asarray([p], jnp.int32), n)
        assert got == np.asarray(want[0, len(p):]).tolist()


def test_sp_cow_partial_block_across_sharded_gather(pair, oracle):
    """A copy-on-write partial tail block: the sharer's staged copy is
    seeded from the donor's registered blocks while the donor decodes,
    and the donor decodes on untouched; both equal their oracles."""
    _, _, module = pair
    donor = (SHARED + [1], 8)            # partial tail block
    sharer = (SHARED + [1, 9, 9], 6)     # shares into the donor's tail
    eng = _engine(module, sp=2)
    f_donor = eng.submit(*donor)
    while eng.active_slots == 0:  # donor through prefill, into decode
        eng.tick()
    f_sharer = eng.submit(*sharer)
    _drain(eng, [f_donor, f_sharer])
    snap = eng.snapshot()
    eng.close()
    for (prompt, max_new), fut in ((donor, f_donor), (sharer, f_sharer)):
        assert fut.result(timeout=0).tolist() == oracle(prompt, max_new)
    assert snap["kv"]["prefix_hits"] > 0


def test_sp_final_chunk_never_clamps_at_table_edge(pair, oracle):
    """A 3-token prefix hit offsets the chunk grid so the 63-token
    prompt's final chunk (c0=59, width 8) reaches column 67, past the
    64-column table span: the key buffer carries the chunk headroom (wp
    = table span + chunk cap), so no write is clamped."""
    _, _, module = pair
    donor = ([7, 7, 7], 2)
    edge = ([7, 7, 7] + list(range(1, 61)), 1)  # 63 tokens, hit=3
    eng = _engine(module, sp=2)
    f1 = eng.submit(*donor)
    _drain(eng, [f1])
    f2 = eng.submit(*edge)
    _drain(eng, [f2])
    snap = eng.snapshot()
    eng.close()
    assert snap["kv"]["prefix_hits"] >= 3  # the grid really is offset
    assert f2.result(timeout=0).tolist() == oracle(*edge)


def test_sp_staging_exhaustion_defers_on_staging_pool(pair):
    """A deferral caused by the STAGING pool records its streak (and the
    /healthz degraded signal) on the staging pool."""
    _, _, module = pair
    eng = _engine(module, sp=2, sp_kv_blocks=8)
    # 32 tokens = 8 staging blocks: one 4-chunk prefill holds the whole
    # staging pool for 4 ticks, so the second request defers on staging
    blocker = eng.submit(list(range(1, 33)), 2)
    eng.tick()                      # admit blocker (staging now full)
    starved = eng.submit(list(range(30, 46)), 2)
    eng.tick()                      # starved defers; blocker chunk 2/4
    snap = eng.snapshot()["kv"]
    assert snap["sp"]["staging_streak"] >= 1, snap
    assert snap["exhausted_streak"] >= 1, snap  # healthz sees it
    _drain(eng, [blocker, starved])
    assert blocker.done() and starved.done()
    snap = eng.snapshot()["kv"]
    assert snap["sp"]["staging_streak"] == 0, snap
    eng.close()


# -- staging bookkeeping -----------------------------------------------------

def test_staging_blocks_release_after_handoff(pair):
    _, _, module = pair
    _, snap = _run(module, sp=2)
    sp = snap["kv"]["sp"]
    assert sp["staging_blocks_used"] == 0, sp  # all handed off
    assert sp["shard_used"] == [0, 0]
    assert sp["handoffs"] == len(CASES)


def test_sp_non_divisible_chunk_cap_floors_to_sp_multiple(pair, oracle):
    """A prefill_chunk that sp does not divide: the chunk cap floors to
    a multiple of sp at construction, so every chunk splits evenly."""
    _, _, module = pair
    prompt = list(range(1, 25))  # 24 tokens: 3 chunks
    eng = _engine(module, sp=2, prefill_chunk=9)
    assert eng._chunk_cap % 2 == 0
    fut = eng.submit(prompt, 4)
    _drain(eng, [fut])
    eng.close()
    assert fut.result(timeout=0).tolist() == oracle(prompt, 4)


def test_sp_requires_paged_layout(pair):
    _, _, module = pair
    with pytest.raises(ValueError, match="paged"):
        _engine(module, kv_layout="dense", sp=2)


def test_sp_env_pin_requires_paged_layout_too(pair, monkeypatch):
    # the pin is as loud as the argument: SPARKDL_TORCH_SP=2 on a dense
    # engine raises, never a silently single-device engine
    _, _, module = pair
    monkeypatch.setenv("SPARKDL_TORCH_SP", "2")
    with pytest.raises(ValueError, match="paged"):
        _engine(module, kv_layout="dense")


def test_sp_power_of_two_validated(pair):
    _, _, module = pair
    with pytest.raises(ValueError, match="power of two"):
        _engine(module, sp=3)
    with pytest.raises(ValueError, match=">= 1"):
        _engine(module, sp=0)


def test_sp_staging_bound_rejects_unprefillable_prompt(pair):
    _, _, module = pair
    eng = _engine(module, sp=2, sp_kv_blocks=2)
    with pytest.raises(ValueError, match="staging"):
        eng.submit(list(range(1, 14)), 2)  # 13 tokens -> 4 blocks > 2
    eng.close()


def test_sp_devices_and_weight_copies(pair, monkeypatch):
    """The CPU repeats its one device and shares the engine's module;
    the card takes the model's card and the ones after it, and refuses
    more than it sees."""
    _, _, module = pair
    eng = _engine(module, sp=2)
    assert eng._sp_devs == [torch.device("cpu")] * 2
    assert all(m is module for m in eng._sp_models)  # one copy a device
    assert [kv["k"].shape[1] for kv in eng._sp_kv] == [
        eng._sp_pool.blocks_per_shard + 1] * 2  # a scratch block each
    eng.close()
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    cuda0 = torch.device("cuda", 0)
    assert TorchEngine._sp_devices(cuda0, 2) == [
        torch.device("cuda", 0), torch.device("cuda", 1)]
    with pytest.raises(ValueError, match="exceeds the 2 visible devices"):
        TorchEngine._sp_devices(cuda0, 4)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    cuda2 = torch.device("cuda", 2)
    assert TorchEngine._sp_devices(cuda2, 2) == [
        torch.device("cuda", 2), torch.device("cuda", 3)]
    with pytest.raises(ValueError, match="from cuda:2 exceeds the 4 visible"):
        TorchEngine._sp_devices(cuda2, 4)


def test_sp_weight_copies_follow_in_place_updates():
    """Weights loaded into the engine's module in place reach the other
    device's copy before the next chunk: on a two-device placement the
    tokens after the update are the JAX oracle's on the new weights."""
    import copy

    jm0, variables0, module0 = gpt_pair(0)
    jm1, variables1, module1 = gpt_pair(1)
    module = copy.deepcopy(module0)

    class Placed(TorchEngine):
        @staticmethod
        def _sp_devices(device, n):
            return [torch.device("cpu"), torch.device("cpu", 0)]

    eng = Placed(module.config, module, n_slots=2, max_len=MAX_LEN,
                 kv_block_size=4, prefill_chunk=8, sp=2, auto_start=False)
    assert eng._sp_models[0] is module and eng._sp_models[1] is not module
    want = []
    for jm, variables, prompt in ((jm0, variables0, [6, 8, 6]),
                                  (jm1, variables1, list(range(1, 20)))):
        if jm is jm1:
            module.load_state_dict(module1.state_dict())
        fut = eng.submit(prompt, 5)
        _drain(eng, [fut])
        out = jax_generate(jm, variables, jnp.asarray([prompt], jnp.int32), 5)
        want.append((fut.result(timeout=0).tolist(),
                     np.asarray(out[0, len(prompt):]).tolist()))
    eng.close()
    for got, oracle_tokens in want:
        assert got == oracle_tokens


# -- chaos contract ----------------------------------------------------------

@pytest.mark.parametrize("site, plan", [
    ("sp.permute", "sp.permute:OSError@2"),
    ("sp.gather", "sp.gather:OSError@2"),
])
def test_sp_collective_fault_requeues_without_loss(pair, oracle, site, plan):
    """An injected collective fault mid-prefill: the request is
    re-queued (none lost), retried bitwise, and the typed failure lands
    in the flight ring."""
    _, _, module = pair
    faults.disarm()
    faults.arm(faults.FaultPlan.parse(plan))
    try:
        outs, _ = _run(module, sp=2)
    finally:
        faults.disarm()
    assert outs == [oracle(p, n) for p, n in CASES]
    evs = [e for e in flight_recorder().events()
           if e.get("kind") == "sp.collective_failed"]
    assert any(e["site"] == site and e["error"] == "SpCollectiveError"
               for e in evs), (site, evs)


def test_sp_staging_alloc_fault_defers_without_leak(pair, oracle):
    """An injected kv.alloc fault on the STAGING allocate (the second
    kv.alloc of an sp admission; the decode allocate is the first)
    defers like any exhaustion, never fails the request, and releases
    the decode blocks already taken."""
    _, _, module = pair
    prompt = list(range(1, 14))
    faults.disarm()
    faults.arm(faults.FaultPlan.parse("kv.alloc:OSError@2"))
    try:
        eng = _engine(module, sp=2)
        fut = eng.submit(prompt, 3)
        _drain(eng, [fut])
        got = fut.result(timeout=0).tolist()  # deferred, not failed
        snap = eng.snapshot()["kv"]
        eng.close()
    finally:
        faults.disarm()
    assert got == oracle(prompt, 3)
    assert snap["deferrals_total"] == 1
    # no leak: the retired request's cached prompt blocks are all that
    # stays off the free list, and staging drained fully
    assert snap["blocks_used"] == snap["blocks_cached"], snap
    assert snap["sp"]["staging_blocks_used"] == 0, snap


# -- metrics -----------------------------------------------------------------

def test_sp_dispatches_recorded_under_own_path(pair):
    """sp chunks land in sparkdl_dispatch_seconds{path="sp_prefill"} and
    the ring-step and permute-byte counters, and never feed the decode
    ChainPolicy's calibration."""
    _, _, module = pair
    registry().reset()
    eng = _engine(module, sp=2)
    fed = []
    record = eng._chain_policy.record
    eng._chain_policy.record = lambda wall, k: (fed.append(k), record(wall, k))
    futs = [eng.submit(p, n) for p, n in CASES]
    _drain(eng, futs)
    chunks = eng.snapshot()["kv"]["prefill_chunks"]
    eng.close()
    snap = registry().snapshot()
    disp = snap["sparkdl_dispatches_total"]["values"]
    assert disp.get('path="sp_prefill"', 0) == chunks > 0, disp
    # the decode policy timed the decode programs, and nothing else
    assert len(fed) == disp['path="decode"'] > 0
    assert snap["sparkdl_sp_ring_steps_total"]["values"][""] == chunks
    # 2 x layers x hidden x 4 bytes x (sp - 1) a column of each chunk
    cfg = module.config
    per_col = 2 * cfg.num_layers * cfg.hidden_size * 4
    bytes_ = snap["sparkdl_sp_permute_bytes_total"]["values"][""]
    assert bytes_ > 0 and bytes_ % per_col == 0


def test_sp_mode_config_rejects_unknown():
    cfg = dataclasses.replace(GPTConfig.tiny(), attn_impl="ring",
                              sp_mode="allgather")
    assert cfg.sp_mode == "allgather"
    with pytest.raises(ValueError, match="sp_mode"):
        dataclasses.replace(cfg, sp_mode="all-gather")
