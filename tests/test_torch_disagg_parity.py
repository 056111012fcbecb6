"""Disaggregated serving parity: the tier split must be invisible in the
tokens.

The contract: greedy decode through the port's PrefillWorker →
KVHandoff → DecodeWorker chain is BITWISE the port's colocated engine
across {fp32, int8} pools × {plain, chained, speculative} decode —
including prompts that hit the prefix cache on either side of the
boundary; the int8 wire moves ≥3.5× fewer bytes than fp32 (the quantized
pool's storage IS the wire format). The JAX package's side of the
contract is tests/test_torch_disagg_cross.py.
"""

import json
import time

import numpy as np
import pytest
from torch_parity import gpt_pair

from sparkdl_torch.disagg import DecodeWorker, KVHandoff, PrefillWorker
from sparkdl_torch.serving import ContinuousGPTEngine
from sparkdl_torch.serving.kv_codec import BF16Bits

MAX_LEN = 40
MODES = {"plain": {}, "chained": {"chain_tokens": 4}, "spec": {"spec_k": 3}}


@pytest.fixture(scope="module")
def bundle():
    jm, variables, module = gpt_pair(0)
    return jm.config, variables, module.config, module


def _kw(**over):
    kw = dict(n_slots=2, max_len=MAX_LEN, auto_start=False,
              kv_block_size=4, prefill_chunk=8)
    kw.update(over)
    return kw


def _drain(engine, futs):
    while not all(f.done() for f in futs):
        engine.tick()
    return [f.result(timeout=0) for f in futs]


def _cases(seed=0):
    rng = np.random.RandomState(seed)
    sizes = ((7, 8), (12, 6), (5, 1), (17, 9), (4, 12))
    return [(rng.randint(0, 50, size=n).tolist(), m) for n, m in sizes]


def _colocated(cfg, model, cases, **over):
    eng = ContinuousGPTEngine(cfg, model, **_kw(**over))
    try:
        return [np.asarray(r).tolist() for r in _drain(
            eng, [eng.submit(p, m) for p, m in cases])]
    finally:
        eng.close()


def _disaggregated(cfg, model, cases, *, decode_over=None, wire=True,
                   **over):
    pre = PrefillWorker(cfg, model, **_kw(**over))
    dec = DecodeWorker(cfg, model, **_kw(**{**over, **(decode_over or {})}))
    try:
        handoffs = _drain(pre, [pre.submit(p, m) for p, m in cases])
        crossing = ([KVHandoff.from_wire(json.loads(json.dumps(h.to_wire())))
                     for h in handoffs] if wire else handoffs)
        got = [np.asarray(r).tolist() for r in _drain(
            dec, [dec.submit_handoff(h) for h in crossing])]
        return handoffs, got
    finally:
        pre.close()
        dec.close()


# -- the headline contract ---------------------------------------------------

@pytest.mark.parametrize("dtype", ["fp32", "int8"])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_tokens_bitwise_identical_across_the_split(bundle, dtype, mode):
    _, _, cfg, module = bundle
    cases = _cases()
    want = _colocated(cfg, module, cases, kv_dtype=dtype, **MODES[mode])
    # the in-process crossing, and the JSON wire in between
    for wire in (False, True):
        _, got = _disaggregated(cfg, module, cases, kv_dtype=dtype,
                                decode_over=MODES[mode], wire=wire)
        assert got == want, (dtype, mode, wire)


@pytest.mark.parametrize("dtype", ["fp32", "int8"])
def test_prefix_hits_cross_the_tier_boundary_bitwise(bundle, dtype):
    """A transferred prompt registers in the DECODE tier's prefix
    cache too: resubmitting a shared-prefix prompt must hit on both
    tiers (prefill skips the prefix, decode shares its blocks) and
    still produce the colocated tokens."""
    _, _, cfg, module = bundle
    base = list(range(1, 13))
    cases = [(base + [20, 21], 6), (base + [30, 31, 32], 6)]
    want = _colocated(cfg, module, cases, kv_dtype=dtype)
    pre = PrefillWorker(cfg, module, kv_dtype=dtype, **_kw())
    dec = DecodeWorker(cfg, module, kv_dtype=dtype, **_kw())
    try:
        # sequential, so the second prompt sees the first's prefix
        got = []
        for p, m in cases:
            (h,) = _drain(pre, [pre.submit(p, m)])
            (r,) = _drain(dec, [dec.submit_handoff(h)])
            got.append(np.asarray(r).tolist())
        assert pre._prefix.hit_tokens > 0  # prefill-side hit happened
        assert dec._prefix.hit_tokens > 0  # decode-side hit happened
        assert got == want
    finally:
        pre.close()
        dec.close()


def test_int8_wire_moves_at_least_3_5x_fewer_bytes(bundle):
    """fp32 ships 8·hidden bytes per token; int8 ships 2·hidden + 8
    (values + one fp32 scale per written K and V column): ≥3.5× for
    hidden ≥ 32 — the tier crossing inherits the pool's compression."""
    _, _, cfg, module = bundle
    assert cfg.hidden_size >= 32
    cases = _cases()
    h32, _ = _disaggregated(cfg, module, cases, kv_dtype="fp32")
    h8, _ = _disaggregated(cfg, module, cases, kv_dtype="int8")
    fp32_bytes = sum(h.wire_bytes for h in h32)
    int8_bytes = sum(h.wire_bytes for h in h8)
    assert fp32_bytes / int8_bytes >= 3.5


# -- wire codec ---------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["fp32", "int8", "bf16"])
def test_wire_codec_round_trips_exactly(bundle, dtype):
    _, _, cfg, module = bundle
    handoffs, got = _disaggregated(cfg, module, _cases(), kv_dtype=dtype)
    assert got == _colocated(cfg, module, _cases(), kv_dtype=dtype)
    for h in handoffs:
        h2 = KVHandoff.from_wire(h.to_wire())
        assert np.array_equal(h2.prompt, h.prompt)
        assert np.array_equal(h2.k, h.k) and h2.k.dtype == h.k.dtype
        assert np.array_equal(h2.v, h.v)
        if dtype == "int8":
            assert h2.k.dtype == np.int8
            assert np.array_equal(h2.k_scale, h.k_scale)
            assert np.array_equal(h2.v_scale, h.v_scale)
        else:
            assert h2.k_scale is None
        if dtype == "bf16":
            assert isinstance(h2.k, BF16Bits)
        assert h2.first_token == h.first_token
        assert h2.request_id == h.request_id
        assert h2.max_new_tokens == h.max_new_tokens


def test_wire_deadline_ships_as_remaining_seconds(bundle):
    """Absolute monotonic deadlines do not cross processes: the wire
    carries remaining seconds and re-anchors on arrival."""
    _, _, cfg, module = bundle
    pre = PrefillWorker(cfg, module, **_kw())
    try:
        (h,) = _drain(pre, [pre.submit([1, 2, 3], 4, timeout_s=60.0)])
        wire = h.to_wire()
        assert 0.0 < wire["remaining_s"] <= 60.0
        h2 = KVHandoff.from_wire(wire)
        assert h2.deadline is not None
        assert h2.deadline - time.monotonic() <= 60.0
    finally:
        pre.close()


# -- admission contracts ------------------------------------------------------

def test_decode_worker_rejects_mismatched_block_geometry(bundle):
    _, _, cfg, module = bundle
    pre = PrefillWorker(cfg, module, **_kw(kv_block_size=4))
    dec = DecodeWorker(cfg, module, **_kw(kv_block_size=8))
    try:
        (h,) = _drain(pre, [pre.submit([1, 2, 3, 4, 5], 4)])
        with pytest.raises(ValueError, match="block_size"):
            dec.submit_handoff(h)
    finally:
        pre.close()
        dec.close()


def test_decode_worker_rejects_impossible_spans(bundle):
    _, _, cfg, module = bundle
    pre = PrefillWorker(cfg, module, **_kw(max_len=64))
    dec = DecodeWorker(cfg, module, **_kw())
    try:
        (h,) = _drain(pre, [pre.submit(list(range(1, 39)), 8)])
        with pytest.raises(ValueError, match="max_len"):
            dec.submit_handoff(h)  # 38 + 8 > decode max_len 40
    finally:
        pre.close()
        dec.close()


def test_workers_require_paged_layout(bundle):
    _, _, cfg, module = bundle
    with pytest.raises(ValueError, match="paged"):
        PrefillWorker(cfg, module, **_kw(kv_layout="dense"))
    with pytest.raises(ValueError, match="paged"):
        DecodeWorker(cfg, module, **_kw(kv_layout="dense"))


def test_prefill_worker_reserves_prompt_blocks_only(bundle):
    """The prefill tier's admission budget is the PROMPT span: a pool
    the colocated engine would defer on (prompt + budget > pool)
    admits cleanly when only prompts need backing."""
    _, _, cfg, module = bundle
    # 16 prompt tokens / bs 4 = 4 blocks; + 24 new tokens would need 10
    pre = PrefillWorker(cfg, module, **_kw(n_slots=1, kv_blocks=5))
    try:
        prompt = list(range(1, 17))
        (h,) = _drain(pre, [pre.submit(prompt, 24)])
        assert isinstance(h, KVHandoff)
        assert h.n_blocks == 4
        assert h.max_new_tokens == 24
        assert pre._handoffs == 1
    finally:
        pre.close()
    # the colocated engine refuses the same request outright
    eng = ContinuousGPTEngine(cfg, module, **_kw(n_slots=1, kv_blocks=5))
    try:
        with pytest.raises(ValueError, match="can never fit"):
            eng.submit(prompt, 24)
    finally:
        eng.close()
