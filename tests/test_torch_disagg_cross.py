"""The port's disaggregated tiers against the JAX package's, on the same
tiny GPT weights: the port's split and colocated tokens equal the JAX
colocated engine's; a handoff either package wrote decodes in the other
bit for bit (int8 codes and scales, bf16 bit patterns); and a handoff
the JAX PrefillWorker exported installs in the port's DecodeWorker and
decodes to the JAX colocated engine's tokens.
"""

import json

import numpy as np
import pytest
from torch_parity import gpt_pair

from sparkdl_torch.disagg import DecodeWorker, KVHandoff, PrefillWorker
from sparkdl_torch.serving import ContinuousGPTEngine

MAX_LEN = 40
DTYPES = ("fp32", "int8", "bf16")


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
    sizes = ((7, 8), (12, 6), (17, 9))
    return [(rng.randint(0, 50, size=n).tolist(), m) for n, m in sizes]


def _tokens(results):
    return [np.asarray(r).tolist() for r in results]


@pytest.fixture(scope="module")
def jax_runs(bundle):
    """Per pool dtype, the JAX package's colocated tokens and its
    PrefillWorker's handoffs on the wire (its chained and speculative
    modes are bitwise its plain one, by its own suite)."""
    from sparkdl_tpu.disagg import PrefillWorker as JaxPrefill
    from sparkdl_tpu.serving import ContinuousGPTEngine as JaxEngine

    jcfg, variables, _, _ = bundle
    out = {}
    for dtype in ("fp32", "int8"):
        eng = JaxEngine(jcfg, variables, **_kw(kv_dtype=dtype))
        want = _tokens(_drain(eng, [eng.submit(p, m) for p, m in _cases()]))
        eng.close()
        pre = JaxPrefill(jcfg, variables, **_kw(kv_dtype=dtype))
        wires = [json.loads(json.dumps(h.to_wire())) for h in _drain(
            pre, [pre.submit(p, m) for p, m in _cases()])]
        pre.close()
        out[dtype] = want, wires
    return out


@pytest.mark.parametrize("dtype", ["fp32", "int8"])
@pytest.mark.parametrize("mode", [{}, {"chain_tokens": 4}, {"spec_k": 3}],
                         ids=["plain", "chained", "spec"])
def test_split_and_colocated_equal_the_jax_colocated_engine(
        bundle, jax_runs, dtype, mode):
    _, _, cfg, module = bundle
    want, _ = jax_runs[dtype]
    eng = ContinuousGPTEngine(cfg, module, **_kw(kv_dtype=dtype, **mode))
    colocated = _tokens(_drain(eng, [eng.submit(p, m)
                                     for p, m in _cases()]))
    eng.close()
    pre = PrefillWorker(cfg, module, **_kw(kv_dtype=dtype))
    dec = DecodeWorker(cfg, module, **_kw(kv_dtype=dtype, **mode))
    hs = _drain(pre, [pre.submit(p, m) for p, m in _cases()])
    split = _tokens(_drain(dec, [dec.submit_handoff(h) for h in hs]))
    pre.close()
    dec.close()
    assert colocated == want
    assert split == want


@pytest.mark.parametrize("dtype", ["fp32", "int8"])
def test_jax_prefill_handoff_installs_in_the_port(bundle, jax_runs, dtype):
    _, _, cfg, module = bundle
    want, wires = jax_runs[dtype]
    dec = DecodeWorker(cfg, module, **_kw(kv_dtype=dtype))
    try:
        got = _tokens(_drain(dec, [dec.submit_handoff(KVHandoff.from_wire(w))
                                   for w in wires]))
    finally:
        dec.close()
    assert got == want
    assert dec.snapshot()["disagg"]["installs"] == len(wires)


@pytest.mark.parametrize("dtype", DTYPES)
def test_port_handoffs_decode_bitwise_in_the_jax_package(bundle, dtype):
    from sparkdl_tpu.disagg.handoff import KVHandoff as JaxHandoff

    _, _, cfg, module = bundle
    pre = PrefillWorker(cfg, module, **_kw(kv_dtype=dtype))
    handoffs = _drain(pre, [pre.submit(p, m) for p, m in _cases()[:2]])
    pre.close()
    for h in handoffs:
        j = JaxHandoff.from_wire(json.loads(json.dumps(h.to_wire())))
        assert j.kv_dtype == dtype and j.first_token == h.first_token
        for name in ("k", "v", "k_scale", "v_scale"):
            mine, theirs = getattr(h, name), getattr(j, name)
            if mine is None:
                assert theirs is None
                continue
            assert theirs.dtype.name == (
                "bfloat16" if dtype == "bf16" and name in "kv"
                else mine.dtype.name)
            assert np.array_equal(
                np.asarray(theirs).view(np.uint8),
                np.asarray(mine).view(np.uint8)), name


def test_jax_bf16_handoff_decodes_bitwise_in_the_port(bundle):
    """The JAX package writes a bf16 pool's blocks as ml_dtypes bfloat16;
    the port reads them back as the same 16-bit patterns, and a
    DecodeWorker with a bf16 pool installs them to the blocks the port's
    own PrefillWorker exports for the same prompt."""
    import ml_dtypes

    from sparkdl_tpu.disagg.handoff import KVHandoff as JaxHandoff

    _, _, cfg, module = bundle
    prompt, max_new = _cases()[0]
    pre = PrefillWorker(cfg, module, **_kw(kv_dtype="bf16"))
    (mine,) = _drain(pre, [pre.submit(prompt, max_new)])
    pre.close()
    theirs = JaxHandoff(
        prompt=np.asarray(prompt, np.int32), max_new_tokens=max_new,
        first_token=mine.first_token, kv_dtype="bf16", block_size=4,
        k=np.asarray(mine.k).view(ml_dtypes.bfloat16),
        v=np.asarray(mine.v).view(ml_dtypes.bfloat16))
    got = KVHandoff.from_wire(json.loads(json.dumps(theirs.to_wire())))
    for name in ("k", "v"):
        assert np.array_equal(np.asarray(getattr(got, name)).view(np.uint16),
                              np.asarray(getattr(mine, name)).view(np.uint16))
    dec = DecodeWorker(cfg, module, **_kw(kv_dtype="bf16"))
    eng = ContinuousGPTEngine(cfg, module, **_kw(kv_dtype="bf16"))
    try:
        (split,) = _drain(dec, [dec.submit_handoff(got)])
        (want,) = _drain(eng, [eng.submit(prompt, max_new)])
    finally:
        dec.close()
        eng.close()
    assert np.asarray(split).tolist() == np.asarray(want).tolist()
