"""The port's serving fault sites that no other port test arms:
``kv_pool.resize``, ``kv.quantize``, ``spec.verify``,
``tenant.preempt`` and ``autoscale.decide``. Each holds the reference's chaos contract, side by
side with the JAX package under the same plan where an engine runs:
nothing lost, tokens equal, the failure counted and recorded.
"""

import threading

import numpy as np
import pytest
from torch_parity import gpt_pair

from sparkdl_torch.observability.flight import flight_recorder
from sparkdl_torch.reliability.faults import inject
from sparkdl_torch.serving import ContinuousGPTEngine as TorchEngine
from sparkdl_torch.serving.kv_blocks import KVBlockPool
from sparkdl_tpu.reliability.faults import inject as jax_inject
from sparkdl_tpu.serving import ContinuousGPTEngine as JaxEngine
from sparkdl_tpu.serving.kv_blocks import KVBlockPool as JaxPool

CASES = [([5, 3, 9, 2, 7, 11, 4, 8, 1, 6], 6), ([5, 3, 9, 2, 7, 11], 5),
         ([6, 8, 6], 4)]


@pytest.fixture(scope="module")
def pair():
    jm, variables, tm = gpt_pair(0)
    return jm.config, variables, tm.config, tm


def _engine(kind, pair, **kw):
    jcfg, variables, tcfg, module = pair
    kw.setdefault("n_slots", 2)
    kw.setdefault("max_len", 48)
    kw.setdefault("auto_start", False)
    if kind == "jax":
        return JaxEngine(jcfg, variables, **kw)
    return TorchEngine(tcfg, module, device="cpu", **kw)


def _drive(eng, cases):
    futs = [eng.submit(p, n) for p, n in cases]
    while not all(f.done() for f in futs):
        eng.tick()
    return [f.result(timeout=0).tolist() for f in futs]


def test_pool_resize_is_a_fault_site_as_in_the_reference():
    for pool_cls, arm in ((KVBlockPool, inject), (JaxPool, jax_inject)):
        p = pool_cls(8, 4)
        with arm("kv_pool.resize:OSError@1"):
            with pytest.raises(OSError):
                p.shrink(2)
        # the injected fault aborted BEFORE any bookkeeping moved
        assert (p.spare_count, p.free_count) == (0, 8)
        with arm("kv_pool.resize:OSError@2"):
            assert p.shrink(2) == 2  # hit 1 passes
            with pytest.raises(OSError):
                p.grow(2)  # hit 2 injected
        assert p.spare_count == 2


def test_kv_quantize_fault_fails_the_compressed_build_only(pair):
    with inject("kv.quantize:RuntimeError@1"):
        with pytest.raises(RuntimeError, match="kv.quantize"):
            _engine("torch", pair, kv_block_size=4, kv_dtype="int8")
        _engine("torch", pair, kv_block_size=4).close()  # fp32: no hit
    eng = _engine("torch", pair, kv_block_size=4, kv_dtype="int8")
    got = _drive(eng, CASES[:1])
    eng.close()
    want = _drive(_engine("jax", pair, kv_block_size=4, kv_dtype="int8"),
                  CASES[:1])
    assert got == want


def test_verify_fault_falls_back_to_plain_decode(pair):
    kw = dict(kv_block_size=4, spec_k=4)
    with jax_inject("spec.verify:RuntimeError@1*2"):
        jeng = _engine("jax", pair, **kw)
        want = _drive(jeng, CASES)
        jsnap = jeng.snapshot()["spec"]
        jeng.close()
    base = flight_recorder().events_total
    with inject("spec.verify:RuntimeError@1*2"):
        eng = _engine("torch", pair, **kw)
        got = _drive(eng, CASES)
        snap = eng.snapshot()["spec"]
        eng.close()
    assert got == want
    assert snap["fallbacks"] == jsnap["fallbacks"] == 2
    for key in ("proposed", "accepted", "dispatches", "tokens"):
        assert snap[key] == jsnap[key], key
    evs = [e for e in flight_recorder().events()
           if e["kind"] == "spec.verify_failed" and e["seq"] > base]
    assert len(evs) == 2


def test_preempt_fault_still_requeues_the_victim(pair):
    from sparkdl_torch.serving import PRIORITY_BACKGROUND

    long_prompt = [int(t) for t in
                   np.random.default_rng(5).integers(1, 100, 40)]
    kw = dict(kv_block_size=4, prefill_chunk=4)
    want = _drive(_engine("torch", pair, **kw),
                  [(long_prompt, 4), ([6, 8, 6], 4)])
    base = flight_recorder().events_total
    eng = _engine("torch", pair, n_slots=1, **kw)
    bg = eng.submit(long_prompt, 4, priority=PRIORITY_BACKGROUND)
    eng.tick()  # admitted, first chunk
    fg = eng.submit([6, 8, 6], 4)
    with inject("tenant.preempt:RuntimeError@1"):
        eng.tick()  # the preemption fails mid-teardown
    while not (bg.done() and fg.done()):
        eng.tick()
    eng.close()
    assert [bg.result().tolist(), fg.result().tolist()] == want
    evs = [e for e in flight_recorder().events()
           if e["kind"] == "tenant.preempt_failed" and e["seq"] > base]
    assert len(evs) == 1 and evs[0]["error"] == "RuntimeError"


def test_autoscale_decide_is_a_fault_site_as_in_the_reference():
    """The same counted plan defers the same decision pass in both
    packages: nothing moves on it, the next pass lands the move."""
    from sparkdl_torch.autoscale import AutoScaler, AutoscalePolicy
    from sparkdl_tpu.autoscale import AutoScaler as JaxScaler
    from sparkdl_tpu.autoscale import AutoscalePolicy as JaxPolicy

    runs = []
    for scaler_cls, policy_cls, pool_cls, arm in (
            (JaxScaler, JaxPolicy, JaxPool, jax_inject),
            (AutoScaler, AutoscalePolicy, KVBlockPool, inject)):
        pool = pool_cls(32, 4)
        sc = scaler_cls(kv_pool=pool, kv_lock=threading.Lock(),
                        signals=lambda: (0.0, 0.0),
                        policy=policy_cls(hysteresis=1, cooldown_ticks=0,
                                          kv_step_blocks=4))
        try:
            with arm("autoscale.decide:RuntimeError@2"):
                ticks = [(sc.tick(), sc.state, pool.spare_count)
                         for _ in range(3)]
        finally:
            sc.close()
        runs.append(ticks)
    assert runs[1] == runs[0]
    assert runs[1] == [(1, "ok", 4), (0, "deferred", 4), (1, "ok", 8)]
