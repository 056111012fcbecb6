"""The port's fused dispatch (sparkdl_torch/runtime/dispatch.py), after the
JAX package's suite (tests/runtime/test_dispatch.py): chained-vs-unchained
parity is BITWISE — chaining is a dispatch decision, never a numeric one —
and the dispatch counter drops ~K-fold when chains form. On the CPU a
chain is a plain loop over the step; the CUDA graphs that carry it on the
card are checked by chip_smoke.py. ChainPolicy and SpecPolicy are copies:
their decisions must equal the JAX package's on the same signals.
"""

import numpy as np
import pytest
import torch

from sparkdl_torch.observability.registry import registry
from sparkdl_torch.ops import _dispatch
from sparkdl_torch.runtime.dispatch import (
    ChainPolicy,
    GraphCache,
    ScanChainer,
    SpecPolicy,
    calibrate_dispatch_gap,
    chain_carry,
    dispatch_count,
    optimizer_settings,
    overhead_share,
    require_capturable,
    shape_key,
    storage_key,
)
from sparkdl_torch.train.finetune import classification_train_step
from sparkdl_tpu.runtime import dispatch as jax_dispatch

W = torch.from_numpy(
    np.random.default_rng(7).standard_normal((16, 16)).astype(np.float32)) / 4.0


def _step(batch):
    return torch.tanh(batch["x"] @ W)


def _items(n, rows=8, seed=0):
    rng = np.random.default_rng(seed)
    return [{"x": torch.from_numpy(
        rng.standard_normal((rows, 16)).astype(np.float32))} for _ in range(n)]


@pytest.mark.parametrize("k", [1, 4, 8])
def test_map_stream_bitwise_parity(k):
    items = _items(16)
    want = [_step(x) for x in items]
    got = list(ScanChainer(_step, path="t_parity", chain_k=k)
               .map_stream(iter(items)))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.equal(g, w)  # bitwise, not allclose


def test_chain_dispatch_count_drops_k_fold():
    items = _items(16)
    before = dispatch_count("t_count")
    list(ScanChainer(_step, path="t_count", chain_k=8)
         .map_stream(iter(items)))
    assert dispatch_count("t_count") - before == 2  # 16 steps, K=8
    before = dispatch_count("t_count")
    list(ScanChainer(_step, path="t_count", chain_k=1)
         .map_stream(iter(items)))
    assert dispatch_count("t_count") - before == 16


def test_ragged_tail_runs_unchained():
    # 10 items at K=4: two chains + two single flushes = 4 dispatches
    items = _items(10)
    before = dispatch_count("t_tail")
    out = list(ScanChainer(_step, path="t_tail", chain_k=4)
               .map_stream(iter(items)))
    assert len(out) == 10
    assert dispatch_count("t_tail") - before == 4
    for got, item in zip(out, items):
        assert torch.equal(got, _step(item))


def test_shape_change_flushes_pending():
    # a smaller tail bucket mid-stream may not join the chain; order and
    # values must survive the flush
    items = _items(3) + _items(2, rows=4, seed=1) + _items(3, seed=2)
    chainer = ScanChainer(_step, path="t_shapes", chain_k=3)
    out = list(chainer.map_stream(iter(items)))
    assert [o.shape[0] for o in out] == [8, 8, 8, 4, 4, 8, 8, 8]
    for got, item in zip(out, items):
        assert torch.equal(got, _step(item))


def test_empty_stream_and_tuple_outputs():
    chainer = ScanChainer(_step, path="t_empty", chain_k=4)
    assert list(chainer.map_stream(iter(()))) == []

    def multi(batch):
        return batch["x"] + 1.0, batch["x"].sum(dim=-1)

    items = _items(4)
    out = list(ScanChainer(multi, path="t_multi", chain_k=4)
               .map_stream(iter(items)))
    for got, item in zip(out, items):
        want = multi(item)
        assert len(got) == 2
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_auto_policy_measures_then_chains():
    # a huge injected gap makes any program "cheap": the first dispatch
    # measures (K=1), every later group chains at max_chain
    policy = ChainPolicy(gap_s=10.0, max_chain=8)
    chainer = ScanChainer(_step, path="t_auto", chain_k=None, policy=policy)
    chainer.chain_k = None  # guard against SPARKDL_TORCH_CHAIN_K in env
    before = dispatch_count("t_auto")
    out = list(chainer.map_stream(iter(_items(9))))
    assert len(out) == 9
    assert policy.chain_len() == 8
    assert dispatch_count("t_auto") - before == 2  # 1 probe + one 8-chain


@pytest.mark.parametrize("k", [1, 3, 4])
@pytest.mark.parametrize("sizes", [(8,) * 10, (8,) * 5 + (4,) * 3 + (8,) * 2])
def test_dispatch_pattern_matches_the_jax_chainer(k, sizes):
    """The same stream through both chainers at the same pinned K: the
    same number of dispatches (the same grouping into chains)."""
    import jax

    w = W.numpy()
    items = [_items(1, rows=r, seed=i)[0] for i, r in enumerate(sizes)]
    b0 = dispatch_count("t_vs_torch")
    list(ScanChainer(_step, path="t_vs_torch", chain_k=k)
         .map_stream(iter(items)))
    a0 = jax_dispatch.dispatch_count("t_vs_jax")
    jit_items = [{"x": jax.device_put(i["x"].numpy())} for i in items]
    out = list(jax_dispatch.ScanChainer(
        lambda b: jax.numpy.tanh(b["x"] @ w), path="t_vs_jax",
        chain_k=k).map_stream(iter(jit_items)))
    assert len(out) == len(items)
    assert (dispatch_count("t_vs_torch") - b0
            == jax_dispatch.dispatch_count("t_vs_jax") - a0)


@pytest.mark.parametrize("gap", [1e-5, 1e-3, 2.4e-3])
@pytest.mark.parametrize("target", [0.02, 0.2])
@pytest.mark.parametrize("programs", [(), (1e-4,), (1e-3, 2e-3),
                                      (2e-4, 5e-5, 1e-2), (0.06,), (0.039, 0.038)])
def test_chain_policy_matches_the_jax_policy(gap, target, programs):
    mine = ChainPolicy(gap_s=gap, target_overhead=target, max_chain=32)
    theirs = jax_dispatch.ChainPolicy(gap_s=gap, target_overhead=target,
                                      max_chain=32)
    assert mine.chain_len() == theirs.chain_len()
    for i, p in enumerate(programs):
        k = 1 + i % 3
        mine.record(gap + k * p, k)
        theirs.record(gap + k * p, k)
        assert mine.chain_len() == theirs.chain_len()
        assert mine.program_s == theirs.program_s


@pytest.mark.parametrize("events", [[(4, 4)] * 6, [(8, 1)] * 40,
                                    [(4, 2), (2, 0), (8, 8)] * 5])
def test_spec_policy_matches_the_jax_policy(events):
    mine, theirs = SpecPolicy(), jax_dispatch.SpecPolicy()
    for proposed, accepted in events:
        assert mine.spec_len() == theirs.spec_len()
        mine.record(proposed, accepted)
        theirs.record(proposed, accepted)
    assert mine.rate == theirs.rate and mine.spec_len() == theirs.spec_len()


def test_chain_policy_bounds():
    p = ChainPolicy(gap_s=1e-3, target_overhead=0.02, max_chain=32)
    assert p.chain_len() == 1  # unmeasured: first dispatch probes
    p.record(1e-3 + 1e-4, 1)  # program ~100us against a 1ms gap
    k = p.chain_len()
    assert k == 32  # ideal K ~490, clamped
    assert k & (k - 1) == 0
    # long programs do not chain: overhead already amortized
    p2 = ChainPolicy(gap_s=2.4e-3)
    p2.record(0.2, 1)
    assert p2.chain_len() == 1
    # program comfortably over the gap/target ratio: modest power of two
    p3 = ChainPolicy(gap_s=1e-3, target_overhead=0.2, max_chain=32)
    p3.record(1e-3 + 1e-3, 1)  # program == gap
    assert p3.chain_len() == 4  # ideal 4.0 -> 4


def test_pinned_one_runs_eagerly_and_auto_would_capture():
    """chain_k=1 pinned turns graphs off (the eager parity reference);
    auto and K>1 keep them on for CUDA inputs."""
    assert not ScanChainer(_step, path="t_g", chain_k=1).graphs
    assert ScanChainer(_step, path="t_g", chain_k=4).graphs
    assert ScanChainer(_step, path="t_g", chain_k=None,
                       policy=ChainPolicy(gap_s=1e-5)).graphs
    # CPU inputs never capture
    ch = ScanChainer(_step, path="t_g", chain_k=4)
    list(ch.map_stream(iter(_items(8))))
    assert ch.graph_keys == []


def test_shape_key_groups_by_structure_shape_and_dtype():
    a = {"x": torch.zeros(4, 2), "m": torch.zeros(4, dtype=torch.int64)}
    assert shape_key(a) == shape_key({"x": torch.ones(4, 2),
                                      "m": torch.ones(4, dtype=torch.int64)})
    assert shape_key(a) != shape_key({"x": torch.zeros(8, 2),
                                      "m": torch.zeros(8, dtype=torch.int64)})
    assert shape_key(a) != shape_key({"x": torch.zeros(4, 2, dtype=torch.float64),
                                      "m": torch.zeros(4, dtype=torch.int64)})
    assert shape_key((torch.zeros(3),)) != shape_key([torch.zeros(3)])


def test_launch_counts_add_and_take_back():
    """The counts a graph replay adds: what the wrappers counted during
    the capture (launch_delta), taken back once and added per replay."""
    from sparkdl_torch.ops.stem_fused import inception_stem_fused

    inception_stem_fused.launches = 5
    before = _dispatch.launch_counts()
    inception_stem_fused.launches += 3
    delta = _dispatch.launch_delta(before, _dispatch.launch_counts())
    assert delta == {(inception_stem_fused, "launches"): 3}
    _dispatch.add_launches(delta, -1)
    assert inception_stem_fused.launches == 5
    _dispatch.add_launches(delta, 4)
    assert inception_stem_fused.launches == 17
    inception_stem_fused.launches = 0


def test_env_chain_k_rejects_values_below_one(monkeypatch):
    from sparkdl_torch.runtime.dispatch import default_chain_k

    monkeypatch.setenv("SPARKDL_TORCH_CHAIN_K", "0")
    with pytest.raises(ValueError, match="SPARKDL_TORCH_CHAIN_K"):
        default_chain_k()
    with pytest.raises(ValueError, match="SPARKDL_TORCH_CHAIN_K"):
        ScanChainer(_step, path="t_env", chain_k=None)
    monkeypatch.setenv("SPARKDL_TORCH_CHAIN_K", "4")
    assert ScanChainer(_step, path="t_env", chain_k=None).chain_k == 4
    with pytest.raises(ValueError, match="conflicting chain-K pins"):
        ScanChainer(_step, path="t_env", chain_k=2)
    monkeypatch.delenv("SPARKDL_TORCH_CHAIN_K")
    assert default_chain_k() is None


def test_calibrate_gap_env_override_and_cache(monkeypatch):
    monkeypatch.setenv("SPARKDL_TORCH_DISPATCH_GAP_MS", "2.5")
    assert calibrate_dispatch_gap() == pytest.approx(2.5e-3)
    monkeypatch.delenv("SPARKDL_TORCH_DISPATCH_GAP_MS")
    # refresh: other tests may have calibrated — this test owns its own
    g1 = calibrate_dispatch_gap(refresh=True, device="cpu")
    assert 0 < g1 < 0.1  # a CPU dispatch is microseconds
    assert calibrate_dispatch_gap(device="cpu") == g1  # cached per device
    gauge = registry().get("sparkdl_dispatch_gap_seconds")
    assert gauge is not None and gauge.snapshot_values()[""] == g1


def test_overhead_share():
    assert overhead_share(10, 1.0, gap_s=0.01) == pytest.approx(0.1)
    assert overhead_share(0, 1.0, gap_s=0.01) is None
    assert overhead_share(1000, 1.0, gap_s=0.01) == 1.0  # clamped


def test_chain_carry_matches_sequential_steps():
    """K carried-state steps through chain_carry equal the same steps one
    by one, bitwise: the state after every chain and each step's metric
    (the reference's scan test, in the port's in-place idiom)."""

    def make():
        state = {"w": torch.ones(4, 4)}

        def step(batch):
            state["w"].add_(batch["x"].sum() * 1e-3)
            return {"norm": state["w"].sum()}

        return state, step

    items = _items(6, rows=2, seed=3)
    s_ref, step = make()
    norms_ref = [step(x)["norm"].clone() for x in items]
    s_got, step = make()
    chained = chain_carry(step, donate=False)
    got = chained(items[:4]) + chained(items[4:]) + chained([])
    assert torch.equal(s_got["w"], s_ref["w"])
    assert [m["norm"] for m in got] == norms_ref
    assert all(torch.equal(m["norm"], w) for m, w in zip(got, norms_ref))


class _EagerGraph:
    """Stands in for a CapturedGraph where there is no card: a replay
    runs the function eagerly."""

    def __init__(self, fn):
        self.fn = fn
        self.replays = 0

    def replay(self, inputs, generator=None):
        self.replays += 1
        return self.fn(*inputs)


class _RecordingCache(GraphCache):
    """GraphCache with the warm-up and the capture replaced (no card
    here): what is left is the key, the LRU and the error path."""

    def __init__(self, *args, fail=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.captured = []
        self.fail = fail

    def _warm_up(self, fn, inputs, generator):
        return fn(*inputs)

    def _capture(self, fn, inputs, generator):
        if self.fail is not None:
            raise self.fail
        self.captured.append(shape_key(inputs))
        return _EagerGraph(fn)


def _add(x, y):
    return x + y


def test_graph_cache_captures_once_per_shape_and_dtype():
    cache = _RecordingCache("t_shape")
    a, b = torch.ones(4, 2), torch.ones(4, 2)
    for _ in range(3):
        assert torch.equal(cache(_add, (a, b)), a + b)
    assert cache.captures == 1 and len(cache) == 1
    assert cache.graphs()[0].replays == 2  # the first call was the warm-up
    cache(_add, (torch.ones(8, 2), torch.ones(8, 2)))  # new rows
    cache(_add, (a.double(), b.double()))  # new dtype
    cache(_add, (a, b))  # the first entry again: a replay
    assert cache.captures == 3 and len(cache) == 3
    assert [k for k, _ in cache.keys()][-1] == shape_key((a, b))


def test_graph_cache_new_entry_for_replaced_parameters_or_settings():
    """The key of a train step: replaced parameters (new storage) and a
    changed learning rate each mean a new capture; weights copied in
    place keep the graph."""
    model = torch.nn.Linear(16, 3)
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    step = classification_train_step(model, opt)
    batch = {"input": torch.ones(4, 16),
             "labels": torch.zeros(4, dtype=torch.long)}
    cache = _RecordingCache("t_key")

    def run():
        cache(lambda b: step(b), (batch,), step.graph_key())

    run()
    run()
    assert cache.captures == 1
    with torch.no_grad():
        model.weight.copy_(torch.zeros_like(model.weight))  # in place
    run()
    assert cache.captures == 1
    before = storage_key(model)
    model.weight = torch.nn.Parameter(torch.zeros(3, 16))
    assert storage_key(model) != before
    opt.param_groups[0]["params"][0] = model.weight
    run()
    assert cache.captures == 2
    opt.param_groups[0]["lr"] = 0.05
    assert optimizer_settings(opt) != optimizer_settings(
        torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9))
    run()
    assert cache.captures == 3


def test_graph_cache_lru_bound_evicts_the_least_recent():
    cache = _RecordingCache("t_lru", maxsize=2)
    shapes = [(1,), (2,), (3,)]
    for n in (1, 2, 1, 3):  # 1 is used again before 3 arrives: 2 goes
        cache(_add, (torch.ones(n), torch.ones(n)))
    assert len(cache) == 2 and cache.captures == 3
    assert [k[0][1][0][0] for k in cache.keys()] == [shapes[0], shapes[2]]
    cache(_add, (torch.ones(2), torch.ones(2)))  # evicted: captured anew
    assert cache.captures == 4 and len(cache) == 2
    with pytest.raises(ValueError, match="maxsize"):
        GraphCache("t_lru", maxsize=0)


def test_graph_cache_refuses_non_tensor_inputs():
    cache = _RecordingCache("t_scalar")
    with pytest.raises(ValueError, match="t_scalar.*tensor inputs only"):
        cache(_add, (torch.ones(2), 3.0))
    assert cache.captures == 0


def test_failed_capture_raises_naming_the_path_and_keeps_nothing():
    cache = _RecordingCache("t_fail", fail=RuntimeError("operation not "
                                                        "permitted"))
    with pytest.raises(RuntimeError,
                       match="CUDA graph of 't_fail' failed.*not permitted"):
        cache(_add, (torch.ones(2), torch.ones(2)))
    assert len(cache) == 0 and cache.captures == 0


def test_require_capturable_names_the_optimizer_and_the_path():
    params = [torch.nn.Parameter(torch.ones(2))]
    with pytest.raises(ValueError, match="'train'.*AdamW.*capturable=True"):
        require_capturable(torch.optim.AdamW(params), "train")
    require_capturable(torch.optim.AdamW(params, capturable=True), "train")
    require_capturable(torch.optim.SGD(params, lr=0.1, momentum=0.9), "train")


def test_no_gc_holds_the_collector_off_and_restores_it():
    """A graph capture runs with the cyclic collector off (a collection
    mid-capture can finalize a dropped runner whose CUDA calls invalidate
    the capture), and the collector's state is restored after, on an
    error too."""
    import gc

    from sparkdl_torch.runtime.dispatch import no_gc

    assert gc.isenabled()
    with no_gc():
        assert not gc.isenabled()
    assert gc.isenabled()
    with pytest.raises(KeyError):
        with no_gc():
            raise KeyError("boom")
    assert gc.isenabled()
    gc.disable()
    try:
        with no_gc():
            pass
        assert not gc.isenabled()  # left as the caller had it
    finally:
        gc.enable()


def test_no_gc_blocks_overlapping_across_threads_share_one_count():
    """Two threads' captures overlap: the collector stays off until the
    last block leaves, whichever entered first, then is restored."""
    import gc
    import threading

    from sparkdl_torch.runtime.dispatch import no_gc

    entered, second_entered, first_left = (threading.Event() for _ in range(3))
    seen = []

    def first():
        with no_gc():
            entered.set()
            assert second_entered.wait(10)
        first_left.set()

    def second():
        assert entered.wait(10)
        with no_gc():
            second_entered.set()
            assert first_left.wait(10)
            seen.append(gc.isenabled())  # the first has left; this one still captures

    assert gc.isenabled()
    threads = [threading.Thread(target=f) for f in (first, second)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(20)
    assert seen == [False]
    assert gc.isenabled()
