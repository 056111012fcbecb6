"""The port's ingest pipeline (sparkdl_torch/ingest/pipeline.py, a copy of
the JAX package's), after the JAX package's suite
(tests/ingest/test_ingest_pipeline.py): ordered parallel map,
deterministic interleave, bucketing batch, live-resizable prefetch, knob
lifecycle, and the conflicting-pin fail-loud contract; and the same
stage chain through both packages gives the same stream."""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest

import torch

from sparkdl_torch.ingest import AutoTuner, Pipeline
from sparkdl_torch.ingest.pipeline import resolve_pin
from sparkdl_torch.runtime.prefetch import DevicePut, PrefetchIterator
from sparkdl_tpu import ingest as jax_ingest


def test_map_preserves_order_at_any_parallelism():
    src = list(range(64))
    want = [x * 3 for x in src]
    for par in (1, 2, 8):
        got = list(Pipeline(src).map(lambda x: x * 3, parallelism=par))
        assert got == want


def test_map_parallel_calls_actually_overlap():
    gate = threading.Barrier(4, timeout=10)

    def fn(x):
        gate.wait()  # deadlocks unless 4 calls run concurrently
        return x

    got = list(Pipeline(range(8)).map(fn, parallelism=4))
    assert got == list(range(8))


def test_map_propagates_exceptions():
    def fn(x):
        if x == 3:
            raise RuntimeError("boom at 3")
        return x

    it = iter(Pipeline(range(8)).map(fn, parallelism=2))
    got = [next(it), next(it), next(it)]
    assert got == [0, 1, 2]
    with pytest.raises(RuntimeError, match="boom at 3"):
        next(it)


def test_interleave_round_robin_golden():
    got = list(Pipeline([[0, 1, 2], [10, 11], [20]])
               .interleave(lambda s: s, cycle=2))
    assert got == [0, 10, 1, 11, 2, 20]


def test_interleave_cycle_one_is_sequential():
    got = list(Pipeline([[0, 1], [2, 3]]).interleave(lambda s: s, cycle=1))
    assert got == [0, 1, 2, 3]


def test_batch_stage_buckets_like_rebatch():
    rows = [{"x": np.full((4,), float(i), np.float32)} for i in range(11)]
    got = list(Pipeline(iter(rows)).batch(4))
    assert [(b.n_valid, b.bucket) for b in got] == [(4, 4), (4, 4), (3, 4)]
    np.testing.assert_array_equal(
        got[0].arrays["x"][1], np.full((4,), 1.0, np.float32))


def test_prefetch_stage_values_and_close():
    p = Pipeline(range(10)).prefetch(3, transfer=lambda x: x * 2)
    assert list(p) == [x * 2 for x in range(10)]
    p.close()  # idempotent after exhaustion


def test_pipeline_is_one_shot():
    p = Pipeline(range(3)).apply(lambda x: x)
    assert list(p) == [0, 1, 2]
    with pytest.raises(RuntimeError, match="one-shot"):
        iter(p)


def test_composed_stages_end_to_end():
    rows = ({"x": np.full((2,), float(i), np.float32)} for i in range(9))
    pipe = (Pipeline(rows)
            .map(lambda r: {"x": r["x"] + 1.0}, parallelism=2)
            .batch(4)
            .apply(lambda b: b.arrays["x"][: b.n_valid]))
    got = np.concatenate(list(pipe))
    want = np.tile(np.arange(1.0, 10.0, dtype=np.float32)[:, None], (1, 2))
    np.testing.assert_array_equal(got, want)


# -- live depth resize ----------------------------------


def test_live_depth_resize_drops_nothing():
    n = 200
    release = threading.Event()

    def slowish():
        for i in range(n):
            yield i

    it = PrefetchIterator(slowish(), size=2, transfer=lambda x: x)
    got = [next(it), next(it)]
    assert it.depth == 2
    it.set_depth(16)  # grow live
    assert it.depth == 16
    deadline = time.monotonic() + 5
    while it._q.qsize() < 10 and time.monotonic() < deadline:
        time.sleep(0.005)  # producer runs further ahead under the new bound
    assert it._q.qsize() > 2, "grown depth never took effect"
    it.set_depth(1)  # shrink below current fill: staged items must survive
    got.extend(it)
    assert got == list(range(n)), "resize dropped or reordered staged batches"
    release.set()


def test_shrink_below_fill_keeps_staged_batches():
    it = PrefetchIterator(iter(range(8)), size=8, transfer=lambda x: x)
    deadline = time.monotonic() + 5
    while it._q.qsize() < 8 and time.monotonic() < deadline:
        time.sleep(0.005)
    it.set_depth(2)
    assert list(it) == list(range(8))


def test_buffer_fill_buckets_cover_autotuned_depths():
    from sparkdl_tpu.runtime.prefetch import _metrics

    fill = _metrics()[1]
    assert max(fill.bucket_bounds) >= 256


# -- knob lifecycle ---------------------------------------------------------


def test_knobs_register_and_unregister_with_the_stream():
    tuner = AutoTuner(clock=lambda: 0.0, signals=lambda: (0.0, 0.0))
    p = (Pipeline(range(8), name="knobtest")
         .map(lambda x: x, name="work")
         .prefetch(transfer=lambda x: x))
    p.autotune(tuner)
    it = iter(p)
    names = set(tuner.knobs)
    assert "knobtest.work_parallelism" in names
    assert "knobtest.prefetch_depth" in names
    assert list(it) == list(range(8))
    assert not tuner.knobs, "knobs leaked after exhaustion"


def test_explicit_stage_values_register_pinned():
    tuner = AutoTuner(clock=lambda: 0.0, signals=lambda: (0.0, 0.0))
    p = (Pipeline(range(4), name="pinit")
         .map(lambda x: x, parallelism=2, name="work")
         .prefetch(3, transfer=lambda x: x))
    p.autotune(tuner)
    it = iter(p)
    knobs = tuner.knobs
    assert knobs["pinit.work_parallelism"].pinned
    assert knobs["pinit.prefetch_depth"].pinned
    list(it)


def test_autotune_false_beats_env_opt_in(monkeypatch):
    monkeypatch.setenv("SPARKDL_TORCH_AUTOTUNE", "1")
    p = Pipeline(range(4)).prefetch(transfer=lambda x: x)
    p.autotune(False)
    assert p.tuner is None, "explicit opt-out must beat the env var"
    assert list(p) == [0, 1, 2, 3]


def test_prefetch_zero_disables_readahead():
    import threading

    before = {t.ident for t in threading.enumerate()}
    p = Pipeline(range(6)).prefetch(0, transfer=lambda x: x * 2)
    got = list(p)
    assert got == [0, 2, 4, 6, 8, 10]
    # strictly consumer-pulled: no producer thread was ever spawned
    spawned = [t for t in threading.enumerate()
               if t.ident not in before and t.name == "sparkdl-prefetch"]
    assert not spawned


def test_unregister_is_identity_checked():
    from sparkdl_torch.ingest import Knob

    tuner = AutoTuner(clock=lambda: 0.0, signals=lambda: (0.0, 0.0))
    first = Knob("shared.name", lambda: 1, lambda v: None, lo=1, hi=8)
    second = Knob("shared.name", lambda: 2, lambda v: None, lo=1, hi=8)
    tuner.register(first)
    tuner.register(second)  # a successor stream re-used the name
    tuner.unregister("shared.name", first)  # first stream closes late
    assert tuner.knobs.get("shared.name") is second, (
        "closing stream deregistered its successor's live knob")
    tuner.unregister("shared.name", second)
    assert not tuner.knobs


# -- conflicting pins fail loud ---------------------------------------------


def test_resolve_pin_conflict_raises(monkeypatch):
    monkeypatch.setenv("SPARKDL_TORCH_PREFETCH", "4")
    with pytest.raises(ValueError, match="conflicting pins"):
        resolve_pin(2, "SPARKDL_TORCH_PREFETCH", 2, what="prefetch")
    # agreeing pins are fine
    assert resolve_pin(4, "SPARKDL_TORCH_PREFETCH", 2, what="prefetch") == (
        4, True, "prefetch")
    # env alone pins
    assert resolve_pin(None, "SPARKDL_TORCH_PREFETCH", 2, what="prefetch") == (
        4, True, "SPARKDL_TORCH_PREFETCH")


def test_chainer_conflicting_pins_raise(monkeypatch):
    from sparkdl_torch.runtime.dispatch import ScanChainer

    monkeypatch.setenv("SPARKDL_TORCH_CHAIN_K", "8")
    with pytest.raises(ValueError, match="conflicting chain-K pins"):
        ScanChainer(lambda x: x + 1, path="t_conflict", chain_k=4)
    # agreeing pins construct fine, and record the env as resolved K
    ch = ScanChainer(lambda x: x + 1, path="t_conflict", chain_k=8)
    assert ch.chain_k == 8 and ch.pinned


def test_runner_prefetch_conflicting_pins_raise(monkeypatch):
    from sparkdl_torch.transformers._inference import BatchedRunner

    monkeypatch.setenv("SPARKDL_TORCH_PREFETCH", "2")
    with pytest.raises(ValueError, match="conflicting pins"):
        BatchedRunner(lambda b: torch.tanh(b["x"]), batch_size=4,
                      data_parallel=False, prefetch=4, device="cpu")
    r = BatchedRunner(lambda b: torch.tanh(b["x"]), batch_size=4,
                      data_parallel=False, prefetch=2, device="cpu")
    assert r._prefetch_depth == 2 and r._prefetch_pinned


def _composed(pkg, put):
    """rows -> map(x2, parallel) -> batch(4, buckets) -> arrays ->
    to_device: the runner's stage chain, in either package."""
    rows = [{"x": np.full((3,), float(i), np.float32)} for i in range(27)]
    pipe = (pkg.Pipeline(rows, name="t_vs")
            .map(lambda r: {"x": r["x"] * 2}, parallelism=3)
            .batch(4, (2, 4))
            .apply(lambda b: b.arrays)
            .to_device(put, depth=2, max_bucket=4))
    return [np.asarray(b["x"]) for b in pipe]


def test_composed_stream_matches_the_jax_pipeline():
    import jax

    mine = _composed(__import__("sparkdl_torch.ingest").ingest, DevicePut("cpu"))
    theirs = _composed(jax_ingest, jax.device_put)
    assert len(mine) == len(theirs) == 7
    for a, b in zip(mine, theirs):
        np.testing.assert_array_equal(a, b)
