"""The port's BatchedRunner over its feed (staging ring, chained dispatch,
async readback, the ingest pipeline and its autotuner), after the JAX
package's suite (tests/ingest/test_ported_parity.py): every runner setting
gives outputs BITWISE equal to the runner's own serial feed (prefetch=0,
chain_k=1, async_fetch=False) and to a plain oracle (rebatch + one eager
apply per batch) — the feed is a scheduling decision, never a numeric
one — and the same rows and the same apply function, written once in
numpy, give the JAX package's BatchedRunner's outputs bitwise. On the CPU
a chain is a plain loop; the card's graphs run in chip_smoke.py.
"""

from __future__ import annotations

import itertools
import threading

import numpy as np
import pytest
import torch

from sparkdl_torch.ingest import default_tuner
from sparkdl_torch.native import bridge
from sparkdl_torch.runtime.batching import rebatch
from sparkdl_torch.transformers._inference import BatchedRunner

SERIAL = dict(prefetch=0, chain_k=1, async_fetch=False)


def np_apply(x: np.ndarray) -> np.ndarray:
    """The apply function, once, in numpy: elementwise per row, so its
    bits cannot depend on how a BLAS blocks the batch."""
    return np.tanh(x[:, :5] * np.float32(1.5) + x[:, 3:]) * np.float32(0.5)


def apply_fn(b):
    return torch.from_numpy(np_apply(b["x"].numpy()))


def make_rows(n, seed=0):
    rng = np.random.default_rng(seed)
    return [{"x": rng.standard_normal(8).astype(np.float32)} for _ in range(n)]


def runner(**kw):
    return BatchedRunner(apply_fn, batch_size=8, device="cpu", **kw)


def oracle_outputs(rows, batch_size):
    """Plain bucketing rebatch, one eager apply per batch, unpad."""
    outs = []
    for b in rebatch(iter(rows), batch_size, None):
        outs.extend(np_apply(b.arrays["x"])[: b.n_valid])
    return outs


def _assert_bitwise(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("prefetch,chain_k,async_fetch",
                         list(itertools.product([0, 2], [1, 4], [False, True])))
@pytest.mark.parametrize("n_rows", [32, 27, 3])  # exact, ragged, one tail
def test_every_setting_is_bitwise_the_serial_feed(prefetch, chain_k,
                                                  async_fetch, n_rows):
    rows = make_rows(n_rows, seed=n_rows)
    serial = list(runner(**SERIAL).run(iter(rows)))
    _assert_bitwise(serial, oracle_outputs(rows, 8))
    r = runner(prefetch=prefetch, chain_k=chain_k, async_fetch=async_fetch)
    _assert_bitwise(list(r.run(iter(rows))), serial)
    _assert_bitwise(list(r.run(iter(rows))), serial)  # a second stream


@pytest.mark.parametrize("chain_k", [1, 4])
@pytest.mark.parametrize("n_rows", [32, 27])
def test_matches_the_jax_runner_bitwise(chain_k, n_rows):
    import jax

    from sparkdl_tpu.transformers._inference import BatchedRunner as JaxRunner

    def jax_apply(b):
        x = b["x"]
        return jax.pure_callback(
            np_apply, jax.ShapeDtypeStruct((x.shape[0], 5), np.float32), x)

    rows = make_rows(n_rows, seed=1)
    want = [np.asarray(o) for o in JaxRunner(
        jax_apply, batch_size=8, data_parallel=False,
        chain_k=chain_k).run(iter(rows))]
    _assert_bitwise(list(runner(chain_k=chain_k).run(iter(rows))), want)


def test_multikey_struct_feed_bitwise():
    rng = np.random.default_rng(3)
    rows = [{"a": rng.standard_normal(4).astype(np.float32),
             "b": rng.standard_normal(4).astype(np.float32),
             "n": np.int64(i)} for i in range(19)]

    def two_key(b):
        return b["a"] * 2.0 + b["b"] + b["n"][:, None].float()

    base = []
    for pb in rebatch(iter(rows), 8, None):
        t = {k: torch.from_numpy(v) for k, v in pb.arrays.items()}
        base.extend(two_key(t).numpy()[: pb.n_valid])
    before = bridge.FEED_STATS["ring_batches"]
    got = list(BatchedRunner(two_key, batch_size=8, device="cpu").run(iter(rows)))
    _assert_bitwise(got, base)
    assert bridge.FEED_STATS["ring_batches"] - before == 3  # one slot a batch


def test_tuple_outputs_per_row():
    def two(b):
        return b["x"].sum(dim=1), b["x"] * 2

    rows = make_rows(11)
    for kw in (SERIAL, {}):
        out = list(BatchedRunner(two, batch_size=4, device="cpu", **kw)
                   .run(iter(rows)))
        assert len(out) == 11 and all(isinstance(o, tuple) for o in out)
        np.testing.assert_array_equal(out[5][1], rows[5]["x"] * 2)


def test_outputs_own_their_memory():
    """Rows handed out early must not change when later batches land:
    every yielded array is its own batch's, never a reused buffer."""
    rows = make_rows(40, seed=4)
    r = runner()
    early = []
    for i, o in enumerate(r.run(iter(rows))):
        if i < 8:
            early.append((o, o.copy()))
    for o, snapshot in early:
        np.testing.assert_array_equal(o, snapshot)


def test_autotuned_stream_stays_bitwise():
    """A live tuner resizing knobs mid-stream must never change a single
    output bit — drive the knobs by hand while the stream is consumed."""
    rows = make_rows(64, seed=11)
    base = oracle_outputs(rows, 8)
    tuner = default_tuner()
    got = []
    for i, out in enumerate(runner(autotune=True).run(iter(rows))):
        got.append(out)
        if i % 8 == 0:
            for knob in list(tuner.knobs.values()):
                if not knob.pinned:
                    knob.set(min(knob.hi, max(knob.lo, 4 if i < 32 else 1)))
    tuner.stop()
    _assert_bitwise(got, base)


def test_pinned_knobs_not_tunable():
    tuner = default_tuner()
    r = runner(prefetch=3, chain_k=2, autotune=True)
    gate = threading.Event()

    def rows_gen():
        # keep the stream open past the knob inspection
        rng = np.random.default_rng(5)
        while not gate.is_set():
            yield {"x": rng.standard_normal(8).astype(np.float32)}

    stream = r.run(rows_gen())
    out = [next(stream)]
    seen = {name: knob.pinned for name, knob in tuner.knobs.items()}
    gate.set()
    out.extend(stream)
    tuner.stop()
    chain = [v for k, v in seen.items() if k.endswith(".chain_k")]
    assert chain and all(chain)
    staging = [v for k, v in seen.items() if ".device_" in k]
    assert staging and all(staging)
    assert len(out) >= 16


@pytest.mark.parametrize("n", [0, 1, 5, 8])
def test_run_batch_and_async_match_the_jax_runner(n):
    import jax

    from sparkdl_tpu.transformers._inference import BatchedRunner as JaxRunner

    def jax_apply(b):
        x = b["x"]
        return jax.pure_callback(
            np_apply, jax.ShapeDtypeStruct((x.shape[0], 5), np.float32), x)

    x = np.random.default_rng(n).standard_normal((n, 8)).astype(np.float32)
    want = np.asarray(JaxRunner(jax_apply, batch_size=8,
                                data_parallel=False).run_batch({"x": x}))
    r = runner()
    got = r.run_batch({"x": x})
    assert got.shape == (n, 5) == want.shape
    np.testing.assert_array_equal(got, want)
    res = r.run_batch_async({"x": x})
    assert res.result() is res.result()  # idempotent, memoized
    np.testing.assert_array_equal(res.result(), want)
    assert r.max_inflight_batches == 2 and r.chunk_size == 8
    assert runner(async_fetch=False).max_inflight_batches == 1


def test_serial_feed_starts_no_thread():
    before = {t.ident for t in threading.enumerate()}
    list(runner(**SERIAL).run(iter(make_rows(20))))
    assert not [t for t in threading.enumerate() if t.ident not in before
                and t.name.startswith("sparkdl")]


def test_fetch_window_and_feed_depth_follow_the_reference():
    assert runner()._feed_depth() == 8  # auto chain: the policy ceiling
    assert runner(chain_k=1)._feed_depth() == 2
    assert runner(chain_k=4, prefetch=1)._feed_depth() == 4
    assert runner(**SERIAL)._feed_depth() == 0
    assert runner()._fetch_window() == 16
    assert runner(chain_k=4)._fetch_window() == 8
    assert runner(fetch_window=3)._fetch_window() == 3
    with pytest.raises(ValueError, match="fetch_window"):
        runner(fetch_window=0)


@pytest.mark.parametrize("kw", [dict(data_parallel=True),
                                dict(partitioner=object())])
def test_placement_options_are_not_ported(kw):
    """Placement over several devices is ported (tests/
    test_torch_inference_dp.py): ``data_parallel=True`` with ``device=``
    pinned to one device raises the reference's error, and a partitioner
    that is not a placement of this process is refused."""
    err, match = ((ValueError, "pins this runner to one device")
                  if "data_parallel" in kw
                  else (TypeError, "SingleDevicePartitioner or a "
                        "LocalDevicePartitioner"))
    with pytest.raises(err, match=match):
        runner(**kw)


def test_source_error_surfaces_after_earlier_rows():
    def rows():
        yield from make_rows(20)
        raise ValueError("source died")

    want = oracle_outputs(make_rows(20), 8)
    for kw, n in ((SERIAL, 16), (dict(chain_k=1), 16), (dict(chain_k=4), 0)):
        got = []
        with pytest.raises(ValueError, match="source died"):
            for o in runner(**kw).run(rows()):
                got.append(o)
        # the full batches dispatched before the failing pull come out
        # first (a chain still waiting for members is not dispatched)
        assert len(got) == n
        _assert_bitwise(got, want[:n])


def test_abandoned_stream_leaks_no_thread():
    r = runner()
    stream = r.run(iter(make_rows(200)))
    next(stream)
    stream.close()
    for t in threading.enumerate():
        if t.name.startswith("sparkdl-ring") or t.name == "sparkdl-prefetch":
            t.join(timeout=5.0)
            assert not t.is_alive(), t.name


# -- the hot path traverses the staging ring (after the JAX package's
# tests/native/test_bridge_integration.py) -----------------------------------


@pytest.fixture
def feed_stats():
    return dict(bridge.FEED_STATS)


def test_single_tensor_feed_rides_the_ring(feed_stats):
    r = BatchedRunner(lambda b: b["x"].float().sum(dim=(1, 2, 3)),
                      batch_size=8, device="cpu")
    rows = ({"x": np.full((4, 4, 3), i, np.uint8)} for i in range(19))
    out = list(r.run(rows))
    assert len(out) == 19
    np.testing.assert_allclose(out[3], 3 * 48.0)
    assert bridge.FEED_STATS["ring_streams"] == feed_stats["ring_streams"] + 1
    # 19 rows at batch 8 -> batches of 8, 8, 3 (padded to its bucket)
    assert bridge.FEED_STATS["ring_batches"] == feed_stats["ring_batches"] + 3
    assert bridge.FEED_STATS["ring_bytes"] > feed_stats["ring_bytes"]


def test_ragged_feed_uses_python_fallback(feed_stats):
    r = BatchedRunner(lambda b: b["a"].float(), batch_size=4, device="cpu",
                      ragged_rows=True)
    out = list(r.run({"a": np.ones(3, np.float32)} for _ in range(6)))
    assert len(out) == 6
    # ragged feeds keep to the Python path: stream count unchanged
    assert bridge.FEED_STATS["ring_streams"] == feed_stats["ring_streams"]


def test_without_the_library_the_prefetcher_carries_it(feed_stats, monkeypatch):
    monkeypatch.setattr(bridge, "native_available", lambda: False)
    rows = make_rows(21, seed=9)
    got = list(runner().run(iter(rows)))
    _assert_bitwise(got, oracle_outputs(rows, 8))
    assert bridge.FEED_STATS["ring_streams"] == feed_stats["ring_streams"]
