"""The port's native staging bridge (sparkdl_torch/native), after the JAX
package's suites (tests/native/test_bridge.py, test_bridge_integration.py):
build, ring semantics, packing oracle, feeder end-to-end, the pure-Python
fallback path; and the port's own parts: the ring pool (a ring that ended
its stream cleanly serves the next one), errors raised on their own batch,
no thread left behind after an abandoned stream, and a CPU put that never
aliases a slot. Slot page-locking and the card's copies run in
chip_smoke.py."""

import threading
import time

import numpy as np
import pytest

import torch

from sparkdl_torch.native import _lib, bridge
from sparkdl_torch.native.bridge import (
    FEED_STATS,
    DeviceFeeder,
    StagingRing,
    native_available,
    pack_rows,
    u8_to_f32,
)
from sparkdl_torch.runtime.prefetch import DevicePut
from sparkdl_tpu.native import bridge as jax_bridge

CPU = DevicePut("cpu")


def test_native_library_builds():
    assert _lib.available(), "g++ is in the image; the bridge must build"


def test_ring_fifo_and_wraparound():
    with StagingRing(slot_bytes=64, n_slots=2) as ring:
        seen = []
        for batch_no in range(5):  # > n_slots: exercises recycling
            w = ring.acquire_write(timeout_s=1.0)
            assert w is not None
            ring.slot_view(w)[:8] = batch_no
            ring.commit_write(w, n_rows=batch_no + 1, used_bytes=8)
            r = ring.acquire_read(timeout_s=1.0)
            assert r is not None
            assert ring.slot_rows(r) == batch_no + 1
            seen.append(int(ring.slot_view(r)[0]))
            ring.release_read(r)
        assert seen == [0, 1, 2, 3, 4]


def test_ring_blocking_and_close():
    ring = StagingRing(slot_bytes=16, n_slots=1)
    w = ring.acquire_write()
    ring.commit_write(w, 1, 4)
    # no free slot now: a write acquire must time out
    assert ring.acquire_write(timeout_s=0.05) is None
    # reader drains, then close -> next read returns None with closed=True
    r = ring.acquire_read(timeout_s=1.0)
    ring.release_read(r)
    ring.close()
    assert ring.acquire_read(timeout_s=1.0) is None
    assert ring.closed
    ring.destroy()


def test_ring_cross_thread():
    ring = StagingRing(slot_bytes=1024, n_slots=3)
    n_batches, got = 50, []

    def producer():
        for i in range(n_batches):
            w = ring.acquire_write()
            view = ring.slot_view(w)
            view[:4] = np.frombuffer(np.int32(i).tobytes(), np.uint8)
            ring.commit_write(w, 1, 4)
        ring.close()

    t = threading.Thread(target=producer)
    t.start()
    while True:
        r = ring.acquire_read(timeout_s=2.0)
        if r is None:
            assert ring.closed
            break
        got.append(int(ring.slot_view(r)[:4].view(np.int32)[0]))
        ring.release_read(r)
    t.join()
    ring.destroy()
    assert got == list(range(n_batches))


def test_pack_rows_matches_numpy_stack():
    rng = np.random.default_rng(0)
    rows = [rng.integers(0, 255, 48, dtype=np.uint8) for _ in range(5)]
    packed = pack_rows(rows, bucket=8, row_stride=48)
    want = np.stack(rows + [rows[0]] * 3)
    np.testing.assert_array_equal(packed, want)


def test_pack_rows_zero_fills_short_rows():
    rows = [np.arange(10, dtype=np.uint8), np.arange(4, dtype=np.uint8)]
    packed = pack_rows(rows, row_stride=10)
    assert packed.shape == (2, 10)
    np.testing.assert_array_equal(packed[1, :4], np.arange(4))
    np.testing.assert_array_equal(packed[1, 4:], np.zeros(6, np.uint8))


def test_pack_rows_into_preallocated_out():
    rows = [np.full(8, i, np.uint8) for i in range(3)]
    out = np.zeros(4 * 8, np.uint8)
    view = pack_rows(rows, bucket=4, row_stride=8, out=out)
    assert view.base is out or view.base is not None
    np.testing.assert_array_equal(out.reshape(4, 8)[2], np.full(8, 2))
    np.testing.assert_array_equal(out.reshape(4, 8)[3], np.zeros(8))  # row 0 pad


def test_u8_to_f32():
    x = np.arange(256, dtype=np.uint8)
    got = u8_to_f32(x, scale=2.0 / 255.0, bias=-1.0)
    np.testing.assert_allclose(got, x.astype(np.float32) * 2 / 255 - 1, atol=1e-6)


def test_device_feeder_end_to_end():
    rng = np.random.default_rng(1)
    batches = [rng.standard_normal((4, 8)).astype(np.float32) for _ in range(7)]
    out = list(DeviceFeeder(iter(batches), n_slots=3, transfer=CPU))
    assert len(out) == 7
    for got, want in zip(out, batches):
        np.testing.assert_array_equal(np.asarray(got), want)


def test_device_feeder_ragged_leading_dim():
    batches = [np.ones((n, 4), np.float32) * n for n in (4, 2, 4, 1)]
    out = list(DeviceFeeder(iter(batches), max_batch_bytes=4 * 4 * 4,
                            transfer=CPU))
    assert [a.shape[0] for a in out] == [4, 2, 4, 1]


def test_device_feeder_oversized_batch_raises():
    batches = [np.ones((2, 2), np.float32), np.ones((64, 64), np.float32)]
    with pytest.raises(ValueError, match="exceeds its slot segment"):
        list(DeviceFeeder(iter(batches), transfer=CPU))


def test_device_feeder_python_fallback(monkeypatch):
    monkeypatch.setattr(bridge, "native_available", lambda: False)
    batches = [np.full((2, 3), i, np.float32) for i in range(4)]
    out = list(DeviceFeeder(iter(batches), transfer=CPU))
    assert len(out) == 4
    np.testing.assert_array_equal(np.asarray(out[3]), np.full((2, 3), 3))


def test_feeder_overlap_smoke():
    """Transfer thread must keep the stream ordered under slow consumers."""
    batches = [np.full((2,), i, np.float32) for i in range(10)]
    got = []
    for arr in DeviceFeeder(iter(batches), n_slots=2, transfer=CPU):
        time.sleep(0.005)  # slow consumer
        got.append(float(np.asarray(arr)[0]))
    assert got == [float(i) for i in range(10)]


def test_pack_rows_pad_only_c_call_zero_fills():
    """Direct C-ABI pad-only call (n_rows=0, pad_rows>0): must zero-fill,
    not read the empty srcs array (the Python wrapper rejects empty rows,
    but the exported symbol has its own contract)."""
    import ctypes

    l = _lib.lib()
    if l is None:
        pytest.skip("native library unavailable")
    stride, pad = 16, 4
    dst = np.full(pad * stride, 0xAB, np.uint8)
    l.sdl_pack_rows(
        dst.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        None, None, 0, pad, 0, stride, 2,
    )
    assert not dst.any()


def test_device_feeder_single_slot_python_fallback_bounded(monkeypatch):
    """n_slots=1 on the fallback path must keep the prefetch queue bounded
    (maxsize>=1), not unbounded (maxsize=0)."""
    monkeypatch.setattr(bridge, "native_available", lambda: False)
    batches = [np.full((4,), i, np.float32) for i in range(6)]
    feeder = DeviceFeeder(iter(batches), n_slots=1, transfer=CPU)
    got = [np.asarray(b) for b in feeder]
    assert len(got) == 6
    np.testing.assert_array_equal(got[3], batches[3])


@pytest.fixture
def clean_pool():
    """An empty ring pool: streams of earlier tests left unfinished end
    (and may return their rings) when collected, so collect first."""
    import gc

    gc.collect()
    bridge.release_pooled_rings()
    yield
    bridge.release_pooled_rings()


def _feeder_threads():
    return [t for t in threading.enumerate()
            if t.name.startswith("sparkdl-ring")]


def _join_feeder_threads(timeout=5.0):
    for t in _feeder_threads():
        t.join(timeout)
    return [t for t in _feeder_threads() if t.is_alive()]


@pytest.mark.parametrize("n_slots", [1, 2, 3, 5])
def test_struct_feed_order_and_values_match_the_jax_feeder(n_slots):
    """A struct-of-tensors feed with a ragged last batch through both
    feeders: the same batches, in order, bit for bit."""
    import jax

    rng = np.random.default_rng(n_slots)
    batches = [{"ids": rng.integers(0, 99, (n, 6)).astype(np.int64),
                "mask": (rng.random((n, 6)) > 0.5).astype(np.float32)}
               for n in (4, 4, 4, 2)]
    seg = {"ids": 4 * 6 * 8, "mask": 4 * 6 * 4}
    mine = [{k: v.numpy() for k, v in d.items()} for d in DeviceFeeder(
        iter(batches), n_slots=n_slots, max_batch_bytes=seg, transfer=CPU)]
    theirs = [{k: np.asarray(v) for k, v in d.items()}
              for d in jax_bridge.DeviceFeeder(
                  iter(batches), n_slots=n_slots, max_batch_bytes=seg,
                  transfer=jax.device_put)]
    assert len(mine) == len(theirs) == 4
    for a, b, want in zip(mine, theirs, batches):
        for k in want:
            assert a[k].dtype == want[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
            np.testing.assert_array_equal(a[k], want[k])


def test_cpu_put_never_aliases_a_slot():
    """On the CPU the put would share the slot's memory: the transfer
    thread copies out of the slot before it releases it, so every batch
    keeps its values after the slot is reused."""
    batches = [np.full((3, 5), i, np.float32) for i in range(9)]
    out = list(DeviceFeeder(iter(batches), n_slots=2, transfer=CPU))
    for i, t in enumerate(out):
        assert isinstance(t, torch.Tensor)
        np.testing.assert_array_equal(t.numpy(), batches[i])


def test_slots_recycle_and_a_clean_stream_returns_its_ring(clean_pool):
    batches = [np.full((4, 7), i, np.float32) for i in range(11)]
    streams, reused = FEED_STATS["ring_streams"], FEED_STATS["ring_reused"]
    for _ in range(3):
        got = [t.numpy() for t in DeviceFeeder(iter(batches), n_slots=2,
                                               transfer=CPU)]
        assert len(got) == 11
        np.testing.assert_array_equal(got[10], batches[10])
    assert FEED_STATS["ring_streams"] - streams == 3
    assert FEED_STATS["ring_reused"] - reused == 2  # one ring, three streams
    assert len(bridge._POOL) == 1


def test_pool_keeps_at_most_two_idle_rings(clean_pool):
    for width in (3, 5, 7, 9):
        list(DeviceFeeder(iter([np.ones((2, width), np.float32)] * 3),
                          transfer=CPU))
    assert [r.slot_bytes for r in bridge._POOL] == [2 * 7 * 4, 2 * 9 * 4]


@pytest.mark.parametrize("fail_at", [0, 3, 6])
def test_source_error_raises_after_its_predecessors(fail_at, clean_pool):
    """A batch source that fails at batch i: batches 0..i-1 come out,
    then the error — and the dirty ring is freed, not pooled."""
    def source():
        for i in range(8):
            if i == fail_at and i:
                raise RuntimeError(f"source died at {i}")
            yield np.full((2, 4), i, np.float32)

    got = []
    if fail_at == 0:
        # a failing transfer instead: the error rides its own batch too
        def bad_put(x):
            if float(x[0, 0]) == 2.0:
                raise RuntimeError("put failed at 2")
            return CPU(x)

        with pytest.raises(RuntimeError, match="put failed at 2"):
            for t in DeviceFeeder(source(), n_slots=3, transfer=bad_put):
                got.append(float(t[0, 0]))
        assert got == [0.0, 1.0]
    else:
        with pytest.raises(RuntimeError, match=f"source died at {fail_at}"):
            for t in DeviceFeeder(source(), n_slots=3, transfer=CPU):
                got.append(float(t[0, 0]))
        assert got == [float(i) for i in range(fail_at)]
    assert not bridge._POOL
    assert not _join_feeder_threads()


def test_abandoned_stream_leaves_no_thread_and_no_pooled_ring(
        clean_pool, monkeypatch):
    taken = []
    real_take = bridge._take_ring

    def take(*a):
        taken.append(real_take(*a))
        return taken[-1]

    monkeypatch.setattr(bridge, "_take_ring", take)

    def endless():
        i = 0
        while True:
            yield np.full((2, 4), i, np.float32)
            i += 1

    it = iter(DeviceFeeder(endless(), n_slots=3, transfer=CPU))
    assert float(next(it)[0, 0]) == 0.0
    assert float(next(it)[0, 0]) == 1.0
    it.close()  # the consumer walks away mid-stream
    assert not _join_feeder_threads(), "feeder threads leaked"
    assert len(taken) == 1
    assert all(r is not taken[0] for r in bridge._POOL), \
        "a ring left mid-stream must not be reused"


def test_opaque_transfer_gets_a_copy_of_the_slot():
    """A transfer that keeps the host memory it is given (here: as is)
    must get its own copy, never the slot."""
    batches = [np.full((2, 3), i, np.float32) for i in range(6)]
    kept = list(DeviceFeeder(iter(batches), n_slots=2, transfer=lambda x: x))
    for i, a in enumerate(kept):
        np.testing.assert_array_equal(a, batches[i])


def test_tuned_knobs_keep_the_feed_bitwise():
    batches = [{"x": np.full((4, 6), float(i), np.float32)} for i in range(12)]
    bridge.set_tuned_ring_slots(5)
    bridge.set_tuned_pack_threads(2)
    try:
        from sparkdl_torch.ingest import Pipeline

        pipe = Pipeline(iter(batches)).to_device(CPU, depth=2, max_bucket=4)
        got = [d["x"].numpy() for d in pipe]
    finally:
        bridge.set_tuned_ring_slots(None)
        bridge.set_tuned_pack_threads(None)
    assert len(got) == 12
    for g, b in zip(got, batches):
        np.testing.assert_array_equal(g, b["x"])


def test_tuned_ring_slot_suggestion_applies_next_stream(monkeypatch):
    seen = {}
    real = bridge.DeviceFeeder

    class Spy(real):
        def __init__(self, batches, *, n_slots=3, **kw):
            seen["n_slots"] = n_slots
            super().__init__(batches, n_slots=n_slots, **kw)

    monkeypatch.setattr(bridge, "DeviceFeeder", Spy)
    bridge.set_tuned_ring_slots(7)
    try:
        from sparkdl_torch.ingest import Pipeline

        batches = [{"x": np.ones((2, 3), np.float32)} for _ in range(3)]
        list(Pipeline(iter(batches)).to_device(CPU, depth=2, max_bucket=2))
    finally:
        bridge.set_tuned_ring_slots(None)
    assert seen.get("n_slots") == 7


@pytest.mark.parametrize("n,stride,bucket", [(5, 48, 8), (3, 10, 3), (1, 7, 4)])
def test_pack_rows_matches_the_jax_bridge(n, stride, bucket):
    rng = np.random.default_rng(n)
    rows = [rng.integers(0, 255, rng.integers(1, stride + 1), dtype=np.uint8)
            for _ in range(n)]
    np.testing.assert_array_equal(
        pack_rows(rows, bucket=bucket, row_stride=stride),
        jax_bridge.pack_rows(rows, bucket=bucket, row_stride=stride))


def test_library_builds_into_the_ports_build_dir():
    import os

    path = _lib.BRIDGE.path()
    assert os.path.dirname(path).endswith(os.path.join("sparkdl_torch", "_build"))
    assert os.path.exists(path)


def test_a_foreign_build_is_rebuilt_here(tmp_path):
    """A library file that does not load (here: not a library at all; on
    a card's machine, a build copied from a host with another libjpeg) is
    built anew on this host and loaded."""
    import os

    lib = _lib.NativeLib("sdlbridgeprobe", "sdl_bridge.cc", _lib._declare_bridge)
    path = lib.path()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        f.write(b"not a shared library")
    try:
        assert lib.lib() is not None and lib.build_error is None
        with open(path, "rb") as f:
            assert f.read(4) == b"\x7fELF"
    finally:
        os.unlink(path)
