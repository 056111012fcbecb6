"""Data-parallel inference in one process (``BatchedRunner`` over a
``LocalDevicePartitioner``): the port of
``tests/transformers/test_inference_dp.py``, case for case.

The reference's virtual 8-device CPU mesh becomes a placement over
``["cpu"] * n``: each "device" runs its own replica of the apply function
with its own chainer, a batch's rows split into contiguous shards, the
outputs merged in order. On the CPU every shard's output is bitwise the
one-device runner's (the same operations on the same rows). The
featurizer rides the placement through its own per-device builder and is
held to the JAX featurizer on the same weights.
"""

import types

import numpy as np
import pytest
import torch

from sparkdl_torch.partition import LocalDevicePartitioner
from sparkdl_torch.transformers._inference import BatchedRunner


def _rows(n, d=6, seed=0):
    rng = np.random.default_rng(seed)
    return [{"x": rng.standard_normal(d).astype(np.float32)} for _ in range(n)]


def apply_fn(batch):
    return batch["x"] * 2.0 + 1.0


def _dp(n, **kw):
    return BatchedRunner(apply_fn, partitioner=LocalDevicePartitioner(["cpu"] * n), **kw)


def _placement(monkeypatch, **kw):
    """The devices ``BatchedRunner`` would resolve for these fields, on a
    host whose cards are named but absent (``resolve_device`` passes
    ``cuda`` through)."""
    from sparkdl_torch.transformers import _inference

    monkeypatch.setattr(_inference, "resolve_device", torch.device)
    fields = dict(partitioner=None, device="cuda", data_parallel=None,
                  batch_size=8, replicate=None)
    fields.update(kw)
    return BatchedRunner._placement(types.SimpleNamespace(**fields))


def test_auto_dp_shards_batches_over_local_devices():
    runner = _dp(8, batch_size=32)
    assert len(runner.devices) == 8
    # every staged batch is split over the devices, 4 rows each, in order
    batch = {"x": np.arange(32 * 6, dtype=np.float32).reshape(32, 6)}
    staged = runner._put()(batch)
    assert len(staged) == 8
    for i, part in enumerate(staged):
        assert torch.equal(part["x"], torch.from_numpy(batch["x"][4 * i:4 * (i + 1)]))
    # each replica's apply saw its shard: the step ran once per device
    seen = []
    r = BatchedRunner(lambda b: seen.append(b["x"].shape[0]) or b["x"],
                      batch_size=32, partitioner=LocalDevicePartitioner(["cpu"] * 8))
    list(r.run(iter(_rows(32))))
    assert seen == [4] * 8


def test_dp_output_equals_single_device():
    rows = _rows(45)  # ragged tail: 45 = 32 + 13
    for kw in (dict(), dict(prefetch=0, chain_k=1), dict(chain_k=4),
               dict(async_fetch=False)):
        dp = _dp(4, batch_size=32, **kw)
        single = BatchedRunner(apply_fn, batch_size=32, device="cpu", **kw)
        got = np.stack(list(dp.run(iter(rows))))
        want = np.stack(list(single.run(iter(rows))))
        np.testing.assert_array_equal(got, want)
        assert got.shape == (45, 6)
    x = np.stack([r["x"] for r in rows[:13]])
    np.testing.assert_array_equal(_dp(4, batch_size=32).run_batch({"x": x}),
                                  apply_fn({"x": x}))


def test_dp_buckets_divide_device_count(monkeypatch):
    runner = _dp(8, batch_size=50)
    n = len(runner.devices)
    # the chunk rounds DOWN to a device multiple (never above the caller's
    # memory ask) while batch_size stays what was configured
    assert runner.batch_size == 50
    assert runner.chunk_size == 48
    assert all(b % n == 0 for b in runner._buckets)
    assert max(runner._buckets) == 48
    # the auto path: tiny batch sizes shrink the placement rather than
    # over-padding (an explicit one below batch_size raises)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    make = lambda dev: apply_fn  # noqa: E731
    assert [d.index for d in _placement(monkeypatch, batch_size=2, replicate=make)] == [0, 1]
    assert len(_placement(monkeypatch, batch_size=50, replicate=make)) == 8
    with pytest.raises(ValueError, match="smaller than the partitioner's 8-way"):
        _dp(8, batch_size=2)


def test_dp_true_requires_multiple_devices(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="one local device"):
        BatchedRunner(apply_fn, batch_size=8, data_parallel=True)
    # auto silently falls back to the exact single-card behavior
    assert [str(d) for d in _placement(monkeypatch, replicate=lambda d: apply_fn)] == ["cuda"]
    # and so do a runner pinned to one device, and one without replicate=
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    assert [str(d) for d in _placement(monkeypatch, device="cuda:1")] == ["cuda:1"]
    assert [str(d) for d in _placement(monkeypatch)] == ["cuda"]
    with pytest.raises(ValueError, match="needs replicate="):
        BatchedRunner(apply_fn, batch_size=8, data_parallel=True)
    # the reference's errors for data_parallel=True with device=/partitioner=
    with pytest.raises(ValueError, match="pins this runner to one device"):
        BatchedRunner(apply_fn, batch_size=8, data_parallel=True, device="cpu")
    with pytest.raises(ValueError, match="partitioner= owns placement"):
        _dp(2, data_parallel=True)


def test_dp_true_rejects_unshardable_batch(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    with pytest.raises(ValueError, match="nothing to shard"):
        BatchedRunner(apply_fn, batch_size=1, data_parallel=True)
    # auto: a batch of 1 silently stays on one device
    assert len(_placement(monkeypatch, batch_size=1, replicate=lambda d: apply_fn)) == 1


def test_dp_non_multiple_batch_size_end_to_end():
    """batch_size not a multiple of the device count (50 on 8 devices,
    chunks of 48): ragged row counts flow through the ring feed without
    slot-segment overflows and the outputs are exact."""
    runner = _dp(8, batch_size=50)
    rows = _rows(100, seed=3)
    out = np.stack(list(runner.run(iter(rows))))
    want = np.stack([r["x"] * 2.0 + 1.0 for r in rows])
    np.testing.assert_allclose(out, want, rtol=1e-6)


def test_dp_struct_feed_through_ring():
    """Multi-tensor (text-style) dict feeds ride the native ring with the
    batch split: every key of a staged batch lands split over the
    devices, and the outputs match the single-device path."""
    from sparkdl_torch.native.bridge import FEED_STATS, native_available

    def apply(batch):
        return (batch["input_ids"].float() * 2.0
                + batch["attention_mask"].float())

    rng_ = np.random.default_rng(9)
    rows = [
        {"input_ids": rng_.integers(0, 100, 12).astype(np.int32),
         "attention_mask": np.ones(12, np.int32)}
        for _ in range(40)
    ]
    before = dict(FEED_STATS) if native_available() else {}
    dp = BatchedRunner(apply, batch_size=16,
                       partitioner=LocalDevicePartitioner(["cpu"] * 4))
    sd = BatchedRunner(apply, batch_size=16, device="cpu")
    got = np.stack(list(dp.run(iter(rows))))
    want = np.stack(list(sd.run(iter(rows))))
    np.testing.assert_array_equal(got, want)
    if native_available():
        assert FEED_STATS["ring_batches"] > before.get("ring_batches", 0)
    staged = dp._put()({"input_ids": np.zeros((16, 12), np.int32),
                        "attention_mask": np.ones((16, 12), np.int32)})
    for k in ("input_ids", "attention_mask"):
        assert [tuple(p[k].shape) for p in staged] == [(4, 12)] * 4, k


def test_featurizer_transform_rides_dp(monkeypatch):
    """DeepImageFeaturizer.transform() rides a 4-way placement through its
    own per-device builder, and its rows are the JAX featurizer's on the
    same weights (``torch_parity.named_image_parity``)."""
    from sparkdl_torch.transformers import named_image as torch_ni
    from torch_parity import named_image_parity

    made = []

    def placed_runner(apply, *, device, replicate, **kw):
        assert device == "cpu" and replicate is not None
        made.append(BatchedRunner(apply, replicate=replicate, **kw,
                                  partitioner=LocalDevicePartitioner([device] * 4)))
        return made[-1]

    monkeypatch.setattr(torch_ni, "BatchedRunner", placed_runner)
    named_image_parity(monkeypatch, "InceptionV3", "DeepImageFeaturizer")
    assert made and all(len(r.devices) == 4 and r.chunk_size == 4 for r in made)


def test_process_group_partitioner_is_refused():
    """A dp group's partitioner places a batch over ranks, not over this
    process's devices: each rank runs its own runner (ROADMAP C)."""
    from sparkdl_torch.partition import DataParallelPartitioner, make_mesh

    part = DataParallelPartitioner(make_mesh(dp=2, devices=[0, 1]), device="cpu")
    with pytest.raises(ValueError, match="Each rank of a dp group runs its own runner"):
        BatchedRunner(apply_fn, batch_size=8, partitioner=part)
