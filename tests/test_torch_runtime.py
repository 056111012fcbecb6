"""The port's JAX-free plumbing against the JAX package's: bucketed
batching, the batched runner, image structs, the DataFrame adapters and
the Param system. These are copies adapted for torch, so the same inputs
must give identical results (exact comparisons)."""

import numpy as np
import pytest
import torch

from sparkdl_torch.dataframe import LocalDataFrame, transform_partitions
from sparkdl_torch.image import imageIO as torch_io
from sparkdl_torch.runtime import batching as torch_batching
from sparkdl_torch.transformers._inference import (
    BatchedRunner,
    run_partition_with_passthrough,
)
from sparkdl_tpu.image import imageIO as jax_io
from sparkdl_tpu.runtime import batching as jax_batching


@pytest.mark.parametrize("max_batch", [1, 4, 8, 9, 64, 100])
def test_default_buckets_match_jax(max_batch):
    assert torch_batching.default_buckets(max_batch) == \
        jax_batching.default_buckets(max_batch)


@pytest.mark.parametrize("n", [0, 1, 3, 8, 13])
def test_pad_to_bucket_matches_jax(n):
    r = np.random.default_rng(n)
    arrays = {"img": r.random((n, 2, 3)).astype(np.float32),
              "ids": r.integers(0, 9, (n,))}
    buckets = (4, 8, 16)
    got = torch_batching.pad_to_bucket(arrays, buckets)
    want = jax_batching.pad_to_bucket(arrays, buckets)
    assert (got.n_valid, got.bucket) == (want.n_valid, want.bucket)
    for k in arrays:
        np.testing.assert_array_equal(got.arrays[k], want.arrays[k])


@pytest.mark.parametrize("n,batch", [(0, 4), (3, 2), (8, 4), (13, 8)])
def test_rebatch_matches_jax(n, batch):
    r = np.random.default_rng(100 + n)
    rows = [{"x": r.random(3).astype(np.float32)} for _ in range(n)]
    got = list(torch_batching.rebatch(iter(rows), batch))
    want = list(jax_batching.rebatch(iter(rows), batch))
    assert [(b.n_valid, b.bucket) for b in got] == \
        [(b.n_valid, b.bucket) for b in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.arrays["x"], w.arrays["x"])


def test_batched_runner_unpads_in_order():
    seen = []

    def apply_fn(batch):
        seen.append(tuple(batch["x"].shape))
        assert batch["x"].device.type == "cpu" and torch.is_inference_mode_enabled()
        return batch["x"].sum(dim=1), batch["x"] * 2

    runner = BatchedRunner(apply_fn, batch_size=4, device="cpu")
    rows = [{"x": np.full(3, i, np.float32)} for i in range(6)]
    out = list(runner.run(iter(rows)))
    assert seen == [(4, 3), (4, 3)]  # 4, then a tail of 2 padded to 4
    assert [float(s) for s, _ in out] == [3.0 * i for i in range(6)]
    s, d = runner.run_batch({"x": np.ones((3, 3), np.float32)})
    assert s.shape == (3,) and d.shape == (3, 3)
    with pytest.raises(RuntimeError, match="CUDA"):
        BatchedRunner(apply_fn, batch_size=4)  # default device is CUDA


def test_passthrough_keeps_bad_rows_as_none():
    runner = BatchedRunner(lambda b: b["x"] + 1, batch_size=2, device="cpu")

    def extract(row):
        if row["v"] < 0:
            raise ValueError("bad row")
        return {"x": np.float32([row["v"]])}

    rows = [{"v": 1.0}, {"v": -1.0}, {"v": 2.0}]
    out = list(run_partition_with_passthrough(rows, extract, runner, "o"))
    assert [None if r["o"] is None else float(r["o"][0]) for r in out] == \
        [2.0, None, 3.0]
    with pytest.raises(KeyError):
        list(run_partition_with_passthrough(rows, extract, runner, "o",
                                            input_cols=("missing",)))


@pytest.mark.parametrize("shape,dtype", [
    ((5, 4, 3), np.uint8), ((5, 4), np.uint8), ((3, 2, 4), np.uint8),
    ((5, 4, 3), np.float32), ((2, 2, 1), np.float64), ((2, 2, 3), np.int32)])
def test_image_structs_match_jax(shape, dtype):
    arr = (np.random.default_rng(1).random(shape) * 255).astype(dtype)
    got = torch_io.imageArrayToStructBGR(arr, origin="o")
    assert got == jax_io.imageArrayToStructBGR(arr, origin="o")
    np.testing.assert_array_equal(torch_io.imageStructToArray(got),
                                  jax_io.imageStructToArray(got))
    assert torch_io.undefined_image("u") == jax_io.undefined_image("u")


def test_pil_decode_matches_jax():
    import io

    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(np.random.default_rng(2).integers(
        0, 256, (6, 7, 3), dtype=np.uint8)).save(buf, format="PNG")
    raw = buf.getvalue()
    assert torch_io.PIL_decode_bytes(raw) == jax_io.PIL_decode_bytes(raw)
    assert torch_io.PIL_decode_bytes(b"garbage") is None


def test_transform_partitions_over_frames():
    import pandas as pd
    import pyarrow as pa

    def add_one(rows):
        for r in rows:
            yield dict(r, y=r["x"] + 1)

    local = LocalDataFrame.from_rows([{"x": i} for i in range(5)], 2)
    assert [r["y"] for r in transform_partitions(local, add_one).collect()] == \
        [1, 2, 3, 4, 5]
    assert local.num_partitions == 2
    pdf = transform_partitions(pd.DataFrame({"x": [1, 2]}), add_one)
    assert list(pdf["y"]) == [2, 3]
    tbl = transform_partitions(pa.table({"x": [3]}), add_one)
    assert tbl.column("y").to_pylist() == [4]
    with pytest.raises(TypeError):
        transform_partitions([1, 2], add_one)


def test_params_behave_like_jax_params():
    from sparkdl_torch.param import HasBatchSize, HasInputCol, Transformer
    from sparkdl_torch.param import SparkDLTypeConverters as C

    class T(Transformer, HasInputCol, HasBatchSize):
        def __init__(self, **kw):
            super().__init__()
            self._setDefault(batchSize=8)
            self._set(**kw)

    t = T(inputCol="a")
    assert t.getInputCol() == "a" and t.getBatchSize() == 8
    u = t.copy({"batchSize": 2})
    assert u.getBatchSize() == 2 and t.getBatchSize() == 8
    assert not t.isSet("batchSize") and t.isDefined("batchSize")
    with pytest.raises(KeyError):
        t.getOrDefault("nope")
    assert C.toInt(3.0) == 3
    with pytest.raises(TypeError):
        C.toInt(True)
    with pytest.raises(TypeError):
        C.toBoolean("yes")
