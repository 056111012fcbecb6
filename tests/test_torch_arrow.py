"""The port's Arrow adapters against the JAX package's on the same
RecordBatches: zero-copy column views, ragged packing through each
package's row packer, null rejection; and the Arrow-facing DataFrame
helpers (``columns_of``, ``get_column_block``, ``arrow_image_type``, the
``"local"`` backend parameters)."""

import numpy as np
import pandas as pd
import pytest

pa = pytest.importorskip("pyarrow")

from sparkdl_torch.dataframe import LocalDataFrame, columns_of, make_dataframe  # noqa: E402
from sparkdl_torch.dataframe.adapters import get_column_block  # noqa: E402
from sparkdl_torch.image import arrow_image_type, readImages, readImagesWithCustomFn  # noqa: E402
from sparkdl_torch.native.arrow import (  # noqa: E402
    column_matrix,
    column_rows,
    pack_arrow_column,
)
from sparkdl_torch.native.bridge import pack_rows  # noqa: E402
from sparkdl_tpu.dataframe import columns_of as jax_columns_of  # noqa: E402
from sparkdl_tpu.dataframe.adapters import get_column_block as jax_column_block  # noqa: E402
from sparkdl_tpu.image import arrow_image_type as jax_arrow_image_type  # noqa: E402
from sparkdl_tpu.native import arrow as jax_arrow  # noqa: E402


@pytest.fixture()
def fixed_batch():
    data = np.arange(24, dtype=np.float32).reshape(6, 4)
    arr = pa.FixedSizeListArray.from_arrays(pa.array(data.reshape(-1)), 4)
    return pa.RecordBatch.from_arrays([arr], ["feat"]), data


def test_fixed_size_list_matrix_zero_copy(fixed_batch):
    batch, data = fixed_batch
    m = column_matrix(batch, "feat")
    np.testing.assert_array_equal(m, data)
    np.testing.assert_array_equal(m, jax_arrow.column_matrix(batch, "feat"))
    # zero-copy: the numpy view aliases Arrow's buffer, not a fresh copy
    buf_addr = batch.column("feat").values.buffers()[1].address
    assert m.ctypes.data == buf_addr


def test_fixed_size_list_with_batch_slice(fixed_batch):
    batch, data = fixed_batch
    sliced = batch.slice(2, 3)
    np.testing.assert_array_equal(column_matrix(sliced, "feat"), data[2:5])


def test_primitive_column_matrix():
    batch = pa.RecordBatch.from_arrays(
        [pa.array(np.asarray([1.5, 2.5, 3.5], np.float64))], ["x"]
    )
    m = column_matrix(batch, "x")
    assert m.shape == (3, 1) and m[1, 0] == 2.5
    np.testing.assert_array_equal(m, jax_arrow.column_matrix(batch, "x"))
    assert [r.tolist() for r in column_rows(batch, "x")] == [
        r.tolist() for r in jax_arrow.column_rows(batch, "x")]


def test_ragged_rows_and_pack_match_oracle():
    rows_np = [
        np.arange(3, dtype=np.float32),
        np.arange(5, dtype=np.float32) * 2,
        np.arange(1, dtype=np.float32) + 7,
    ]
    arr = pa.array([r.tolist() for r in rows_np], pa.list_(pa.float32()))
    batch = pa.RecordBatch.from_arrays([arr], ["feat"])

    got_rows = column_rows(batch, "feat")
    for g, w in zip(got_rows, rows_np):
        np.testing.assert_array_equal(g, w)

    packed, n, stride = pack_arrow_column(batch, "feat", bucket=4)
    want = pack_rows(rows_np, bucket=4, row_stride=stride)
    np.testing.assert_array_equal(packed, want)
    assert n == 3
    # the reference's packer gives the same bytes
    ref, ref_n, ref_stride = jax_arrow.pack_arrow_column(batch, "feat", bucket=4)
    np.testing.assert_array_equal(packed, ref)
    assert (n, stride) == (ref_n, ref_stride)


def test_ragged_rows_with_batch_slice():
    rows_np = [
        np.arange(3, dtype=np.float32),
        np.arange(5, dtype=np.float32) * 2,
        np.arange(1, dtype=np.float32) + 7,
        np.arange(2, dtype=np.float32) - 1,
    ]
    arr = pa.array([r.tolist() for r in rows_np], pa.list_(pa.float32()))
    batch = pa.RecordBatch.from_arrays([arr], ["feat"]).slice(1, 2)
    got = column_rows(batch, "feat")
    assert len(got) == 2
    np.testing.assert_array_equal(got[0], rows_np[1])
    np.testing.assert_array_equal(got[1], rows_np[2])


def test_fixed_size_slice_ignores_nulls_outside_window():
    arr = pa.array([None, [1.0, 2.0], [3.0, 4.0]], pa.list_(pa.float32(), 2))
    batch = pa.RecordBatch.from_arrays([arr], ["f"]).slice(1, 2)
    m = column_matrix(batch, "f")
    np.testing.assert_array_equal(m, [[1.0, 2.0], [3.0, 4.0]])


def test_fixed_pack_fast_path_matches_pack_rows(fixed_batch):
    batch, data = fixed_batch
    packed, n, stride = pack_arrow_column(batch, "feat", bucket=8)
    want = pack_rows([data[i] for i in range(len(data))], bucket=8,
                     row_stride=stride)
    np.testing.assert_array_equal(packed, want)
    assert n == len(data) and stride == 16
    ref, _, _ = jax_arrow.pack_arrow_column(batch, "feat", bucket=8)
    np.testing.assert_array_equal(packed, ref)


def test_ragged_matrix_rejected():
    arr = pa.array([[1.0], [2.0, 3.0]], pa.list_(pa.float32()))
    batch = pa.RecordBatch.from_arrays([arr], ["f"])
    with pytest.raises(ValueError, match="variable-length"):
        column_matrix(batch, "f")


def test_nulls_rejected():
    arr = pa.array([[1.0, 2.0], None], pa.list_(pa.float32()))
    batch = pa.RecordBatch.from_arrays([arr], ["f"])
    with pytest.raises(ValueError, match="null"):
        column_rows(batch, "f")


# -- the DataFrame helpers ----------------------------------------------------

def test_columns_of():
    frames = (pd.DataFrame({"a": [1]}), pa.table({"b": [1]}))
    for df in frames:
        assert columns_of(df) == jax_columns_of(df)
    assert columns_of(frames[0]) == ["a"]
    assert columns_of(frames[1]) == ["b"]
    assert columns_of(LocalDataFrame.from_rows([{"c": 1}])) == ["c"]
    with pytest.raises(TypeError, match="unsupported DataFrame type"):
        columns_of([{"c": 1}])


def test_column_block_and_arrow_image_type():
    rows = [{"x": [1.0, 2.0]}, {"x": [3.0, 4.0]}]
    np.testing.assert_array_equal(get_column_block(rows, "x"),
                                  jax_column_block(rows, "x"))
    assert get_column_block(rows, "x").shape == (2, 2)
    assert arrow_image_type() == jax_arrow_image_type()


def test_local_backend_parameters(tmp_path):
    from PIL import Image

    Image.fromarray(np.zeros((4, 5, 3), np.uint8)).save(tmp_path / "a.png")
    df = make_dataframe([{"x": 1}, {"x": 2}], backend="local",
                        num_partitions=2)
    assert df.num_partitions == 2 and df.count() == 2
    for read in (readImages, readImagesWithCustomFn):
        got = read(str(tmp_path), dataframe_backend="local").collect()
        assert got[0]["image"]["height"] == 4
    # any other backend raises, as in the reference
    with pytest.raises(ValueError, match="unknown dataframe backend"):
        make_dataframe([{"x": 1}], backend="spark")
    for read in (readImages, readImagesWithCustomFn):
        with pytest.raises(ValueError, match="unknown dataframe backend"):
            read(str(tmp_path), dataframe_backend="spark")
