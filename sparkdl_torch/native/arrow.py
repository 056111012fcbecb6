"""Arrow RecordBatch adapters for the staging bridge.

Spark executors hand Python workers **Arrow** batches (mapInArrow /
mapInPandas). These adapters expose column buffers to the C++ row packer
(``native/bridge.py``) as zero-copy numpy views: one threaded scatter
from Arrow memory into staging memory, no per-row Python conversion.
pyarrow is imported only when a function here is called, so the package
imports where it is not installed.

Supported column shapes (the DataFrame feature-column contract):
- primitive (float32/64, ints)            -> [n, 1] matrix
- fixed_size_list<primitive>              -> [n, k] matrix (zero-copy)
- list / large_list <primitive> (ragged)  -> per-row views of the flat
  values buffer, ready for ``pack_rows`` bucketed padding

Null entries are rejected loudly: a null in a feature column is a data
bug, and silently zero-filling it would hide that.
"""

from __future__ import annotations

import numpy as np

from sparkdl_torch.native.bridge import pack_rows


def _require_pa():
    import pyarrow as pa

    return pa


def _no_nulls(arr, col: str) -> None:
    if arr.null_count:
        raise ValueError(
            f"column {col!r} has {arr.null_count} null rows; feature "
            "columns must be non-null"
        )


def _flat_values(values, start: int, length: int) -> np.ndarray:
    """Zero-copy numpy view of a primitive Arrow array slice."""
    return values.slice(start, length).to_numpy(zero_copy_only=True)


def column_rows(batch, col: str) -> list[np.ndarray]:
    """Per-row numpy views of ``batch[col]`` — no per-row buffer copies.

    Ragged list columns yield rows of their natural lengths; use
    :func:`pack_arrow_column` to scatter them into a padded matrix.
    """
    pa = _require_pa()
    arr = batch.column(col)
    _no_nulls(arr, col)
    t = arr.type
    n = len(arr)
    if pa.types.is_fixed_size_list(t):
        m = column_matrix(batch, col)
        return [m[i] for i in range(n)]
    if pa.types.is_list(t) or pa.types.is_large_list(t):
        # .offsets is already windowed to the slice (length n+1) but its
        # values stay absolute into the full child buffer.
        offsets = arr.offsets.to_numpy()
        values = _flat_values(arr.values, 0, len(arr.values))
        return [values[offsets[i]: offsets[i + 1]] for i in range(n)]
    # primitive column -> one scalar per row
    return list(arr.to_numpy(zero_copy_only=True).reshape(n, 1))


def column_matrix(batch, col: str) -> np.ndarray:
    """Zero-copy [n_rows, width] matrix for a fixed-width column.

    Works for primitive columns (width 1) and fixed_size_list columns;
    ragged list columns raise (pack them via :func:`pack_arrow_column`).
    """
    pa = _require_pa()
    arr = batch.column(col)
    _no_nulls(arr, col)
    t = arr.type
    n = len(arr)
    if pa.types.is_fixed_size_list(t):
        k = t.list_size
        # Null-check only the window this slice actually reads — null rows
        # outside it are someone else's rows.
        _no_nulls(arr.values.slice(arr.offset * k, n * k), col)
        flat = _flat_values(arr.values, arr.offset * k, n * k)
        return flat.reshape(n, k)
    if pa.types.is_list(t) or pa.types.is_large_list(t):
        raise ValueError(
            f"column {col!r} is a variable-length list; use "
            "pack_arrow_column for ragged rows"
        )
    return arr.to_numpy(zero_copy_only=True).reshape(n, 1)


def pack_arrow_column(
    batch,
    col: str,
    *,
    bucket: int | None = None,
    row_stride: int | None = None,
    out: np.ndarray | None = None,
    n_threads: int = 4,
) -> tuple[np.ndarray, int, int]:
    """Scatter ``batch[col]`` into a padded [bucket, row_stride] uint8
    staging matrix via the threaded C++ packer.

    Returns (packed, n_rows, row_stride_bytes). ``out`` may be a staging
    ring slot view — Arrow memory then flows straight into pinned staging
    with one copy total. Fixed-width columns take a bulk-copy fast path
    (one contiguous copy); ragged lists go through the threaded C++
    row scatter.
    """
    pa = _require_pa()
    t = batch.column(col).type
    fixed = not (pa.types.is_list(t) or pa.types.is_large_list(t))
    if fixed:
        m = column_matrix(batch, col)
        n = m.shape[0]
        if n == 0:
            raise ValueError(f"column {col!r} has no rows")
        row_bytes = m.shape[1] * m.itemsize
        stride = row_stride or row_bytes
        if stride < row_bytes:
            raise ValueError(f"row_stride {stride} < row bytes {row_bytes}")
        total = bucket or n
        if total < n:
            raise ValueError(f"bucket {total} < n_rows {n}")
        if out is None:
            out = np.empty(total * stride, np.uint8)
        else:
            out = out.view(np.uint8).reshape(-1)
            if out.nbytes < total * stride:
                raise ValueError("out buffer too small")
        view = out[: total * stride].reshape(total, stride)
        flat = np.ascontiguousarray(m).view(np.uint8).reshape(n, row_bytes)
        view[:n, :row_bytes] = flat
        if stride > row_bytes:
            view[:n, row_bytes:] = 0
        view[n:] = view[0]  # bucketed padding repeats row 0 (pack_rows contract)
        return view, n, stride  # [bucket, stride], same shape pack_rows returns

    rows = column_rows(batch, col)
    if not rows:
        raise ValueError(f"column {col!r} has no rows")
    stride = row_stride or max(r.nbytes for r in rows)
    packed = pack_rows(
        rows, bucket=bucket, row_stride=stride, out=out, n_threads=n_threads
    )
    return packed, len(rows), stride
