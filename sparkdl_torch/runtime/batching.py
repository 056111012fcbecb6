"""Bucketed batching: a small set of batch shapes from ragged partitions.

DataFrame partitions are ragged. Every batch is padded up to one of a
few bucket sizes, so the device sees a handful of shapes: each cuDNN
algorithm choice and each kernel launch geometry is found once per bucket
and reused.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Iterator, Sequence

import numpy as np

from sparkdl_torch.observability.tracing import span


def default_buckets(max_batch: int, min_bucket: int = 8) -> tuple[int, ...]:
    """Powers of two from min_bucket up to max_batch (inclusive)."""
    buckets = []
    b = min_bucket
    while b < max_batch:
        buckets.append(b)
        b *= 2
    buckets.append(max_batch)
    return tuple(buckets)


@dataclasses.dataclass(frozen=True)
class PaddedBatch:
    """A batch padded up to a bucket size.

    ``arrays`` leading dims equal ``bucket``; rows ``[n_valid:]`` are padding
    (repeats of row 0 so they are numerically harmless; zeros when the batch
    is empty) and must be dropped from the output.
    """

    arrays: dict[str, np.ndarray]
    n_valid: int
    bucket: int

    def unpad(self, out: np.ndarray) -> np.ndarray:
        return out[: self.n_valid]


def pow2_bucket(n: int, lo: int = 8, hi: "int | None" = None) -> int:
    """Smallest power-of-two-from-``lo`` bucket covering ``n``, capped at
    ``hi``: the one bucketing policy of prompt lengths, prefill-chunk
    widths and block-table gather depths, so the serving engine captures
    one CUDA graph per bucket and not one per length."""
    b = lo
    while b < n:
        b *= 2
    return b if hi is None else min(b, hi)


def pick_bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"batch of {n} rows exceeds largest bucket {buckets[-1]}")


def pad_to_bucket(arrays: dict[str, np.ndarray], buckets: Sequence[int]) -> PaddedBatch:
    n = next(iter(arrays.values())).shape[0]
    if n == 0:
        # an empty request still runs the smallest bucket: zeros (there is
        # no row 0 to repeat), n_valid=0 so unpad() drops everything
        bucket = min(buckets)
        return PaddedBatch(
            {k: np.zeros((bucket,) + a.shape[1:], a.dtype)
             for k, a in arrays.items()},
            0, bucket,
        )
    bucket = pick_bucket(n, buckets)
    return PaddedBatch(
        {k: _repeat_pad(a, bucket) for k, a in arrays.items()}, n, bucket
    )


def _repeat_pad(a: np.ndarray, bucket: int) -> np.ndarray:
    """Pad rows [n:bucket] with copies of row 0 (the PaddedBatch contract —
    the single place the padding convention lives)."""
    n = a.shape[0]
    if bucket == n:
        return a
    return np.concatenate([a, np.repeat(a[:1], bucket - n, axis=0)], axis=0)


def rebatch(
    rows: Iterable[dict[str, np.ndarray]],
    batch_size: int,
    buckets: Sequence[int] | None = None,
) -> Iterator[PaddedBatch]:
    """Group per-row dicts into padded batches of at most ``batch_size``.

    Full batches come out at exactly ``batch_size``; the ragged tail is
    padded up to the nearest bucket.
    """
    if buckets is None:
        buckets = default_buckets(batch_size)
    pending: list[dict[str, np.ndarray]] = []
    for row in rows:
        pending.append(row)
        if len(pending) == batch_size:
            yield _stack(pending, buckets)
            pending = []
    if pending:
        yield _stack(pending, buckets)


def _stack(rows: list[dict[str, np.ndarray]], buckets: Sequence[int]) -> PaddedBatch:
    n = len(rows)
    bucket = pick_bucket(n, buckets)
    with span("batch.pack", rows=n, bucket=bucket):
        arrays = {
            k: _repeat_pad(np.stack([np.asarray(r[k]) for r in rows]), bucket)
            for k in rows[0]
        }
    return PaddedBatch(arrays, n, bucket)


def pad_batch_to_multiple(arrays: dict[str, np.ndarray], multiple: int) -> PaddedBatch:
    """Pad so the leading dim divides ``multiple`` (for sharded batch dims)."""
    n = next(iter(arrays.values())).shape[0]
    bucket = ((n + multiple - 1) // multiple) * multiple
    return pad_to_bucket(arrays, [bucket])
