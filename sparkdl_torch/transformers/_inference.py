"""Shared batched-inference engine for the transformers.

Rows are grouped into bucketed, padded batches (runtime/batching.py);
each batch is staged in pinned host memory, copied to the device without
blocking the host, run through ``apply_fn`` under ``torch.inference_mode``,
copied back and unpadded.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Callable, Iterator

import numpy as np
import torch

from sparkdl_torch.ops._dispatch import resolve_device
from sparkdl_torch.runtime.batching import default_buckets, pad_to_bucket, rebatch


@dataclasses.dataclass
class BatchedRunner:
    """Maps ``apply_fn(batch_dict) -> tensor (or tuple of tensors)`` over
    row streams. Inputs are dicts of numpy arrays with a leading batch
    dim; ``apply_fn`` gets the same keys as tensors on ``device``.
    Outputs follow the batch's leading dim.
    """

    apply_fn: Callable[[dict[str, torch.Tensor]], Any]
    batch_size: int = 64
    device: Any = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self._buckets = default_buckets(self.batch_size)

    def run(self, rows: Iterator[dict[str, np.ndarray]]) -> Iterator[Any]:
        """Yield one output per input row, in order (per-row tuples for
        tuple-valued apply_fns)."""
        for batch in rebatch(rows, self.batch_size, self._buckets):
            out = self._execute(batch.arrays)
            if isinstance(out, tuple):
                for j in range(batch.n_valid):
                    yield tuple(a[j] for a in out)
            else:
                yield from out[: batch.n_valid]

    def run_batch(self, arrays: dict[str, np.ndarray]):
        """One stacked batch: pad to its bucket, run, unpad. Returns the
        output array [n, ...] (or a tuple of arrays)."""
        padded = pad_to_bucket(arrays, self._buckets)
        out = self._execute(padded.arrays)
        if isinstance(out, tuple):
            return tuple(a[: padded.n_valid] for a in out)
        return out[: padded.n_valid]

    def _execute(self, arrays: dict[str, np.ndarray]):
        feed = {k: self._to_device(a) for k, a in arrays.items()}
        with torch.inference_mode():
            out = self.apply_fn(feed)
        if isinstance(out, (tuple, list)):
            return tuple(o.cpu().numpy() for o in out)
        return out.cpu().numpy()

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type == "cuda":
            # pinned staging lets the H2D copy run without a host bounce
            t = t.pin_memory().to(self.device, non_blocking=True)
        return t


def try_extract(extract: Callable[[Any], dict[str, np.ndarray]],
                row: Any) -> "tuple[dict[str, np.ndarray] | None, Exception | None]":
    """Run ``extract`` on one row, capturing the error instead of raising:
    a row that cannot be featurized degrades to a per-row error and never
    poisons its batch."""
    try:
        return extract(row), None
    except Exception as e:  # per-row data errors become None outputs
        return None, e


def run_partition_with_passthrough(
    rows: "list[dict]",
    extract: Callable[[dict], dict[str, np.ndarray]],
    runner: BatchedRunner,
    output_col: str,
    postprocess: Callable[[np.ndarray], Any] | None = None,
    input_cols: "tuple[str, ...] | None" = None,
) -> Iterator[dict]:
    """Run inference for a partition, appending ``output_col`` to each row.

    ``extract`` turns a row into the numeric feature dict the model eats;
    rows it raises on are yielded unchanged with output None (undecodable
    rows are tolerated). Misconfiguration stays loud rather than masked as
    bad data: missing ``input_cols`` raise immediately, and an
    all-rows-failed partition logs a warning with the first error.
    """
    if rows and input_cols:
        missing = [c for c in input_cols if c not in rows[0]]
        if missing:
            raise KeyError(
                f"input column(s) {missing} not in DataFrame columns "
                f"{sorted(rows[0].keys())}"
            )
    feeds: list[dict[str, np.ndarray] | None] = []
    first_error: Exception | None = None
    for r in rows:
        feed, err = try_extract(extract, r)
        first_error = first_error or err
        feeds.append(feed)
    valid = [f for f in feeds if f is not None]
    if rows and not valid and first_error is not None:
        logging.getLogger(__name__).warning(
            "all %d rows in partition failed extraction (output=None); "
            "first error: %r", len(rows), first_error,
        )
    outputs = runner.run(iter(valid)) if valid else iter(())
    for r, f in zip(rows, feeds):
        out_row = dict(r)
        if f is None:
            out_row[output_col] = None
        else:
            o = next(outputs)
            out_row[output_col] = postprocess(o) if postprocess else o
        yield out_row
