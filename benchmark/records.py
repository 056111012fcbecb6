"""What the per-layer readers share: spans and device events of a traced
run's window (``rec``, built by the mode).

``rec`` holds ``mode``, ``cell``, ``config``, ``window`` (start, end on
the monotonic clock), ``window_s``, ``busy_s``, ``events`` (device
operations as (name, start, end)), ``spans`` (as (name, start, end,
args)) and the work done: ``images`` for featurization, ``steps`` and
``samples`` for training.
"""

from __future__ import annotations

from benchmark.trace import is_kernel


def span_mean_ms(rec: dict, name: str, per_rows: "int | None" = None):
    """The mean duration (ms) of the program's ``name`` spans in the
    window, or with ``per_rows`` the ms per that many rows (the span's
    ``rows`` argument); None where the window has none."""
    spans = [s for s in rec.get("spans", ()) if s[0] == name]
    if not spans:
        return None
    total = sum(e - s for _, s, e, _ in spans) * 1e3
    if per_rows is None:
        return total / len(spans)
    rows = sum(args.get("rows", 0) for *_, args in spans)
    return total / rows * per_rows if rows else None


def kernel_events(rec: dict, needle: "str | None" = None):
    """The kernels (no copies) that started in the window, those whose
    name holds ``needle`` where given, as (start, end)."""
    lo, hi = rec["window"]
    return [(s, e) for name, s, e in rec.get("events", ())
            if lo <= s < hi and is_kernel(name) and (needle is None or needle in name)]


def seconds(intervals) -> float:
    return sum(e - s for s, e in intervals)


def batch_size(rec: dict) -> int:
    return rec["cell"]["traffic"]["batch_size"]


def image_size(rec: dict) -> int:
    return rec["config"]["input_size"][0]
