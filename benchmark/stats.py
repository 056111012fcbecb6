"""The benchmark's own arithmetic: rates, tails and interval unions."""

from __future__ import annotations

import math


def percentile(values, q: float) -> float:
    """The q-th percentile (0..100) with linear interpolation between the
    two nearest ranks (numpy's default)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo, hi = math.floor(pos), math.ceil(pos)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def window_rate(records, t_start: float, t_end: float):
    """(items per second, seconds, items, records counted) over the
    records ``(start, end, items)`` that started in [t_start, t_end): all
    their items over the time from ``t_start`` until the last of them
    ended. A stall anywhere in the window lowers it."""
    started = [r for r in records if t_start <= r[0] < t_end]
    if not started:
        return None, 0.0, 0, 0
    seconds = max(r[1] for r in started) - t_start
    items = sum(r[2] for r in started)
    return items / seconds, seconds, items, len(started)


def window_tail(records, t_start: float, t_end: float, q: float):
    """The q-th percentile of the durations of the records that started
    in the window, in seconds."""
    started = [r[1] - r[0] for r in records if t_start <= r[0] < t_end]
    return percentile(started, q) if started else None


def union(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    """The union of (start, end) intervals clipped to [lo, hi], as sorted
    disjoint intervals."""
    out: list[list[float]] = []
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def gaps(busy: list[tuple[float, float]], lo: float, hi: float) -> list[tuple[float, float]]:
    """The complement of sorted disjoint ``busy`` intervals in [lo, hi]."""
    out, t = [], lo
    for s, e in busy:
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out
