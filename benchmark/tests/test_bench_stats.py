"""The rate and tail arithmetic on synthetic windows."""

import pytest

from benchmark import stats


def _run(durations, gap=0.2, items=256):
    """Partitions back to back: (start, end, items)."""
    out, t = [], 0.0
    for d in durations:
        out.append((t, t + d, items))
        t += d + gap
    return out


def test_percentile_interpolates_like_numpy():
    assert stats.percentile([1, 2, 3, 4], 50) == 2.5
    assert stats.percentile(range(11), 90) == pytest.approx(9.0)
    assert stats.percentile([5], 90) == 5


def test_a_stall_lowers_the_rate_and_raises_the_tail():
    steady = _run([0.8] * 100)
    stalled = _run([0.8] * 10 + [3.8] * 10 + [0.8] * 80)   # ten partitions held 3 s each
    t0, t1 = 0.0, 60.0
    rate, secs, items, count = stats.window_rate(steady, t0, t1)
    assert count == 60 and items == 60 * 256
    rate_stall, *_ = stats.window_rate(stalled, t0, t1)
    assert rate_stall < rate * 0.7
    assert stats.window_tail(stalled, t0, t1, 90) > 3.0 > stats.window_tail(steady, t0, t1, 90)


def test_only_work_started_in_the_window_counts_and_its_tail_is_waited_for():
    recs = [(-0.5, 0.5, 10), (0.1, 0.9, 10), (0.95, 2.5, 10), (1.1, 1.2, 10)]
    rate, secs, items, count = stats.window_rate(recs, 0.0, 1.0)
    assert (items, count, secs) == (20, 2, 2.5)
    assert rate == 8.0


def test_union_and_gaps():
    busy = stats.union([(0, 1), (0.5, 2), (3, 4), (10, 11)], 0, 5)
    assert busy == [(0, 2), (3, 4)]
    assert stats.gaps(busy, 0, 5) == [(2, 3), (4, 5)]
