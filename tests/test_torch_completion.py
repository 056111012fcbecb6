"""The port's AsyncFetcher (sparkdl_torch/runtime/completion.py): window
bound, ordering, per-batch error surfacing, after the JAX package's suite
(tests/runtime/test_completion.py).

The completion layer's contract: results stream back in submission order
with at most ``window`` in flight, and an error caused by batch i surfaces
when result i is collected — after results 0..i-1 were delivered, never
early at the window edge. On the CPU a tensor's fetch is done when it
starts; the card's copies run only in chip_smoke.py.
"""

import numpy as np
import pytest

import torch

from sparkdl_torch.observability.registry import registry
from sparkdl_torch.runtime.completion import (
    AsyncFetcher,
    fetch_wait_seconds,
    start_fetch,
)
from sparkdl_tpu.runtime import completion as jax_completion


class _Boom:
    """A leaf whose host conversion raises — the stand-in for a device
    error that only materializes at readback."""

    def __array__(self, dtype=None, copy=None):
        raise RuntimeError("device error at readback")


def test_stream_preserves_order_and_values():
    outs = [np.full((3,), float(i)) for i in range(17)]
    got = list(AsyncFetcher(window=4, path="t_order").stream(iter(outs)))
    assert len(got) == 17
    for i, g in enumerate(got):
        np.testing.assert_array_equal(g, outs[i])


def test_stream_window_bounds_inflight():
    window = 3
    pulled = 0

    def source():
        nonlocal pulled
        for i in range(20):
            pulled += 1
            yield np.full((2,), float(i))

    yielded = 0
    for _ in AsyncFetcher(window=window, path="t_window").stream(source()):
        yielded += 1
        # never more than `window` submitted-but-unyielded results
        assert pulled - yielded <= window
    assert yielded == 20


def test_error_surfaces_on_its_batch_not_window_edge():
    # batch 5 of 12 is poisoned; window 8 would submit it long before
    # its result index comes up
    outs = [np.full((2,), float(i)) if i != 5 else _Boom()
            for i in range(12)]
    it = AsyncFetcher(window=8, path="t_err").stream(iter(outs))
    for i in range(5):
        np.testing.assert_array_equal(next(it), outs[i])
    with pytest.raises(RuntimeError, match="device error at readback"):
        next(it)


def test_source_error_delivered_after_preceding_results():
    # a failed DISPATCH (the source iterator raises) must not eat the
    # results already in flight before it
    def source():
        yield np.ones((2,))
        yield np.full((2,), 2.0)
        raise ValueError("dispatch blew up")

    it = AsyncFetcher(window=4, path="t_src").stream(source())
    np.testing.assert_array_equal(next(it), np.ones((2,)))
    np.testing.assert_array_equal(next(it), np.full((2,), 2.0))
    with pytest.raises(ValueError, match="dispatch blew up"):
        next(it)


def test_ticket_result_is_idempotent_and_memoized():
    t = start_fetch({"a": np.arange(4)}, path="t_memo")
    one = t.result()
    two = t.result()
    assert one is two
    np.testing.assert_array_equal(one["a"], np.arange(4))
    # error memoization too
    tb = start_fetch(_Boom(), path="t_memo")
    for _ in range(2):
        with pytest.raises(RuntimeError, match="device error"):
            tb.result()


def test_tensors_roundtrip_and_record_wait_metric():
    before = fetch_wait_seconds("t_torch")
    x = torch.arange(8, dtype=torch.float32) * 2.0
    out = start_fetch((x, {"y": x + 1}), path="t_torch").result()
    assert isinstance(out[0], np.ndarray) and isinstance(out[1]["y"], np.ndarray)
    np.testing.assert_array_equal(out[0], np.arange(8) * 2.0)
    np.testing.assert_array_equal(out[1]["y"], np.arange(8) * 2.0 + 1)
    assert fetch_wait_seconds("t_torch") >= before
    fam = registry().get("sparkdl_fetches_total")
    assert fam.snapshot_values().get('path="t_torch"', 0) >= 1


@pytest.mark.parametrize("window", [1, 3, 8])
def test_stream_matches_the_jax_fetcher(window):
    """The same outputs (numpy, with one poisoned batch) through both
    fetchers: the same values in the same order, then the same error."""
    outs = [np.full((2, 3), float(i)) if i != 6 else _Boom() for i in range(9)]

    def run(cls):
        got = []
        try:
            for r in cls(window=window, path="t_vs").stream(iter(outs)):
                got.append(r)
        except RuntimeError as e:
            got.append(str(e))
        return got

    mine, theirs = run(AsyncFetcher), run(jax_completion.AsyncFetcher)
    assert len(mine) == len(theirs) == 7
    for a, b in zip(mine[:-1], theirs[:-1]):
        np.testing.assert_array_equal(a, b)
    assert mine[-1] == theirs[-1]


def test_window_validation():
    with pytest.raises(ValueError, match="window"):
        AsyncFetcher(window=0)


def test_fallback_timeout_is_not_terminal():
    # a ticket that times out on the thread-pool fallback must stay
    # collectable — the copy finishes and the value comes back intact
    import threading
    from concurrent.futures import TimeoutError as FuturesTimeoutError

    gate = threading.Event()

    class _Slow:
        def __array__(self, dtype=None, copy=None):
            gate.wait(10.0)
            return np.arange(3, dtype=np.float64)

    t = start_fetch(_Slow(), path="t_timeout")
    # 3.10: concurrent.futures.TimeoutError is its own class; 3.11+
    # aliases the builtin — accept either
    with pytest.raises((TimeoutError, FuturesTimeoutError)):
        t.result(timeout=0.01)
    gate.set()
    np.testing.assert_array_equal(t.result(timeout=10.0), np.arange(3))
