"""The port's prefetch (sparkdl_torch/runtime/prefetch.py), after the JAX
package's error-path suite (tests/runtime/test_prefetch_errors.py): a
transfer that raises mid-stream must propagate to the consumer's
``__next__`` — delivered after the items that were already staged — and
release the producer thread, never leaving the consumer blocked on the
queue or the error silently swallowed. Plus the port's own put on the CPU
and the depth knob, each against the JAX package's iterator.
"""

import time

import pytest

import numpy as np
import torch

from sparkdl_torch.runtime.prefetch import (
    DevicePut,
    PrefetchIterator,
    pipelined_map,
    prefetch_to_device,
)
from sparkdl_tpu.runtime import prefetch as jax_prefetch


class TransferBoom(RuntimeError):
    pass


def _flaky_transfer(fail_at):
    def transfer(item):
        if item == fail_at:
            raise TransferBoom(f"transfer failed on item {item}")
        return item * 10
    return transfer


def _wait_dead(it, timeout=5.0):
    deadline = time.monotonic() + timeout
    while it._thread.is_alive() and time.monotonic() < deadline:
        time.sleep(0.01)
    return not it._thread.is_alive()


def test_transfer_error_mid_stream_propagates_in_order():
    it = prefetch_to_device(iter(range(6)), size=2,
                            transfer=_flaky_transfer(3))
    got = []
    with pytest.raises(TransferBoom, match="item 3"):
        for x in it:  # must terminate: no hang on the queue
            got.append(x)
    assert got == [0, 10, 20]  # staged items delivered before the error
    assert _wait_dead(it), "producer thread leaked after transfer error"


def test_transfer_error_on_first_item():
    it = prefetch_to_device(iter(range(4)), size=2,
                            transfer=_flaky_transfer(0))
    with pytest.raises(TransferBoom):
        next(it)
    assert _wait_dead(it)


def test_source_iterator_error_propagates():
    def source():
        yield 1
        raise TransferBoom("source died")

    it = prefetch_to_device(source(), size=2, transfer=lambda x: x)
    assert next(it) == 1
    with pytest.raises(TransferBoom, match="source died"):
        next(it)


def test_error_survives_raced_close():
    # close() drains the queue — which can swallow the sentinel that
    # carried the error. __next__ must still raise it, not StopIteration.
    it = prefetch_to_device(iter(range(3)), size=2,
                            transfer=_flaky_transfer(0))
    assert _wait_dead(it), "producer should die on the first transfer"
    it.close()  # races/loses the sentinel: queue drained, _done set
    with pytest.raises(TransferBoom):
        next(it)


def test_pipelined_map_propagates_transfer_error():
    out = []
    with pytest.raises(TransferBoom):
        for y in pipelined_map(lambda x: x + 1, iter(range(5)),
                               transfer=_flaky_transfer(2)):
            out.append(y)
    assert out == [1, 11]


def test_clean_stream_unaffected():
    it = prefetch_to_device(iter(range(5)), size=2, transfer=lambda x: -x)
    assert list(it) == [0, -1, -2, -3, -4]
    assert _wait_dead(it)


@pytest.mark.parametrize("fail_at", [None, 0, 3])
def test_error_and_order_match_the_jax_prefetcher(fail_at):
    """The same stream and failing transfer through both prefetchers:
    the same items in the same order, then the same error."""
    def run(make):
        got, err = [], None
        try:
            for x in make(iter(range(7)), size=2,
                          transfer=_flaky_transfer(fail_at)):
                got.append(x)
        except TransferBoom as e:
            err = str(e)
        return got, err

    assert run(prefetch_to_device) == run(jax_prefetch.prefetch_to_device)


def test_cpu_put_is_the_identity_on_memory():
    """On the CPU the put hands numpy leaves over as tensors sharing their
    memory (nothing to copy), and leaves tensors and scalars as they are."""
    a = np.arange(12, dtype=np.float32).reshape(3, 4)
    t = torch.ones(2)
    out = DevicePut("cpu")({"a": a, "t": t, "n": 3, "pair": (a[:1], t)})
    assert isinstance(out["a"], torch.Tensor)
    assert out["a"].data_ptr() == a.ctypes.data
    assert out["t"] is t and out["n"] == 3
    assert isinstance(out["pair"], tuple) and out["pair"][1] is t
    np.testing.assert_array_equal(out["pair"][0].numpy(), a[:1])


def test_default_put_is_the_card():
    """prefetch_to_device's default transfer puts on the card, so without
    CUDA it raises instead of running on the CPU."""
    with pytest.raises(RuntimeError, match="CUDA"):
        prefetch_to_device(iter(range(3)))


def test_set_depth_keeps_staged_items_like_the_jax_iterator():
    def drain(cls):
        it = cls(iter(range(20)), size=4, transfer=lambda x: x)
        out = [next(it) for _ in range(3)]
        it.set_depth(1)
        out += [next(it) for _ in range(3)]
        it.set_depth(8)
        out += list(it)
        return out, it.depth

    assert drain(PrefetchIterator) == drain(jax_prefetch.PrefetchIterator)
    assert drain(PrefetchIterator)[0] == list(range(20))


def test_abandoned_iterator_releases_its_thread():
    it = prefetch_to_device(iter(range(1000)), size=2, transfer=lambda x: x)
    assert next(it) == 0
    it.close()
    it._thread.join(timeout=5.0)
    assert not it._thread.is_alive()
