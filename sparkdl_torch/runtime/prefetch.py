"""Double-buffered host→device prefetch, and the port's host→device put.

While the card computes batch i, a background thread stages batch i+1
(:class:`PrefetchIterator`). The native staging ring
(``native/bridge.py``) takes the uniform feeds; this module provides the
scheduling for the rest, and :class:`DevicePut`, the copy both use.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Callable, Iterable, Iterator, TypeVar

import numpy as np
import torch

from sparkdl_torch.observability import tracing
from sparkdl_torch.ops._dispatch import resolve_device
from sparkdl_torch.runtime.tree import tree_map

T = TypeVar("T")
U = TypeVar("U")

_SENTINEL = object()

_METRICS = None


def _metrics():
    """Lazy registry handles (kept off the import path so the module stays
    importable before the observability package is ready)."""
    global _METRICS
    if _METRICS is None:
        from sparkdl_torch.observability.registry import registry

        _METRICS = (
            registry().counter(
                "sparkdl_prefetch_batches_total",
                "batches handed from the prefetch buffer to the consumer"),
            registry().histogram(
                "sparkdl_prefetch_buffer_fill",
                "buffered batches observed at each consumer take",
                # top bound covers the autotuner's depth ceiling (the
                # old top of 32 clipped every autotuned depth above it
                # into +Inf, hiding how far ahead the producer ran)
                buckets=(0, 1, 2, 3, 4, 6, 8, 16, 32, 64, 128, 256)),
            registry().histogram(
                "sparkdl_prefetch_consumer_wait_seconds",
                "consumer time blocked waiting on the producer "
                "(infeed starvation)"),
            registry().counter(
                "sparkdl_prefetch_producer_blocked_seconds_total",
                "producer time blocked on a full buffer "
                "(consumer is the bottleneck)"),
        )
    return _METRICS


class DevicePut:
    """The port's host-to-device put: ``put(tree)`` returns the tree with
    every array leaf (numpy array or CPU tensor) as a tensor on ``device``.

    On CUDA each leaf is copied from page-locked memory — the leaf itself
    where it is pinned already (a registered ring slot), else a pinned
    copy from PyTorch's caching host allocator — by a non-blocking copy on
    this put's own side stream. One CUDA event per call, recorded after
    the copies, is waited on by the calling thread before the put returns,
    so the source may be reused the moment it returns (the staging ring
    releases its slot then), and the consumer never waits for a copy.
    Each device tensor is marked as used on the consumer's stream
    (``record_stream``: the stream current on the thread that built this
    put), so the caching allocator cannot give its memory to a later copy
    while the consumer's kernels still read it.

    On the CPU the put is the identity (numpy leaves become tensors that
    share their memory).
    """

    def __init__(self, device: Any = "cuda"):
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            self._side = torch.cuda.Stream(self.device)
            self._consumer = torch.cuda.current_stream(self.device)

    def __call__(self, tree: Any) -> Any:
        if self.device.type == "cpu":
            return tree_map(_as_tensor, tree)
        copies: "list[torch.Tensor]" = []

        def put(leaf):
            host = _as_tensor(leaf)
            if not isinstance(host, torch.Tensor) or host.device.type != "cpu":
                return host
            if not host.is_pinned():
                host = host.pin_memory()
            dev = host.to(self.device, non_blocking=True)
            copies.append(dev)
            return dev

        with tracing.span("batch.h2d"):
            with torch.cuda.stream(self._side):
                out = tree_map(put, tree)
                done = torch.cuda.Event()
                done.record(self._side)
            done.synchronize()
        for dev in copies:
            dev.record_stream(self._consumer)
        return out


def _as_tensor(leaf: Any) -> Any:
    if isinstance(leaf, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(leaf))
    return leaf


class PrefetchIterator(Iterator[U]):
    """Iterator over ``transfer(item)`` with a background producer thread.

    Deterministic lifecycle for serving-style consumers that may abandon
    the stream mid-flight (a cancelled request, an errored batch):
    ``close()`` — also run by ``__del__``, exhaustion, and context-manager
    exit — sets the stop event, drains the hand-off queue so a producer
    blocked mid-put wakes up, and joins the thread. Unlike the previous
    generator implementation, release does not depend on the *generator*
    object being garbage-collected at the right moment.
    """

    def __init__(self, it: Iterable[T], size: int = 2,
                 transfer: Callable[[T], U] | None = None):
        if transfer is None:
            transfer = DevicePut()
        # maxsize=0 would make the queue unbounded (prefetch the whole
        # stream); clamp so size<=0 means minimal, not infinite, buffering.
        self._q: queue.Queue = queue.Queue(maxsize=max(1, size))
        self._size = max(1, size)
        self._err: list[BaseException] = []
        self._stop = threading.Event()
        self._done = False

        # The producer must NOT close over ``self``: the running thread
        # would then keep the iterator alive forever, so an abandoning
        # consumer's drop never triggers __del__ and the thread leaks.
        # Locals only — the thread pins just the queue/event/err cells.
        q, stop, err = self._q, self._stop, self._err

        def put(item) -> bool:
            # Bounded put so an abandoned consumer releases the producer
            # instead of leaking the thread and the device buffers queued
            # behind it.
            blocked_from: "float | None" = None
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    if blocked_from is not None:
                        _metrics()[3].inc(
                            time.monotonic() - blocked_from)
                    return True
                except queue.Full:
                    if blocked_from is None:
                        blocked_from = time.monotonic()
                    continue
            return False

        def producer():
            try:
                for item in it:
                    if stop.is_set() or not put(transfer(item)):
                        return
            except BaseException as e:  # propagate into consumer
                err.append(e)
            finally:
                put(_SENTINEL)

        self._thread = threading.Thread(
            target=producer, name="sparkdl-prefetch", daemon=True
        )
        self._thread.start()

    def __iter__(self) -> "PrefetchIterator[U]":
        return self

    def __next__(self) -> U:
        # Bounded gets so a close() from another thread (request
        # cancellation) cannot strand us: once close() drains the queue
        # the sentinel may never arrive, so re-check _done each beat.
        t0 = time.monotonic()
        while True:
            if self._done:
                if self._err:
                    # a raced close() may have drained the sentinel that
                    # carried the error: surface it, never swallow it
                    raise self._err[0]
                raise StopIteration
            try:
                item = self._q.get(timeout=0.1)
            except queue.Empty:
                if (self._err and not self._thread.is_alive()
                        and self._q.empty()):
                    # producer died (transfer/source raised) and its
                    # sentinel was lost (e.g. drained by a concurrent
                    # close, or the bounded put gave up): propagate the
                    # exception instead of spinning on an empty queue
                    self.close()
                    raise self._err[0]
                continue
            if item is _SENTINEL:
                self.close()
                if self._err:
                    raise self._err[0]
                raise StopIteration
            now = time.monotonic()
            batches, fill, wait, _ = _metrics()
            batches.inc()
            # fill AFTER the take: how far ahead the producer still is —
            # persistently 0 here == the infeed is the bottleneck
            fill.observe(self._q.qsize())
            wait.observe(now - t0)
            tracing.record_span("batch.prefetch_wait", t0, now)
            return item

    @property
    def depth(self) -> int:
        """Current buffer depth (batches the producer may run ahead)."""
        return self._size

    def set_depth(self, size: int) -> None:
        """Resize the buffer on a LIVE iterator without dropping staged
        batches (the autotuner's depth knob). Growing lets the producer
        run further ahead immediately; shrinking below the current fill
        keeps every staged batch — the producer simply blocks until the
        consumer drains under the new bound. Queue.maxsize is only read
        under the queue's own mutex, so flipping it there is exactly the
        synchronization put()/get() already use."""
        size = max(1, int(size))
        q = self._q
        with q.mutex:
            self._size = size
            q.maxsize = size
            # wake a producer parked in put(): the bound may have grown
            q.not_full.notify_all()

    def close(self) -> None:
        """Stop the producer and release queued buffers. Idempotent."""
        self._done = True
        self._stop.set()
        # Drain so a producer blocked mid-put can observe stop and exit.
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        if self._thread.is_alive():
            self._thread.join(timeout=1.0)

    def __enter__(self) -> "PrefetchIterator[U]":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):  # GC of an abandoned iterator must not leak the thread
        try:
            self.close()
        except Exception:  # pragma: no cover - interpreter shutdown
            pass


def prefetch_to_device(
    it: Iterable[T],
    size: int = 2,
    transfer: Callable[[T], U] | None = None,
) -> PrefetchIterator[U]:
    """Run ``transfer`` (default :class:`DevicePut` onto the card) on a
    background thread, keeping ``size`` batches in flight ahead of the
    consumer.

    The put blocks only its own (producer) thread until its copy lands,
    so a depth-2 pipeline hides the host->device copy behind compute.
    The returned :class:`PrefetchIterator` supports ``close()`` (also run
    on GC and context-manager exit) so abandoning consumers never leak the
    producer thread.
    """
    return PrefetchIterator(it, size=size, transfer=transfer)


def pipelined_map(
    fn: Callable[[U], T],
    it: Iterable[U],
    prefetch: int = 2,
    transfer: Callable | None = None,
) -> Iterator[T]:
    """Map fn over batches with transfer/compute overlap.

    Because CUDA launches are asynchronous, simply iterating keeps the
    device busy; the prefetch thread keeps the host side ahead.
    """
    for batch in prefetch_to_device(it, size=prefetch, transfer=transfer):
        yield fn(batch)
