"""Asynchronous device→host completion: overlap readback with dispatch.

A blocking ``.cpu()`` at the end of every batch serializes the
device→host copy of batch i with the dispatch of batch i+1. Here a
result's copy is *started* the moment its dispatch is enqueued — a
non-blocking copy into page-locked host memory on the stream that
produced the output, followed by a CUDA event — and *collected* only when
the caller needs the host value, by which point the next dispatch is
already running and the copy has landed underneath it.

Three pieces:

* :func:`start_fetch` — begin the copy of one output tree and return a
  :class:`FetchTicket`; ``ticket.result()`` blocks only for whatever copy
  time is *left* (metered as ``sparkdl_fetch_wait_seconds{path=...}`` —
  the number that must drop when overlap works).
* :class:`AsyncFetcher` — the windowed form: ``submit()`` up to
  ``window`` outputs in flight (device memory stays capped at ``window``
  result buffers), ``stream()`` maps a device-output iterator to host
  results with submission order preserved and an error surfacing on the
  result index of the batch that caused it, never at the window edge.
* a bounded readback thread pool (``SPARKDL_TORCH_FETCH_THREADS``) for
  leaves that are neither tensors nor host arrays (anything numpy can
  convert) — same window bound, same ordering contract.

Every host array a ticket hands out owns its memory: a fresh page-locked
tensor per fetch (from PyTorch's caching host allocator, which reuses a
block only once every array on it is gone), never a reused buffer.
CPU tensors are on the host already: their fetch is done when it starts.
"""

from __future__ import annotations

import collections
import os
import threading
import time
from concurrent.futures import (
    ThreadPoolExecutor,
    TimeoutError as FuturesTimeoutError,
)
from typing import Any, Callable, Iterable, Iterator

import numpy as np
import torch

from sparkdl_torch.observability import tracing
from sparkdl_torch.observability.registry import registry
from sparkdl_torch.reliability.faults import fault_point
from sparkdl_torch.runtime.tree import tree_leaves, tree_map

__all__ = [
    "AsyncFetcher",
    "FetchTicket",
    "fetch_metrics",
    "fetch_wait_seconds",
    "start_fetch",
]

_METRICS = None


def fetch_metrics():
    """Lazy handles for the completion spine (one tuple per process):
    (fetches counter by path, host-blocked-wait histogram by path,
    in-flight gauge)."""
    global _METRICS
    if _METRICS is None:
        _METRICS = (
            registry().counter(
                "sparkdl_fetches_total",
                "device->host result fetches started", labels=("path",)),
            registry().histogram(
                "sparkdl_fetch_wait_seconds",
                "host time blocked collecting an async D2H result "
                "(0-ish = the copy hid behind the next dispatch)",
                labels=("path",)),
            registry().gauge(
                "sparkdl_fetch_inflight",
                "async fetches currently in flight, all paths"),
        )
    return _METRICS


def fetch_wait_seconds(path: "str | None" = None) -> float:
    """Total host seconds blocked in ``result()`` (summed over paths when
    ``path`` is None) — the benches' ``fetch_wait_share`` numerator."""
    fam = registry().get("sparkdl_fetch_wait_seconds")
    if fam is None:
        return 0.0
    values = fam.snapshot_values()
    if path is not None:
        series = values.get(f'path="{path}"')
        return float(series["sum"]) if series else 0.0
    return float(sum(v["sum"] for v in values.values()))


_POOL: "ThreadPoolExecutor | None" = None
_POOL_LOCK = threading.Lock()


def _readback_pool() -> ThreadPoolExecutor:
    """Bounded fallback pool for leaves that are neither tensors nor host
    arrays.

    Bounded (default 2 workers) so a burst of fallback fetches can never
    fan out into unbounded host threads — the window, not the pool,
    is the in-flight control; the pool only provides *a* background
    thread for the copy."""
    global _POOL
    with _POOL_LOCK:
        if _POOL is None:
            _POOL = ThreadPoolExecutor(
                max_workers=max(
                    1, int(os.environ.get("SPARKDL_TORCH_FETCH_THREADS", "2"))
                ),
                thread_name_prefix="sparkdl-fetch",
            )
        return _POOL


def _leaf_to_host(leaf: Any) -> Any:
    if isinstance(leaf, torch.Tensor):
        # the pinned copy of a CUDA leaf, or a CPU result as it is
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _to_host(tree: Any) -> Any:
    """Every leaf as a host array (a no-op for leaves already there).
    Raises the deferred error of a leaf whose conversion fails."""
    return tree_map(_leaf_to_host, tree)


class FetchTicket:
    """One in-flight device→host fetch. ``result()`` blocks for whatever
    copy time is left, converts to host arrays, and raises the device
    error of THIS batch if its computation failed. Thread-safe and
    idempotent (the resolution is memoized)."""

    __slots__ = ("_path", "_value", "_exc", "_done", "_lock", "_future",
                 "_tree", "_events", "_sources")

    def __init__(self, tree: Any, path: str, future=None, events=(),
                 sources=()):
        self._tree = tree
        self._path = path
        self._future = future  # fallback-pool future, else None
        # one CUDA event per source device, after its copies
        self._events = tuple(events)
        self._sources = sources  # the device leaves, alive until collected
        self._value: Any = None
        self._exc: "BaseException | None" = None
        self._done = False
        self._lock = threading.Lock()

    def result(self, timeout: "float | None" = None) -> Any:
        """Host pytree of this fetch. A timeout raises
        ``concurrent.futures.TimeoutError`` and is NOT terminal — the
        fetch stays collectable (the direct path polls its CUDA event to
        honor the deadline)."""
        with self._lock:
            if not self._done:
                _, wait_hist, inflight = fetch_metrics()
                t0 = time.monotonic()
                finished = True
                try:
                    if self._future is not None:
                        self._value = self._future.result(timeout)
                    else:
                        if self._events:
                            self._wait_ready(
                                None if timeout is None else t0 + timeout)
                        self._value = _to_host(self._tree)
                except FuturesTimeoutError:
                    # the copy is merely not done yet: surface the
                    # timeout but leave the ticket pending/collectable
                    finished = False
                    raise
                except BaseException as e:
                    self._exc = e
                finally:
                    if finished:
                        self._done = True
                        self._tree = None
                        self._sources = ()  # release the device refs
                        now = time.monotonic()
                        wait_hist.observe(now - t0, path=self._path)
                        inflight.dec()
                        tracing.record_span(
                            "fetch.wait", t0, now, path=self._path)
            if self._exc is not None:
                raise self._exc
            return self._value

    def _wait_ready(self, deadline: "float | None") -> None:
        """Wait for this fetch's CUDA events: blocking without a deadline,
        else polling ``query()`` until ``deadline`` (CUDA has no timed
        event wait), so a timed ``result()`` is honored."""
        if deadline is None:
            for event in self._events:
                event.synchronize()
            return
        while not all(event.query() for event in self._events):
            if time.monotonic() >= deadline:
                raise FuturesTimeoutError(
                    "fetch not ready within deadline (its device->host "
                    "copy is still in flight)")
            time.sleep(0.001)

    def _release(self) -> None:
        """Abandonment path (GC of an unresolved ticket): the fetch will
        never be collected — the in-flight gauge must not leak."""
        with self._lock:
            if not self._done:
                self._done = True
                self._tree = None
                self._sources = ()
                fetch_metrics()[2].dec()

    def __del__(self):  # pragma: no cover - GC timing
        try:
            self._release()
        except Exception:
            pass


def start_fetch(tree: Any, *, path: str = "default") -> FetchTicket:
    """Begin a non-blocking device->host copy of ``tree`` and return the
    ticket.

    Every CUDA tensor leaf gets a fresh page-locked host tensor and a
    non-blocking copy into it, enqueued on its own device's current
    stream (the one that produced the output, so the copy starts the
    moment compute finishes); one CUDA event on each source device's
    stream, after its copies, marks them done — a leaf on another card
    than the caller's current one is waited for on ITS stream. CPU
    tensors and host arrays pass through; any other leaf rides the
    bounded readback thread pool.
    """
    fault_point("fetch")
    fetches, _, inflight = fetch_metrics()
    fetches.inc(path=path)
    inflight.inc()
    needs_pool = False
    sources: "list[torch.Tensor]" = []

    def copy(leaf):
        nonlocal needs_pool
        if isinstance(leaf, torch.Tensor):
            if leaf.device.type != "cuda":
                return leaf
            host = torch.empty(leaf.shape, dtype=leaf.dtype, pin_memory=True)
            host.copy_(leaf.detach(), non_blocking=True)
            sources.append(leaf)
            return host
        if not (isinstance(leaf, np.ndarray) or np.isscalar(leaf)):
            needs_pool = True
        return leaf

    host_tree = tree_map(copy, tree)
    events = []
    for device in dict.fromkeys(leaf.device for leaf in sources):
        with torch.cuda.device(device):
            event = torch.cuda.Event()
            event.record()  # the device's current stream: its copies
        events.append(event)
    future = None
    if needs_pool:
        def collect(events=tuple(events)):
            for event in events:
                event.synchronize()
            return _to_host(host_tree)

        future = _readback_pool().submit(collect)
    return FetchTicket(host_tree, path, future, events, tuple(sources))


class AsyncFetcher:
    """Windowed async completion: at most ``window`` results in flight.

    ``submit()`` starts one fetch; the caller keeps the returned tickets
    and resolves them in submission order (the window bound is then the
    caller's deque length — :mod:`~sparkdl_torch.train.finetune` does
    this). :meth:`stream` is the iterator form the batch path uses::

        for host_out in AsyncFetcher(window=8, path="batch").stream(outs):
            ...  # device outputs of up to 8 batches are in flight

    Ordering/error contract (pinned by tests/runtime/test_completion.py):
    results come back in submission order, and an error raised by batch
    i's computation or readback surfaces when result i is collected —
    after results 0..i-1 were delivered, never early at the window edge.
    """

    def __init__(self, *, window: int = 2, path: str = "default"):
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        self.window = window
        self.path = path

    def submit(self, tree: Any) -> FetchTicket:
        return start_fetch(tree, path=self.path)

    def stream(self, outputs: Iterable[Any]) -> Iterator[Any]:
        """Map a device-output iterator to host results, ``window`` deep.

        Pulling from ``outputs`` is what issues the NEXT dispatch (the
        ScanChainer call lives inside the source iterator), so a
        window of W keeps W results' D2H copies overlapping the following
        dispatches while device memory holds at most W result buffers.
        A source-side error (a failed dispatch) is delivered after the
        results submitted before it, on its own batch index.
        """
        pending: "collections.deque[FetchTicket]" = collections.deque()
        it = iter(outputs)
        source_exc: "BaseException | None" = None
        while True:
            try:
                out = next(it)
            except StopIteration:
                break
            except BaseException as e:
                # batches already in flight precede the failed dispatch:
                # deliver them first, then surface the error at ITS index
                source_exc = e
                break
            pending.append(self.submit(out))
            if len(pending) >= self.window:
                yield pending.popleft().result()
        while pending:
            yield pending.popleft().result()
        if source_exc is not None:
            raise source_exc
