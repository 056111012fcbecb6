"""Dynamic micro-batching dispatch loop over a BatchedRunner.

The device-saturation half of the serving engine: individual requests
(one row each) coalesce into the bucketed device batches the batch
pipeline already runs (``transformers/_inference.BatchedRunner``: one
CUDA graph per bucket on the card). Policy is the classic
max-wait/max-batch: the first request in an empty queue waits at most
``max_wait_s`` before dispatch; every request that arrives in that
window rides the same device program for free.

Completion is pipelined: when the runner exposes ``run_batch_async``
(BatchedRunner does), the loop dispatches micro-batch i+1 while
micro-batch i's device→host readback is still in flight, resolving up
to ``max_inflight_batches`` outstanding dispatches in submission order —
assembly and readback hide behind compute instead of serializing with
it.

Robustness contract: a bad request degrades to ITS error, never the
batch's. Extraction failures (shared :func:`try_extract` convention) fail
per request before stacking; a dispatch failure of a multi-row batch
falls back to per-row dispatch so healthy neighbors of a poison row still
get results.
"""

from __future__ import annotations

import collections
import logging
import threading
import time
from typing import Any, Callable

import numpy as np

from sparkdl_torch.observability import tracing
from sparkdl_torch.observability.tracing import span
from sparkdl_torch.serving.metrics import ServingMetrics
from sparkdl_torch.serving.queue import (
    Request,
    RequestQueue,
    record_request_failure,
)
from sparkdl_torch.transformers._inference import BatchedRunner, try_extract

_log = logging.getLogger(__name__)


class _Resolved:
    """Future surface over an already-computed sync ``run_batch`` result
    (the fallback for runner objects without ``run_batch_async``)."""

    __slots__ = ("_value",)

    def __init__(self, value: Any):
        self._value = value

    def result(self, timeout: "float | None" = None) -> Any:
        return self._value


class MicroBatcher:
    """Drains a :class:`RequestQueue` into ``runner.run_batch*`` dispatches.

    ``extract`` (optional) maps a request payload to the feature dict the
    runner eats — same role as the partition path's extract, same
    per-row-error semantics. Without it, payloads must already be feature
    dicts of per-row arrays (no batch dim; the batcher stacks).

    ``max_inflight`` bounds how many dispatched-but-unresolved
    micro-batches the loop keeps in flight (None = the runner's
    ``max_inflight_batches``: 2 for an async runner). 1 restores the strictly serial
    dispatch-then-resolve loop.
    """

    def __init__(self, queue: RequestQueue, runner: BatchedRunner, *,
                 max_wait_s: float = 0.005,
                 extract: Callable[[Any], dict[str, np.ndarray]] | None = None,
                 metrics: ServingMetrics | None = None,
                 max_inflight: "int | None" = None):
        if max_inflight is not None and max_inflight < 1:
            raise ValueError(
                f"max_inflight must be >= 1, got {max_inflight}"
            )
        self.queue = queue
        self.runner = runner
        self.max_wait_s = max_wait_s
        self.extract = extract
        self.metrics = metrics if metrics is not None else ServingMetrics()
        self.max_inflight = (
            max_inflight if max_inflight is not None
            else max(1, getattr(runner, "max_inflight_batches", 1))
        )
        #: dispatched, unresolved batches: (live requests, feeds, future,
        #: trace ctx) in submission order
        self._pending: "collections.deque[tuple]" = collections.deque()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "MicroBatcher":
        self._thread = threading.Thread(
            target=self._loop, name="sparkdl-microbatcher", daemon=True
        )
        self._thread.start()
        return self

    def shutdown(self, *, drain: bool = True,
                 timeout_s: float | None = 30.0) -> None:
        """Stop the loop. ``drain=True`` (graceful): close admission,
        serve everything already queued, then stop. ``drain=False``: fail
        queued requests with EngineClosedError and stop now."""
        self.queue.close()
        if not drain:
            self.queue.fail_pending()
            self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout_s)
            if self._thread.is_alive():  # pragma: no cover - watchdog only
                _log.warning("micro-batcher did not stop in %ss", timeout_s)
        elif drain:  # never started: drain inline so no future is stranded
            while True:
                reqs = self.queue.take(self.runner.chunk_size, 0.0)
                if not reqs:
                    break
                self._dispatch(reqs)
            self._resolve_pending(0)
        self._stop.set()
        # a timed-out join or crashed loop may leave queued requests
        # behind: no Future may ever be left unresolved
        self._fail_inflight()
        self.queue.fail_pending()

    # -- dispatch ------------------------------------------------------------
    def _loop(self) -> None:
        try:
            while not self._stop.is_set():
                if self._pending:
                    # Batches in flight: dispatch ahead ONLY when a full
                    # bucket is already queued (or we are draining) —
                    # otherwise collect the oldest readback first, so the
                    # coalescing window keeps filling underneath exactly
                    # as it did when the dispatch itself blocked. Without
                    # this, pipelining would eagerly grab 2-row batches
                    # and trade occupancy for depth.
                    if (self.queue.closed
                            or self.queue.depth >= self.runner.chunk_size):
                        reqs = self.queue.take(self.runner.chunk_size, 0.0)
                        if reqs:
                            self._dispatch(reqs)
                            continue
                    self._resolve_pending(len(self._pending) - 1)
                    continue
                reqs = self.queue.take(self.runner.chunk_size,
                                       self.max_wait_s)
                if not reqs:
                    if self.queue.closed and self.queue.depth == 0:
                        break  # graceful drain complete
                    continue
                self._dispatch(reqs)
        except BaseException as e:
            # _dispatch contains per-batch error handling; anything that
            # escapes is fatal — fail the queue rather than strand callers
            exc = (e if isinstance(e, Exception)
                   else RuntimeError(f"micro-batcher loop died: {e!r}"))
            self.queue.close()
            self._fail_inflight(exc)
            self.queue.fail_pending(exc)
            raise
        else:
            self._resolve_pending(0)

    def _dispatch(self, reqs: list[Request]) -> None:
        # Batch-level work (one device dispatch, many riders) runs in
        # its OWN trace; the riders' request ids ride every batch span
        # as a `links` list, fanning the batch into each rider's trace
        # (spans_for_trace follows the links both ways).
        batch_ctx = tracing.new_trace_context()  # None with tracing off
        with tracing.attach(batch_ctx):
            self._dispatch_traced(reqs, batch_ctx)

    def _dispatch_traced(self, reqs: list[Request],
                         batch_ctx) -> None:
        links = ([r.request_id for r in reqs]
                 if batch_ctx is not None else ())
        feeds: list[dict[str, np.ndarray]] = []
        live: list[Request] = []
        with span("serving.batch_assemble", requests=len(reqs),
                  links=links):
            for req in reqs:
                feed, err = (try_extract(self.extract, req.payload)
                             if self.extract is not None
                             else (req.payload, None))
                if err is not None:
                    self._finish(req, error=err)
                    continue
                feeds.append(feed)
                live.append(req)
        if not live:
            return
        try:
            fut = self._submit(feeds)
        except Exception as e:
            self._complete_failed(live, feeds, e)
            return
        self._pending.append((live, feeds, fut, batch_ctx))
        self._resolve_pending(self.max_inflight - 1)

    def _submit(self, feeds: list[dict[str, np.ndarray]]):
        """Stack + dispatch one micro-batch; returns a result future.
        Async when the runner supports it (the readback then overlaps
        the next assembly/dispatch), degrading to an already-resolved
        wrapper around the blocking call otherwise."""
        keys = feeds[0].keys()
        if any(f.keys() != keys for f in feeds):
            raise ValueError("requests disagree on feature keys")
        arrays = {k: np.stack([np.asarray(f[k]) for f in feeds]) for k in keys}
        submit_async = getattr(self.runner, "run_batch_async", None)
        if submit_async is not None:
            return submit_async(arrays)
        return _Resolved(self.runner.run_batch(arrays))

    def _resolve_pending(self, limit: int) -> None:
        """Collect completed dispatches (submission order) until at most
        ``limit`` stay in flight."""
        while len(self._pending) > limit:
            live, feeds, fut, ctx = self._pending.popleft()
            with tracing.attach(ctx):
                try:
                    # sparkdl-lint: disable=blocking-in-hot-loop -- resolution is guaranteed: BatchResult resolves with its dispatch; a timeout here would fail healthy slow batches
                    outs = fut.result()
                except Exception as e:
                    self._complete_failed(live, feeds, e)
                    continue
                self.metrics.record_batch(len(live), self.runner.chunk_size)
                for i, req in enumerate(live):
                    self._finish(req, result=_row(outs, i))

    def _complete_failed(self, live: list[Request],
                         feeds: list[dict[str, np.ndarray]],
                         e: Exception) -> None:
        if len(live) == 1:
            self._finish(live[0], error=e)
            return
        # poison-row fallback: one bad row must not take down its
        # batch-mates — retry each row alone, only the culprit errors
        _log.warning(
            "batch of %d failed; retrying per-row", len(live),
            exc_info=True,
        )
        for req, feed in zip(live, feeds):
            # each retry is a real device dispatch: count it, at its
            # honest 1-row occupancy, so a poison-row storm shows up
            # in the metrics instead of hiding behind them
            self.metrics.record_batch(1, self.runner.chunk_size)
            try:
                # sparkdl-lint: disable=blocking-in-hot-loop -- resolution is guaranteed: the one-row retry's BatchResult resolves with its dispatch, as in _resolve_pending; a timeout here would fail a healthy slow row
                out = self._submit([feed]).result()
                self._finish(req, result=_row(out, 0))
            except Exception as row_e:
                self._finish(req, error=row_e)

    def _fail_inflight(self, exc: "Exception | None" = None) -> None:
        """Fail every dispatched-but-unresolved request (crashed loop /
        watchdog shutdown): no Future may be left unresolved."""
        if exc is None:
            from sparkdl_torch.serving.queue import EngineClosedError

            exc = EngineClosedError("engine shut down mid-dispatch")
        while self._pending:
            live, _, fut, _ = self._pending.popleft()
            for req in live:
                if not req.future.done():
                    self._finish(req, error=exc)

    def inflight_request_ids(self) -> "list[int]":
        """Request ids of dispatched-but-unresolved batches (postmortem
        input). Best-effort: the loop thread mutates ``_pending``
        concurrently, and a postmortem must never crash serving."""
        out: "list[int]" = []
        try:
            for live, _feeds, _fut, _ctx in list(self._pending):
                out.extend(r.request_id for r in live)
        except RuntimeError:  # pragma: no cover - mutation race
            pass
        return out

    def _finish(self, req: Request, *, result: Any = None,
                error: Exception | None = None) -> None:
        now = time.monotonic()
        latency = now - req.enqueued
        if tracing.tracing_enabled():
            # the request's terminal span: submit -> resolution, rooted
            # on its own trace (the full lifetime, queue wait included)
            tracing.record_span(
                "serving.request", req.enqueued, now,
                parent=req.trace_ctx, request_id=req.request_id,
                ok=error is None,
                **({"error": type(error).__name__} if error else {}),
            )
        if error is not None:
            # shed load must be observable: every accepted-then-failed
            # request lands in the reason-labelled registry counter
            record_request_failure(error, request_id=req.request_id)
            req.future.set_exception(error)
        else:
            req.future.set_result(result)
        self.metrics.record_request(latency, ok=error is None)
        reg = getattr(self.queue, "tenants", None)
        if reg is not None:
            reg.note_outcome(req.tenant, latency, ok=error is None)


def _row(out, i: int):
    """Row ``i`` of a run_batch output (array or tuple of arrays)."""
    if isinstance(out, tuple):
        return tuple(o[i] for o in out)
    return out[i]
