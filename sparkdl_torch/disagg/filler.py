"""Batch-prefill filler: offline work rides the idle prefill tier.

A prefill tier sized for interactive bursts is idle most of the time —
bursts are bursts. :class:`BatchPrefillFiller` soaks that idle capacity
with background-priority offline requests (batch scoring, evaluation
sweeps) under one hard rule: **offline work never delays a live
prompt.** Admission checks the tier's LIVE queue depth immediately
before every submit and stands down the moment any interactive work is
queued; at most ``max_inflight`` offline requests are outstanding, so
a returning burst waits behind at most that many already-started
prefills (each bounded by one chunked prefill, not a decode span).

``pump()`` is the deterministic single-step form tests drive;
:meth:`start` runs it on a daemon thread at ``interval_s`` cadence.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Iterable, Iterator

from sparkdl_torch.observability import flight
from sparkdl_torch.serving import tenancy

__all__ = ["BatchPrefillFiller"]


class BatchPrefillFiller:
    """Feed ``source`` — an iterable of ``(prompt_ids,
    max_new_tokens)`` pairs — through ``phase_router`` whenever the
    prefill tier is idle. Results (generated-id arrays) land on
    ``on_result(result)`` if given, else collect on :attr:`results`;
    failures count on :attr:`failed` and never retry (offline work is
    re-runnable by nature — the zero-loss contract is for ACCEPTED
    interactive traffic)."""

    def __init__(self, phase_router, source: "Iterable[tuple]", *,
                 max_inflight: int = 2, interval_s: float = 0.02,
                 on_result: "Callable[[Any], None] | None" = None,
                 tenant: str = "offline",
                 priority: int = tenancy.PRIORITY_BACKGROUND):
        if max_inflight < 1:
            raise ValueError(
                f"max_inflight must be >= 1, got {max_inflight}")
        #: offline work rides the LOWEST priority class on the shared
        #: per-tenant scheduler: an interactive arrival is
        #: always served first, and may preempt an offline prefill
        #: between chunks — the filler's own stand-down checks are now
        #: the polite fast path, not the only protection
        self.tenant = tenant
        self.priority = int(priority)
        self.phase_router = phase_router
        self._source: Iterator = iter(source)
        self.max_inflight = max_inflight
        self.interval_s = interval_s
        self._on_result = on_result
        self.results: "list[Any]" = []
        self.submitted = 0
        self.completed = 0
        self.failed = 0
        self._outstanding = 0
        self._pending: "tuple | None" = None
        self._source_dry = False
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: "threading.Thread | None" = None

    # -- one deterministic step ----------------------------------------------
    def pump(self) -> int:
        """Admit as many offline requests as idle capacity allows RIGHT
        NOW; returns how many were submitted. Zero whenever the prefill
        tier has queued work (interactive traffic first) or
        ``max_inflight`` offline requests are already out."""
        n = 0
        while True:
            with self._lock:
                if self._outstanding >= self.max_inflight:
                    return n
                if self._source_dry and self._pending is None:
                    return n
            if tenancy.overload_level() >= tenancy.LEVEL_SHED_BACKGROUND:
                return n  # brownout: offline load is the first shed
            if self.phase_router.tier_depths()["prefill"] > 0:
                return n  # live prompts queued: stand down
            item = self._next_item()
            if item is None:
                return n
            prompt, max_new = item
            try:
                fut = self.phase_router.submit(
                    prompt, max_new,
                    tenant=self.tenant, priority=self.priority)
            except Exception:
                # tier refused (closing/overloaded): hold the item and
                # retry on a later pump — the source is not consumed
                with self._lock:
                    self._pending = item
                return n
            with self._lock:
                self._outstanding += 1
                self.submitted += 1
            fut.add_done_callback(self._done)
            n += 1

    def _next_item(self) -> "tuple | None":
        with self._lock:
            if self._pending is not None:
                item, self._pending = self._pending, None
                return item
            if self._source_dry:
                return None
        try:
            return next(self._source)
        except StopIteration:
            with self._lock:
                self._source_dry = True
            return None

    def _done(self, fut) -> None:
        failed = fut.cancelled() or fut.exception() is not None
        with self._lock:
            self._outstanding -= 1
            if failed:
                self.failed += 1
            else:
                self.completed += 1
        if failed:
            flight.record_event(
                "disagg.filler_request_failed",
                error=(type(fut.exception()).__name__
                       if not fut.cancelled() else "CancelledError"))
            return
        res = fut.result()
        if self._on_result is not None:
            self._on_result(res)
        else:
            self.results.append(res)

    @property
    def drained(self) -> bool:
        """True once the source is exhausted and nothing is in flight."""
        with self._lock:
            return (self._source_dry and self._pending is None
                    and self._outstanding == 0)

    # -- cadence thread -------------------------------------------------------
    def start(self) -> "BatchPrefillFiller":
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return self
            stop = self._stop = threading.Event()
        t = threading.Thread(
            target=self._run, args=(stop,),
            name="sparkdl-disagg-filler", daemon=True)
        with self._lock:
            self._thread = t
        t.start()
        return self

    def _run(self, stop: threading.Event) -> None:
        while not stop.is_set():
            if self.drained:
                return
            self.pump()
            stop.wait(self.interval_s)

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5)
