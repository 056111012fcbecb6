"""Bounded async request queue: admission control, deadlines, backpressure.

The front door of the online serving engine (ROADMAP: "serves heavy
traffic"): callers submit individual requests and get a
``concurrent.futures.Future`` back immediately; the dispatch loop drains
the queue into device batches. Admission is bounded — past ``max_depth``
the submit *raises* (:class:`QueueFullError`) instead of buffering
unboundedly, the reject-with-error backpressure that keeps tail latency
honest under overload (the tf.data lesson: queue growth only moves the
stall, it never removes it). Every request may carry a deadline; expired
requests fail with :class:`DeadlineExceededError` at the next sweep
instead of wasting a batch slot.

Multi-tenant QoS: every request carries a ``tenant`` and an
integer ``priority`` class (lower = more urgent; the defaults reproduce
the old single-FIFO behavior bitwise). Internally the queue is a set of
per-(priority, tenant) sub-queues: :meth:`take` serves classes in
strict priority order and tenants *within* a class by deficit-weighted
round-robin (weights from an attached
:class:`~sparkdl_torch.serving.tenancy.TenantRegistry`), so one tenant's
deep backlog cannot monopolize micro-batch slots. The registry — when
attached — also gates admission: an over-quota submit raises
:class:`~sparkdl_torch.serving.tenancy.TenantThrottledError` at the door,
before consuming queue depth, and the process-wide brownout ladder
(:class:`~sparkdl_torch.serving.tenancy.OverloadController`) may shed the
background class or everything. :meth:`requeue` returns a request to
the head of ITS OWN class — a deferred or preempted background victim
re-enters ahead of its class-mates but never jumps an interactive
tenant.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
from concurrent.futures import Future
from typing import Any, Callable, Iterator

from sparkdl_torch.observability import flight, tracing
from sparkdl_torch.observability.registry import GaugeShare, registry
from sparkdl_torch.serving import tenancy

# Registry mirrors of the queue's own counters (the spine sees
# admission control without asking each engine for its snapshot). Family
# handles are import-time singletons; registry().reset() zeroes values
# but keeps declarations, so these never go stale.
_M_SUBMITTED = registry().counter(
    "sparkdl_queue_submitted_total", "requests admitted to a RequestQueue")
_M_REJECTED = registry().counter(
    "sparkdl_queue_rejected_total", "admission rejects (queue at max depth)")
_M_EXPIRED = registry().counter(
    "sparkdl_queue_expired_total", "requests whose deadline passed in queue")
_M_CANCELLED = registry().counter(
    "sparkdl_queue_cancelled_total", "requests cancelled by their caller")
_M_DEPTH = registry().gauge(
    "sparkdl_queue_depth", "currently queued requests, all queues")
_M_WAIT = registry().histogram(
    "sparkdl_queue_wait_seconds", "queue wait, submit to take")
_M_REQUEUED = registry().counter(
    "sparkdl_queue_requeued_total",
    "taken requests returned to the queue head (deferred admission, "
    "e.g. KV block-pool exhaustion)")
_M_FAILED = registry().counter(
    "sparkdl_requests_failed_total",
    "accepted requests that resolved with an error, by reason "
    "(closed/expired/replica_lost/retry_exhausted/error)",
    labels=("reason",))


class QueueFullError(RuntimeError):
    """Admission reject: queue at max depth (backpressure — retry later)."""


class DeadlineExceededError(TimeoutError):
    """The request's deadline passed before a result was produced."""


class EngineClosedError(RuntimeError):
    """Submit after close(): the engine is draining or stopped."""


def failure_reason(exc: BaseException) -> str:
    """Classify a request-failing exception for the shed-load counter.

    Name-based matches keep this module import-light: the replica-pool
    and retry errors live in modules this one must not depend on.
    """
    if isinstance(exc, EngineClosedError):
        return "closed"
    if isinstance(exc, DeadlineExceededError):
        return "expired"
    name = type(exc).__name__
    if name in ("AllReplicasQuarantinedError", "HungDispatchError"):
        return "replica_lost"
    if name == "RetryExhaustedError":
        return "retry_exhausted"
    return "error"


def record_request_failure(exc: BaseException,
                           request_id: "int | None" = None) -> None:
    """Land one failed-request outcome in the registry
    (``sparkdl_requests_failed_total{reason=...}``) and the flight
    recorder so shed load is observable — called by every path that
    fails an accepted request's Future (queue sweeps, drains, and the
    micro-batcher)."""
    reason = failure_reason(exc)
    _M_FAILED.inc(reason=reason)
    flight.record_event(
        "request.failed", reason=reason, error=type(exc).__name__,
        request_id=request_id,
    )


@dataclasses.dataclass
class Request:
    """One queued unit of work. ``deadline`` is absolute ``time.monotonic``
    seconds (None = no deadline); ``enqueued`` stamps queue-wait metrics.
    ``request_id`` is the process-unique id submit allocated (also the
    caller-visible ``future.request_id`` and, with tracing on, the
    request's trace id); ``trace_ctx`` is the root span context of that
    trace (None with tracing off — the id is the only per-request cost),
    carried across thread boundaries so every stage span of this request
    lands in its trace."""

    payload: Any
    future: Future
    deadline: float | None
    enqueued: float
    trace_ctx: "tracing.SpanContext | None" = None
    request_id: int = 0
    #: the submitter's ambient span at submit time (None with tracing
    #: off or a span-less caller): its trace id rides the queue-wait
    #: span's links, joining the caller's trace to the request's
    submitter_ctx: "tracing.SpanContext | None" = None
    #: True once take() moved the Future to RUNNING. A deferred request
    #: (requeue()) comes back with ``started`` set, so the next take
    #: skips the set_running handshake (a Future runs only once) and
    #: the caller can no longer cancel it — it was already admitted.
    started: bool = False
    #: monotonic stamp of the FIRST take (set alongside ``started``):
    #: the queue-wait/compute phase boundary the per-request latency
    #: attribution differences against — a deferred retake
    #: keeps the original stamp, matching the wait histogram's
    #: first-take-only policy.
    taken_at: "float | None" = None
    #: tenant identity: scopes quota, fair-share weight, and
    #: per-tenant accounting. The default tenant — unconfigured — is
    #: the bitwise-compatible single-user path.
    tenant: str = "default"
    #: priority class (lower = more urgent): classes are served in
    #: strict order, and requeue/extract preserve class membership so
    #: a background victim can never jump an interactive tenant.
    priority: int = 0

    def expired(self, now: float | None = None) -> bool:
        return (self.deadline is not None
                and (now if now is not None else time.monotonic())
                >= self.deadline)

    def fail_expired(self) -> None:
        exc = DeadlineExceededError(
            f"deadline exceeded after "
            f"{time.monotonic() - self.enqueued:.3f}s in queue"
        )
        if self.started:
            # already RUNNING (a deferred admission): fail directly
            record_request_failure(exc, request_id=self.request_id)
            self.future.set_exception(exc)
        elif self.future.set_running_or_notify_cancel():
            # a future the caller already cancelled cannot take an
            # exception — the handshake filters those
            record_request_failure(exc, request_id=self.request_id)
            self.future.set_exception(exc)


class _OneClass:
    """One priority class: per-tenant FIFO deques + DRR rotation state
    (mutated only under the owning queue's condition lock)."""

    __slots__ = ("queues", "order", "ptr", "credit")

    def __init__(self):
        self.queues: "dict[str, collections.deque[Request]]" = {}
        self.order: "list[str]" = []  # rotation order (arrival order)
        self.ptr = 0
        self.credit: "dict[str, float]" = {}


class _FairQueue:
    """Strict-priority classes, deficit-weighted round-robin tenants.

    The drop-in replacement for the queue's old single deque: with one
    tenant in one class (the default path) every operation degenerates
    to the exact FIFO it replaced. ``weight_of`` maps a tenant to its
    DRR share (>= 1; a weight-2 tenant drains two requests per
    rotation visit for a weight-1 tenant's one). Unit-cost DRR: each
    visit tops the tenant's credit up by its weight and serves while
    credit lasts, so fractional weights never stall the rotation.
    Iteration (and :meth:`drain`) walks classes in priority order and
    tenants in rotation order — the class-preserving transfer order
    ``extract_pending`` hands to a surviving host.
    """

    __slots__ = ("_classes", "_weight_of", "_n")

    def __init__(self, weight_of: "Callable[[str], float]"):
        self._classes: "dict[int, _OneClass]" = {}
        self._weight_of = weight_of
        self._n = 0

    def __len__(self) -> int:
        return self._n

    def _class(self, priority: int) -> _OneClass:
        cls = self._classes.get(priority)
        if cls is None:
            cls = self._classes[priority] = _OneClass()
        return cls

    def _enqueue(self, req: Request, *, left: bool) -> None:
        cls = self._class(req.priority)
        q = cls.queues.get(req.tenant)
        if q is None:
            q = cls.queues[req.tenant] = collections.deque()
            cls.order.append(req.tenant)
        (q.appendleft if left else q.append)(req)
        self._n += 1

    def append(self, req: Request) -> None:
        self._enqueue(req, left=False)

    def appendleft(self, req: Request) -> None:
        """Head of the request's OWN class — a requeued victim re-enters
        ahead of its class-mates, never ahead of a more urgent class."""
        self._enqueue(req, left=True)

    def popnext(self) -> "Request | None":
        """Next request: most urgent non-empty class, DRR tenant pick."""
        for priority in sorted(self._classes):
            cls = self._classes[priority]
            req = self._pop_class(cls)
            if req is not None:
                if not cls.queues:
                    del self._classes[priority]
                self._n -= 1
                return req
            del self._classes[priority]
        return None

    def _pop_class(self, cls: _OneClass) -> "Request | None":
        while cls.order:
            idx = cls.ptr % len(cls.order)
            tenant = cls.order[idx]
            q = cls.queues.get(tenant)
            if not q:
                # drained tenant leaves the rotation; credit resets —
                # an idle tenant must not bank a burst of turns
                cls.order.pop(idx)
                cls.queues.pop(tenant, None)
                cls.credit.pop(tenant, None)
                continue
            credit = cls.credit.get(tenant, 0.0)
            if credit < 1.0:
                credit += max(1.0, self._weight_of(tenant))
            credit -= 1.0
            req = q.popleft()
            if credit < 1.0:
                cls.ptr = idx + 1
            cls.credit[tenant] = credit
            return req
        return None

    def highest_priority(self) -> "int | None":
        """Most urgent class with queued work (None when empty) — the
        engine's preemption test reads this without popping."""
        live = [p for p, cls in self._classes.items()
                if any(cls.queues.values())]
        return min(live) if live else None

    def __iter__(self) -> "Iterator[Request]":
        for priority in sorted(self._classes):
            cls = self._classes[priority]
            order = [t for t in cls.order if cls.queues.get(t)]
            if order:
                pivot = cls.ptr % len(order)
                order = order[pivot:] + order[:pivot]
            for tenant in order:
                yield from cls.queues.get(tenant, ())

    def drain(self) -> "list[Request]":
        """Remove and return everything, class order preserved."""
        out = list(self)
        self.clear()
        return out

    def clear(self) -> None:
        self._classes.clear()
        self._n = 0

    def sweep(self, keep: "Callable[[Request], bool]") -> "list[Request]":
        """Drop (and return) every request failing ``keep``, in place —
        per-tenant FIFO order and DRR state untouched for survivors."""
        removed: "list[Request]" = []
        for priority in list(self._classes):
            cls = self._classes[priority]
            for tenant, q in list(cls.queues.items()):
                live = [r for r in q if keep(r)]
                if len(live) != len(q):
                    removed.extend(r for r in q if not keep(r))
                    q.clear()
                    q.extend(live)
        self._n -= len(removed)
        return removed


class RequestQueue:
    """Thread-safe bounded multi-class queue of :class:`Request`.

    ``submit`` is the producer side (any number of caller threads);
    ``take`` is the consumer side (the dispatch loop). Expired requests
    are swept — failed with DeadlineExceededError, never handed to the
    batcher — on every take, and on submit when at capacity (so a full
    queue of dead requests does not reject live traffic).

    ``tenants`` (a :class:`~sparkdl_torch.serving.tenancy.TenantRegistry`,
    settable any time) turns on per-tenant admission quotas and DRR
    weights; without it every tenant passes freely at weight 1 and the
    single default class is an exact FIFO — the pre-tenancy behavior.
    """

    def __init__(self, max_depth: int = 256,
                 tenants: "tenancy.TenantRegistry | None" = None):
        if max_depth < 1:
            raise ValueError(f"max_depth must be >= 1, got {max_depth}")
        self.max_depth = max_depth
        #: per-tenant quota/weight policy (None = no tenancy: the
        #: bitwise-compatible default). Plain attribute: operators may
        #: attach/replace a registry on a live queue.
        self.tenants = tenants
        self._dq = _FairQueue(self._tenant_weight)
        self._cv = threading.Condition()
        self._closed = False
        #: the gauge carries the SUM over all live queues: each queue
        #: contributes deltas of its own depth (registry.GaugeShare —
        #: the same reset-safe pattern the KV block pool uses)
        self._depth_share = GaugeShare(_M_DEPTH)
        #: monotonically increasing counters (read under no lock: ints)
        self.submitted = 0
        self.rejected = 0
        self.expired = 0
        self.cancelled = 0
        self.requeued = 0

    def _tenant_weight(self, tenant: str) -> float:
        reg = self.tenants
        return reg.weight(tenant) if reg is not None else 1.0

    def _update_depth_locked(self) -> None:
        """Push this queue's depth change to the shared gauge as a delta
        (called under ``self._cv``)."""
        self._depth_share.set(len(self._dq))

    @property
    def depth(self) -> int:
        return len(self._dq)

    def highest_waiting_priority(self) -> "int | None":
        """Most urgent class with queued work (None when empty) — the
        engine's preemption test: when this is strictly more urgent
        than an in-flight background prefill and no slot is free, the
        engine may preempt."""
        with self._cv:
            return self._dq.highest_priority()

    def pending_request_ids(self) -> "list[int]":
        """Request ids currently queued (flight-recorder postmortems
        resolve these to in-flight traces)."""
        with self._cv:
            return [r.request_id for r in self._dq]

    @property
    def closed(self) -> bool:
        return self._closed

    def submit(self, payload: Any, *,
               timeout_s: float | None = None,
               tenant: str = "default",
               priority: "int | None" = None) -> Future:
        """Enqueue; returns the request's Future. Raises
        :class:`QueueFullError` at capacity (after sweeping expired
        entries) and :class:`EngineClosedError` after close().

        ``tenant``/``priority`` scope the request for quota and
        scheduling: with a :attr:`tenants` registry attached
        an over-quota submit raises
        :class:`~sparkdl_torch.serving.tenancy.TenantThrottledError`
        BEFORE consuming queue depth, and the process-wide brownout
        ladder may shed it
        (:class:`~sparkdl_torch.serving.tenancy.BrownoutShedError`) —
        both typed admission rejects, never timeouts. ``priority=None``
        resolves to the tenant's configured default class, else the
        interactive class 0. Quota sheds do NOT count into
        ``sparkdl_queue_rejected_total`` — a flooder's shed overage
        must not burn the fleet availability SLO the compliant tenants
        are measured by (it lands in ``sparkdl_tenant_shed_total``).

        Submit vs a concurrent ``close()`` is deterministic: both take
        the queue's condition lock, so a submit either wins the race (its
        request was accepted and WILL be drained — ``close()`` keeps
        queued work takeable) or raises ``EngineClosedError`` — never a
        silently dropped Future (pinned by tests).

        The returned Future carries ``request_id`` — the process-unique
        id that doubles as the request's trace id
        (``ServingEngine.trace(fut.request_id)`` replays its spans when
        tracing is on)."""
        now = time.monotonic()
        deadline = now + timeout_s if timeout_s is not None else None
        reg = self.tenants
        prio = priority
        if prio is None and reg is not None:
            prio = reg.default_priority(tenant)
        if prio is None:
            prio = tenancy.PRIORITY_INTERACTIVE
        # tenancy gates run BEFORE the queue lock (they take the
        # registry's own lock) and before depth is consumed: shed
        # traffic never holds a slot it is not getting
        ctrl = tenancy.process_overload()
        if ctrl is not None:
            try:
                ctrl.admission_check(tenant, prio)
            except tenancy.BrownoutShedError:
                if reg is not None:
                    reg.count_shed(tenant)
                raise
        if reg is not None:
            reg.admit(tenant, now,
                      cost=ctrl.admit_cost() if ctrl is not None else 1.0)
        rid = tracing.next_request_id()
        with self._cv:
            if self._closed:
                raise EngineClosedError("queue is closed to new requests")
            if len(self._dq) >= self.max_depth:
                self._sweep_expired_locked(now)
            if len(self._dq) >= self.max_depth:
                self.rejected += 1
                _M_REJECTED.inc()
                raise QueueFullError(
                    f"queue at max depth {self.max_depth}; retry with "
                    "backoff or raise capacity"
                )
            fut: Future = Future()
            fut.request_id = rid
            self._dq.append(Request(
                payload, fut, deadline, now,
                trace_ctx=tracing.request_context(rid),
                request_id=rid,
                submitter_ctx=tracing.current_context(),
                tenant=tenant, priority=prio,
            ))
            self.submitted += 1
            _M_SUBMITTED.inc()
            self._update_depth_locked()
            self._cv.notify()
            return fut

    def take(self, max_n: int, max_wait_s: float) -> list[Request]:
        """Dispatch-side drain: block up to ``max_wait_s`` for the first
        live request, then return every immediately-available live request
        up to ``max_n`` (the micro-batching max-wait/max-batch policy —
        the first arrival pays at most ``max_wait_s`` extra latency,
        followers ride along for free). Returns [] on timeout or close.

        Requests whose Future was cancelled by the caller are dropped;
        expired requests are failed and skipped.
        """
        if max_n < 1:
            return []
        end = time.monotonic() + max_wait_s
        out: list[Request] = []
        fresh: list[Request] = []
        with self._cv:
            while not self._dq and not self._closed:
                remaining = end - time.monotonic()
                if remaining <= 0:
                    return []
                self._cv.wait(remaining)
            now = time.monotonic()
            while self._dq and len(out) < max_n:
                req = self._dq.popnext()
                if req is None:
                    break
                if req.expired(now):
                    self.expired += 1
                    _M_EXPIRED.inc()
                    req.fail_expired()
                    continue
                # a caller that cancelled its Future no longer wants the
                # result; set_running_or_notify_cancel is the handshake
                # (skipped for requeued requests — already RUNNING)
                if not req.started:
                    if not req.future.set_running_or_notify_cancel():
                        self.cancelled += 1
                        _M_CANCELLED.inc()
                        continue
                    req.started = True
                    req.taken_at = now
                    fresh.append(req)
                out.append(req)
            self._update_depth_locked()
        # wait metrics/spans on the FIRST take only: a deferred request
        # is retaken once per engine tick, and re-observing its
        # cumulative wait each time would inflate the histogram and
        # flood the span ring exactly during the exhaustion incident
        for req in fresh:
            _M_WAIT.observe(now - req.enqueued)
            # retroactive span: the wait started at submit, long before
            # this instrumentation point, parented on the request's
            # root; the submitter's trace rides the links so a caller's
            # own span ("client_call") still reaches the request trace
            # via spans_for_trace(caller_trace_id)
            sub = req.submitter_ctx
            tracing.record_span(
                "serving.queue_wait", req.enqueued, now,
                parent=req.trace_ctx, request_id=req.request_id,
                **({"links": [sub.trace_id]} if sub is not None else {}),
            )
        return out

    def close(self) -> None:
        """Stop admission (submit raises EngineClosedError); queued
        requests stay takeable so the engine can drain gracefully."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()

    def fail_pending(self, exc: BaseException | None = None) -> int:
        """Fail every queued request (non-graceful shutdown). Returns the
        number failed. Each failure lands in
        ``sparkdl_requests_failed_total`` under the exception's reason
        (``closed`` for the default shutdown error)."""
        if exc is None:
            exc = EngineClosedError("engine shut down before dispatch")
        n = 0
        with self._cv:
            for req in self._dq.drain():
                if req.started or req.future.set_running_or_notify_cancel():
                    record_request_failure(exc, request_id=req.request_id)
                    req.future.set_exception(exc)
                else:
                    self.cancelled += 1
                    _M_CANCELLED.inc()
                n += 1
            self._update_depth_locked()
        return n

    def requeue(self, requests: "list[Request]") -> None:
        """Return taken requests to the head of their OWN CLASS, in
        order — deferred admission (the engine took them but cannot
        place them yet, e.g. the KV block pool is exhausted) and
        priority preemption (the victim re-enters ahead of its
        class-mates). Head-of-class, not head-of-global-FIFO
       : a requeued background victim is retaken before
        everything ITS class submitted after it, but an interactive
        tenant's queued work still goes first — failover/preemption
        cannot let background work jump the interactive classes. With
        one tenant in one class (the default path) this is exactly the
        old head-of-queue semantics. Works on a closed queue: the
        requests were admitted before close() and close keeps queued
        work takeable.

        The requests need not have come from THIS queue: a drained or
        failed host's unstarted requests (``extract_pending`` on the
        dying queue) are handed to a surviving queue through this same
        call — the :class:`Request` carries its trace id, absolute
        deadline, and ``started`` flag, so nothing about the request's
        identity or accounting resets on transfer. The transfer itself
        is NOT a failure: no Future is touched and nothing lands in
        ``sparkdl_requests_failed_total`` — if the re-routed request
        later fails it is counted once, by its new owner (and if it
        succeeds, it was never counted at all). A transfer may
        transiently push this queue past ``max_depth`` (bounded by the
        dying queue's depth); admission control applies to NEW submits
        only — already-accepted traffic is never re-rejected."""
        if not requests:
            return
        with self._cv:
            for req in reversed(requests):
                self._dq.appendleft(req)
            self.requeued += len(requests)
            _M_REQUEUED.inc(len(requests))
            self._update_depth_locked()
            self._cv.notify_all()

    def adopt(self, req: Request) -> None:
        """Enqueue an ALREADY-ACCEPTED request at the tail — the
        cross-tier admission primitive: a decode tier adopts
        a request whose prefill finished on another tier. Unlike
        :meth:`submit` there is no depth check and no new Future — the
        request was admitted (and counted) once, at the prefill tier's
        front door, and re-rejecting accepted traffic would break the
        zero-loss contract exactly like re-rejecting a transfer would
        (see :meth:`requeue`). Unlike :meth:`requeue` the request joins
        at the TAIL: it is new work for THIS tier, not deferred work
        this tier owes. Raises :class:`EngineClosedError` on a closed
        queue — a HOST-level error, so a router fails over to another
        decode host instead of losing the handoff."""
        with self._cv:
            if self._closed:
                raise EngineClosedError(
                    "queue is closed to new requests")
            self._dq.append(req)
            self.submitted += 1
            _M_SUBMITTED.inc()
            self._update_depth_locked()
            self._cv.notify()

    def reopen(self) -> None:
        """Reverse :meth:`close`: accept new submits again — the
        spare-host rejoin path: a handle drained and parked
        by the autoscaler re-enters service via ``Router.add_host``.
        Only meaningful while the owning engine's loop is still (or
        again) running; queued state is untouched."""
        with self._cv:
            self._closed = False
            self._cv.notify_all()

    def extract_pending(self) -> "list[Request]":
        """Remove and return every queued request WITHOUT resolving its
        Future — the drain/transfer primitive: a draining or
        dying host extracts its not-yet-placed requests here and hands
        them to a surviving host's queue via :meth:`requeue`. Futures,
        trace ids, deadlines, and ``started`` flags ride along
        untouched, and nothing is recorded as failed — the requests are
        moving, not dying. Deferred requests (``started=True``, taken
        once then re-queued on pool exhaustion) are included: they hold
        no device state, so they transfer as cleanly as fresh ones.
        Call after :meth:`close` so no new submit races the drain.

        Order is class-preserving: requests come out most
        urgent class first, tenants within a class in their rotation
        order — so a surviving host's :meth:`requeue` (which re-inserts
        head-of-own-class) reproduces the same relative schedule the
        dying host owed, and a background victim cannot jump an
        interactive tenant through failover."""
        with self._cv:
            out = self._dq.drain()
            self._update_depth_locked()
        return out

    def sweep_expired(self) -> None:
        """Fail every expired queued request now. take() sweeps anyway;
        engines call this when they are NOT taking (all slots busy) so a
        dead request's caller hears promptly instead of at the next free
        slot."""
        with self._cv:
            self._sweep_expired_locked(time.monotonic())

    def _sweep_expired_locked(self, now: float) -> None:
        for r in self._dq.sweep(lambda r: not r.expired(now)):
            self.expired += 1
            _M_EXPIRED.inc()
            r.fail_expired()
        self._update_depth_locked()
