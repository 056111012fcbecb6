"""Multi-replica serving: one pinned executor per card.

The port of ``sparkdl_tpu.serving.replicas``. A :class:`ReplicaPool`
gives each card its OWN pinned
:class:`~sparkdl_torch.transformers._inference.BatchedRunner` — own
CUDA graphs, own buckets, own ChainPolicy — and routes assembled
micro-batches whole to the replica with the least outstanding work. N
cards serve N micro-batches concurrently; every replica runs the same
program on the same rows, so a pool's rows are bitwise those of one
runner (on the card under deterministic cuDNN algorithms: two replicas
may otherwise pick different convolution algorithms for one shape).
More replicas than cards round-robin the cards: replicas that share a
card serve concurrently from their own threads, and their CUDA-graph
captures take turns (:mod:`sparkdl_torch.runtime.dispatch`).

Contracts:

- **Routing**: least-outstanding-work (queued + running batches), ties
  broken round-robin. Per-replica depth/latency land in the metrics
  spine (``sparkdl_replica_depth{replica=...}``,
  ``sparkdl_replica_batch_seconds{replica=...}``).
- **Failure isolation with rider protection**: a batch whose executor
  fails is **re-routed once** to a different replica before its riders
  ever see an error (``sparkdl_retries_total{site="replica.execute"}``
  counts it); only a second failure surfaces. The micro-batcher's
  poison-row fallback then still retries rows individually.
- **Quarantine is a circuit breaker, not a death sentence**:
  ``max_failures`` *consecutive* executor failures quarantine the
  replica — it stops taking work, its queue re-routes — but after
  ``probation_s`` it receives ONE probation probe (a live batch, rider
  protected by the re-route). Probe success reintegrates the replica
  (``sparkdl_replica_reintegrated_total``); probe failure doubles the
  backoff up to ``probation_max_s``. Only an all-quarantined,
  none-probeable pool refuses work.
- **Hung-dispatch watchdog**: with ``dispatch_timeout_s`` set, a
  dispatch that exceeds the deadline is taken away from its replica —
  re-routed under the same rider protection as an executor error, so
  :class:`HungDispatchError` only surfaces once re-routes are exhausted
  — and the replica is quarantined as hung
  (``sparkdl_replica_hung_total``) instead of wedging the pool. The
  hung-freeze (no probation probes) lifts as soon as the wedged program
  resolves either way: a late success rejoins the replica directly, a
  late error re-enters the normal probation cycle.
- **Drain**: ``close(drain=True)`` serves every accepted batch before
  stopping; ``drain=False`` fails queued batches immediately.
- **Elasticity**: ``add_replica``/``remove_replica`` resize the pool at
  runtime. Scale-down is drain-safe (unstarted work re-routes to
  survivors, the in-flight batch finishes on the victim) and carries the
  ``replica.scale_down`` fault site so chaos plans can abort a scale
  event before it moves state. The quarantine/probation machinery is
  :class:`~sparkdl_torch.reliability.breaker.ProbationBreaker`.

Drop-in: the pool exposes ``run_batch`` / ``run_batch_async`` /
``chunk_size``, so ``ServingEngine(ReplicaPool(...))`` works unchanged
— the micro-batcher keeps up to ``max_inflight_batches`` (= healthy
replicas + 1) dispatches in flight so every card stays busy.
"""

from __future__ import annotations

import logging
import queue as queue_mod
import threading
import time
from concurrent.futures import TimeoutError as FuturesTimeoutError
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from sparkdl_torch.observability import flight
from sparkdl_torch.observability.metrics import StepMeter
from sparkdl_torch.observability.registry import registry
from sparkdl_torch.observability.tracing import attach, current_context, span
from sparkdl_torch.ops._dispatch import resolve_device
from sparkdl_torch.reliability.breaker import ProbationBreaker
from sparkdl_torch.reliability.faults import fault_point
from sparkdl_torch.reliability.retry import record_retry
from sparkdl_torch.transformers._inference import BatchedRunner

__all__ = [
    "AllReplicasQuarantinedError",
    "HungDispatchError",
    "ReplicaPool",
]

_log = logging.getLogger(__name__)

_METRICS = None


class _PoolMetrics(NamedTuple):
    """Lazy spine handles; the first three are labelled by replica."""

    depth: Any
    batch_seconds: Any
    batches: Any
    quarantined: Any
    reintegrated: Any
    hung: Any


def _metrics() -> _PoolMetrics:
    global _METRICS
    if _METRICS is None:
        _METRICS = _PoolMetrics(
            depth=registry().gauge(
                "sparkdl_replica_depth",
                "batches queued+running on each serving replica",
                labels=("replica",)),
            batch_seconds=registry().histogram(
                "sparkdl_replica_batch_seconds",
                "per-replica batch wall time, dispatch to host result",
                labels=("replica",)),
            batches=registry().counter(
                "sparkdl_replica_batches_total",
                "batches served by each replica", labels=("replica",)),
            quarantined=registry().counter(
                "sparkdl_replica_quarantined_total",
                "replicas quarantined after repeated executor failures"),
            reintegrated=registry().counter(
                "sparkdl_replica_reintegrated_total",
                "quarantined replicas that rejoined after a successful "
                "probation probe"),
            hung=registry().counter(
                "sparkdl_replica_hung_total",
                "dispatches failed by the hung-dispatch watchdog"),
        )
    return _METRICS


class AllReplicasQuarantinedError(RuntimeError):
    """Every replica in the pool is quarantined and none is due a
    probation probe; the pool cannot accept work right now."""


class HungDispatchError(TimeoutError):
    """A dispatch exceeded the pool's ``dispatch_timeout_s`` deadline
    and was failed by the watchdog (its replica is quarantined as
    hung)."""


class _Work:
    """One routed micro-batch: arrays in, Future-like out.

    Resolution is idempotent (``finish``/``fail`` first-writer-wins):
    the hung-dispatch watchdog may fail a batch whose wedged executor
    later completes it — the late result is discarded, never raced.
    """

    __slots__ = ("arrays", "result", "exc", "done", "retries", "probe",
                 "reroutable", "owner", "started_at", "trace_ctx", "_lock")

    def __init__(self, arrays: dict[str, np.ndarray]):
        self.arrays = arrays
        #: the dispatching batch's trace context (captured at submit so
        #: the replica worker's spans land in the riders' linked trace)
        self.trace_ctx = None
        self.result: Any = None
        self.exc: "BaseException | None" = None
        self.done = threading.Event()
        #: re-routes consumed (rider protection: at most max_reroutes)
        self.retries = 0
        #: replica currently responsible for resolving this work. The
        #: watchdog re-routes work whose executor is WEDGED (still
        #: running), so two replicas can hold the same work — only the
        #: owner's FAILURE may resolve it (a stale success is harmless:
        #: same program, same arrays, identical payload).
        self.owner: "object | None" = None
        #: warmup pins work to ONE replica: re-routing its batch would
        #: mask that replica's compile failure as a pool-wide success
        self.reroutable = True
        #: this routing is a probation probe of a quarantined replica
        self.probe = False
        #: monotonic start of the in-flight dispatch (watchdog input)
        self.started_at: "float | None" = None
        self._lock = threading.Lock()

    def finish(self, result: Any) -> None:
        with self._lock:
            if self.done.is_set():
                return  # watchdog got here first: late result discarded
            self.result = result
            self.done.set()

    def fail(self, exc: BaseException) -> None:
        with self._lock:
            if self.done.is_set():
                return
            self.exc = exc
            self.done.set()

    # Future-like surface (what MicroBatcher/BatchResult callers use)
    def wait_result(self, timeout: "float | None" = None):
        if not self.done.wait(timeout):
            # same exception type BatchResult raises (they are distinct
            # classes on 3.10): pool and single-runner futures must be
            # interchangeable to caller retry logic
            raise FuturesTimeoutError("replica batch still in flight")
        if self.exc is not None:
            raise self.exc
        return self.result


class _PoolFuture:
    """Caller handle for one pool dispatch (matches
    :class:`~sparkdl_torch.transformers._inference.BatchResult`'s
    ``result()`` surface)."""

    __slots__ = ("_work",)

    def __init__(self, work: _Work):
        self._work = work

    def result(self, timeout: "float | None" = None):
        return self._work.wait_result(timeout)


class _Replica:
    """One device's executor: pinned runner + worker thread + queue."""

    def __init__(self, index: int, device: Any, runner: BatchedRunner,
                 pool: "ReplicaPool"):
        self.index = index
        self.device = device
        self.runner = runner
        self.pool = pool
        self.queue: "queue_mod.Queue[_Work | None]" = queue_mod.Queue()
        #: queued + running batches (the routing signal), under pool lock
        self.outstanding = 0
        self.dispatched = 0
        #: the shared quarantine/probation state machine (mutated under
        #: the pool lock — reliability.breaker is the one implementation
        #: this pool and the fabric router both run)
        self.breaker = ProbationBreaker(
            max_failures=pool.max_failures,
            probation_s=pool.probation_s,
            probation_max_s=pool.probation_max_s,
        )
        #: quarantined because the watchdog caught a wedged dispatch:
        #: no probation probes until the wedged program resolves (probing
        #: would queue live work behind a stuck thread)
        self.hung = False
        #: the in-flight work item, if any (watchdog scan target)
        self.current_work: "_Work | None" = None
        self.latency = StepMeter(n_chips=1, window=256, warmup_steps=0)
        self.thread = threading.Thread(
            target=self._loop, name=f"sparkdl-replica-{index}", daemon=True
        )
        self.thread.start()

    # breaker state read-throughs (tests and snapshots read these; all
    # WRITES go through the breaker's transition verbs under pool lock)
    @property
    def quarantined(self) -> bool:
        return self.breaker.quarantined

    @property
    def probing(self) -> bool:
        return self.breaker.probing

    @property
    def consecutive_failures(self) -> int:
        return self.breaker.consecutive_failures

    @property
    def probation_until(self) -> float:
        return self.breaker.probation_until

    @property
    def probation_backoff_s(self) -> float:
        return self.breaker.probation_backoff_s

    def _loop(self) -> None:
        if self.device.type == "cuda":
            # this thread's kernels and streams belong to its replica's card
            torch.cuda.set_device(self.device)
        m = _metrics()
        depth, wall_hist, batches = m.depth, m.batch_seconds, m.batches
        label = str(self.index)
        while True:
            work = self.queue.get()
            if work is None:
                return
            work.started_at = time.monotonic()
            self.current_work = work
            t0 = time.perf_counter()
            exc: "Exception | None" = None
            result = None
            try:
                # re-root on the batch's trace so the replica span (and
                # the runner's device_step span under it) land in the
                # riders' linked trace
                with attach(work.trace_ctx), \
                        span("serving.replica_batch", replica=self.index):
                    fault_point("replica.execute")
                    result = self.runner.run_batch(work.arrays)
            except BaseException as e:
                exc = e if isinstance(e, Exception) else RuntimeError(
                    f"replica {self.index} executor died: {e!r}"
                )
            wall = time.perf_counter() - t0
            self.dispatched += 1
            self.current_work = None
            with self.pool._lock:
                self.outstanding -= 1
            # the work MUST resolve no matter what the accounting below
            # does — an unresolved _Work strands its caller forever, so
            # even the metrics calls live inside this guard
            try:
                depth.set(self.outstanding, replica=label)
                wall_hist.observe(wall, replica=label)
                batches.inc(replica=label)
                self.latency.record(wall, examples=1)
                if exc is None:
                    self.pool._on_success(self, work)
                    work.finish(result)
                else:
                    self.pool._on_failure(self, work, exc)
            except BaseException as account_exc:  # pragma: no cover
                work.fail(exc if exc is not None else account_exc)
                _log.exception(
                    "replica %d failure accounting raised", self.index
                )


class ReplicaPool:
    """Route micro-batches over one pinned executor per card.

    ``apply_fn``/``batch_size``/``runner_kwargs`` build a
    :class:`BatchedRunner` per device (``partitioner=``
    ``SingleDevicePartitioner(device)``); pass ``make_runner(device) ->
    BatchedRunner`` instead for full control of each replica's
    construction (the failure-injection tests do). ``devices`` defaults
    to every visible card (``cuda:0`` .. ``cuda:N-1``) and raises where
    CUDA is absent — the pool never serves on the CPU unless its caller
    passes CPU devices. Passing more replicas than devices round-robins
    devices ("simulated replicas": N-way routing on one card).

    Reliability knobs: ``max_failures`` consecutive failures open the
    circuit breaker; ``probation_s`` (None disables probes → permanent
    quarantine) schedules the first probation probe, doubling per failed
    probe up to ``probation_max_s``; ``max_reroutes`` bounds
    rider-protecting re-routes per batch; ``dispatch_timeout_s`` (None
    disables) arms the hung-dispatch watchdog.
    """

    def __init__(self, apply_fn: "Callable | None" = None, *,
                 batch_size: int = 64,
                 devices: "list | None" = None,
                 n_replicas: "int | None" = None,
                 make_runner: "Callable[[Any], BatchedRunner] | None" = None,
                 partitioner_factory: "Callable[[Any], Any] | None" = None,
                 max_failures: int = 3,
                 probation_s: "float | None" = 1.0,
                 probation_max_s: float = 30.0,
                 max_reroutes: int = 1,
                 dispatch_timeout_s: "float | None" = None,
                 **runner_kwargs):
        if (apply_fn is None) == (make_runner is None):
            raise ValueError(
                "pass exactly one of apply_fn or make_runner"
            )
        if max_failures < 1:
            raise ValueError(f"max_failures must be >= 1, got {max_failures}")
        if probation_s is not None and probation_s <= 0:
            raise ValueError(
                f"probation_s must be > 0 or None, got {probation_s}"
            )
        if max_reroutes < 0:
            raise ValueError(f"max_reroutes must be >= 0, got {max_reroutes}")
        if dispatch_timeout_s is not None and dispatch_timeout_s <= 0:
            raise ValueError(
                f"dispatch_timeout_s must be > 0 or None, got "
                f"{dispatch_timeout_s}"
            )
        if devices is None:
            resolve_device("cuda")  # raises where CUDA is absent
            devices = [torch.device(f"cuda:{i}")
                       for i in range(torch.cuda.device_count())]
        if n_replicas is None:
            n_replicas = len(devices)
        if n_replicas < 1:
            raise ValueError(f"n_replicas must be >= 1, got {n_replicas}")
        if make_runner is None:
            # one SingleDevicePartitioner per replica by default: the pool
            # scales by REPLICATING single-device executors, never by
            # splitting batches. partitioner_factory(device) swaps in
            # another placement per replica (ROADMAP A8 for the rest).
            from sparkdl_torch.partition import SingleDevicePartitioner

            if partitioner_factory is None:
                partitioner_factory = SingleDevicePartitioner

            def make_runner(device):
                return BatchedRunner(
                    apply_fn, batch_size=batch_size,
                    partitioner=partitioner_factory(device),
                    **runner_kwargs,
                )
        elif partitioner_factory is not None:
            raise ValueError(
                "partitioner_factory configures the DEFAULT runner "
                "construction; with make_runner= the caller owns the "
                "runner (give its BatchedRunner a partitioner directly)"
            )
        self.max_failures = max_failures
        self.probation_s = probation_s
        self.probation_max_s = probation_max_s
        self.max_reroutes = max_reroutes
        self.dispatch_timeout_s = dispatch_timeout_s
        self._lock = threading.Lock()
        self._closed = False
        self._closing = threading.Event()
        self._rr = 0  # round-robin tiebreak cursor
        #: elasticity: add_replica builds new executors from
        #: the same factory/device ring construction used
        self._make_runner = make_runner
        self._devices = list(devices)
        self._next_index = n_replicas
        #: replicas removed by scale-down whose worker has not exited
        #: yet: the watchdog keeps scanning them so an in-flight batch
        #: that wedges AFTER removal still gets deadline-failed
        self._retiring: "list[_Replica]" = []
        #: replicas mid-warmup in add_replica (not yet routable): on the
        #: watchdog scan so a wedged warmup dispatch is deadline-failed
        #: — surfacing from add_replica — instead of blocking it forever
        self._warming: "list[_Replica]" = []
        self.replicas = [
            _Replica(i, devices[i % len(devices)],
                     make_runner(devices[i % len(devices)]), self)
            for i in range(n_replicas)
        ]
        self._worker_ids = {r.thread.ident: r for r in self.replicas}
        # postmortem bundles + /healthz read live quarantine state from
        # this provider (removed at close)
        self._flight_name = flight.add_context_provider(
            f"pool-{id(self):x}", self.snapshot
        )
        flight.record_event(
            "pool.start", pool=self._flight_name,
            replicas=len(self.replicas),
        )
        self._watchdog: "threading.Thread | None" = None
        if dispatch_timeout_s is not None:
            self._watchdog = threading.Thread(
                target=self._watchdog_loop, name="sparkdl-pool-watchdog",
                daemon=True,
            )
            self._watchdog.start()

    # -- the BatchedRunner-compatible surface --------------------------------
    @property
    def chunk_size(self) -> int:
        return self.replicas[0].runner.chunk_size

    @property
    def max_inflight_batches(self) -> int:
        """Dispatches the micro-batcher should keep in flight: one per
        healthy replica plus one assembling."""
        return max(1, sum(not r.quarantined for r in self.replicas)) + 1

    def run_batch_async(self, arrays: dict[str, np.ndarray]) -> _PoolFuture:
        """Route one assembled micro-batch; returns a future resolving
        to the same output ``BatchedRunner.run_batch`` produces."""
        work = _Work(arrays)
        work.trace_ctx = current_context()  # None with tracing off
        self._route(work)
        return _PoolFuture(work)

    def run_batch(self, arrays: dict[str, np.ndarray]):
        """Synchronous dispatch. Called FROM a replica worker thread (the
        micro-batcher's per-row poison fallback resolving inside a
        completion path) it executes inline on that replica instead of
        re-queueing — a self-routed wait would deadlock the worker."""
        me = self._worker_ids.get(threading.get_ident())
        if me is not None:
            return me.runner.run_batch(arrays)
        return self.run_batch_async(arrays).result()

    # -- routing -------------------------------------------------------------
    def _route(self, work: _Work, exclude: "_Replica | None" = None) -> None:
        depth = _metrics().depth
        try:
            with self._lock:
                if self._closed:
                    raise RuntimeError("ReplicaPool is closed")
                replica = self._pick_locked(work, exclude)
                replica.outstanding += 1
                work.owner = replica
                depth.set(replica.outstanding, replica=str(replica.index))
                # the enqueue happens UNDER the pool lock: remove_replica
                # takes this lock to retire a victim, so a routing that
                # picked the victim has finished its put before the
                # drain/shutdown-sentinel sequence starts — work can
                # never land behind the sentinel and strand its caller
                replica.queue.put(work)
        except AllReplicasQuarantinedError:
            # outside the pool lock: the dump's context providers call
            # snapshot(), which takes it again
            flight.record_event(
                "pool.all_quarantined", replicas=len(self.replicas))
            flight.trigger_dump("all_replicas_quarantined")
            raise

    def _pick_locked(self, work: _Work,
                     exclude: "_Replica | None") -> _Replica:
        now = time.monotonic()
        # probation probe: a quarantined (not hung) replica whose backoff
        # elapsed takes this batch as its probe — the rider is protected
        # by the re-route-once retry, so a failed probe costs latency,
        # never a result. First-time routings only: a batch already
        # burned by one replica must land somewhere trustworthy.
        # (max_reroutes=0 disables probes too: a probe's rider is only
        # protected by the re-route, and "a failed probe costs latency,
        # never a result" is the contract.) One documented exception: in
        # an ALL-quarantined pool the probe has no healthy re-route
        # target — but without the probe this rider was getting
        # AllReplicasQuarantinedError anyway (and the pool could never
        # self-heal), so the last-ditch probe can only improve its odds;
        # _retry_or_fail surfaces that same typed error if it fails.
        if (self.probation_s is not None and self.max_reroutes >= 1
                and work.retries == 0):
            for r in self.replicas:
                if (r is not exclude and not r.hung
                        and r.breaker.probe_due(now)):
                    r.breaker.begin_probe()
                    work.probe = True
                    return r
        healthy = [r for r in self.replicas
                   if not r.quarantined and r is not exclude]
        if not healthy:
            if exclude is not None:
                raise RuntimeError(
                    f"no alternative replica to re-route off replica "
                    f"{exclude.index}"
                )
            raise AllReplicasQuarantinedError(
                f"all {len(self.replicas)} replicas quarantined "
                f"(>{self.max_failures} consecutive failures each) and "
                "none is due a probation probe yet"
            )
        # least outstanding work; round-robin among ties so idle
        # replicas share the trickle load instead of replica 0
        # absorbing it all
        best = min(r.outstanding for r in healthy)
        ties = [r for r in healthy if r.outstanding == best]
        replica = ties[self._rr % len(ties)]
        self._rr += 1
        return replica

    # -- success/failure accounting (called from worker threads) -------------
    def _on_success(self, replica: _Replica, work: _Work) -> None:
        rejoined = False
        with self._lock:
            # resolution claim (mirrors _on_failure): a watchdogged
            # dispatch that finally succeeded AFTER its work was
            # re-routed still heals the replica below, but the per-work
            # outcome (the "recovered" retry metric) belongs to the
            # claimant alone — else one re-routed batch counts its
            # recovery twice
            claimed = (work.owner is replica
                       and not work.done.is_set())
            if claimed:
                work.owner = None
            # circuit closes on success: probe success, or a watchdog-
            # flagged dispatch that eventually completed
            rejoined = replica.breaker.record_success()
            if rejoined:
                replica.hung = False
        if rejoined:
            _metrics().reintegrated.inc()
            flight.record_event(
                "replica.reintegrated", replica=replica.index)
            _log.info(
                "replica %d (%s) reintegrated after successful probe; "
                "%d healthy replica(s)",
                replica.index, replica.device,
                sum(not r.quarantined for r in self.replicas),
            )
        if claimed and work.retries:
            record_retry("replica.execute", "recovered")

    def _on_failure(self, replica: _Replica, work: _Work,
                    exc: Exception) -> None:
        now = time.monotonic()
        quarantined_now = False
        with self._lock:
            # resolution claim: the watchdog may have already taken this
            # work away (owner cleared / re-routed elsewhere) — then this
            # failure only feeds the replica accounting below, and the
            # retries/fail decision belongs to the claimant alone
            claimed = (work.owner is replica
                       and not work.done.is_set())
            if claimed:
                work.owner = None
            if replica.hung:
                # the wedged dispatch finally resolved — with an error,
                # but the worker thread is free again: lift the
                # hung-freeze so probation probes can reach the replica
                # (only _on_success closes the circuit entirely)
                replica.hung = False
                replica.breaker.schedule_probe(now)
            was_probe = work.probe and replica.quarantined
            probe_failed = False
            if was_probe:
                # failed probe: stay quarantined, back off exponentially
                replica.breaker.record_probe_failure(now)
                probe_failed = True
                _log.warning(
                    "replica %d probation probe failed; next probe in "
                    "%.2fs", replica.index, replica.probation_backoff_s,
                )
            else:
                quarantined_now = replica.breaker.record_failure(now)
        if probe_failed:
            flight.record_event(
                "replica.probe_failed", replica=replica.index,
                next_probe_s=round(replica.probation_backoff_s, 3),
                error=type(exc).__name__,
            )
        if quarantined_now:
            _metrics().quarantined.inc()
            # the flight event + postmortem trigger sit OUTSIDE the pool
            # lock (the dump's providers re-take it via snapshot())
            flight.record_event(
                "replica.quarantined", replica=replica.index,
                failures=replica.consecutive_failures,
                error=type(exc).__name__,
            )
            flight.trigger_dump(
                "replica_quarantined", replica=replica.index)
            _log.error(
                "replica %d (%s) quarantined after %d consecutive "
                "failures; pool continues on %d healthy replica(s)%s",
                replica.index, replica.device,
                replica.consecutive_failures,
                sum(not r.quarantined for r in self.replicas),
                ("" if self.probation_s is None
                 else f"; probation probe in {self.probation_s:.2f}s"),
            )
            # re-route work it already accepted: those batches deserve a
            # healthy executor, not a seat behind a broken one
            self._requeue_queued(replica)
        if claimed:
            self._retry_or_fail(work, exc, exclude=replica)

    def _retry_or_fail(self, work: _Work, exc: Exception,
                       exclude: "_Replica | None") -> None:
        """Rider protection: re-route a failed batch up to
        ``max_reroutes`` times before its error reaches the caller.

        Single-claimant: callers must first take the resolution claim
        (clear ``work.owner`` under the pool lock while it still points
        at their replica) — that is what keeps the watchdog and a late
        worker failure from racing on ``retries``/``fail`` for the same
        work."""
        if work.done.is_set():
            return  # already resolved
        if not work.reroutable:
            work.fail(exc)  # replica-pinned (warmup): its error surfaces
            return
        was_probe = work.probe
        if work.retries < self.max_reroutes:
            work.retries += 1
            work.probe = False
            record_retry("replica.execute", "retried")
            try:
                self._route(work, exclude=exclude)
                return
            except Exception:
                pass  # no alternative replica: surface the real error
        if self.max_reroutes:
            record_retry("replica.execute", "exhausted")
        if was_probe:
            # a failed last-ditch probe (no healthy re-route target):
            # the rider gets the same typed error it would have seen had
            # the probe never been attempted, with the executor's real
            # failure chained for diagnosis
            pool_err = AllReplicasQuarantinedError(
                f"all {len(self.replicas)} replicas quarantined; the "
                "probation probe this batch rode also failed"
            )
            pool_err.__cause__ = exc
            flight.record_event(
                "pool.all_quarantined", replicas=len(self.replicas),
                probe_failed=True,
            )
            flight.trigger_dump("all_replicas_quarantined")
            work.fail(pool_err)
            return
        work.fail(exc)

    def _requeue_queued(self, replica: _Replica) -> None:
        """Drain a quarantined/hung replica's queue back through
        routing (its own shutdown token is preserved)."""
        requeued = 0
        while True:
            try:
                work = replica.queue.get_nowait()
            except queue_mod.Empty:
                break
            if work is None:
                replica.queue.put(None)  # keep the shutdown token
                break
            with self._lock:
                replica.outstanding -= 1
            try:
                self._route(work)
                requeued += 1
            except Exception as e:
                work.fail(e)
        if requeued:
            _log.warning(
                "re-routed %d queued batch(es) off replica %d",
                requeued, replica.index,
            )

    # -- hung-dispatch watchdog ----------------------------------------------
    def _watchdog_loop(self) -> None:
        assert self.dispatch_timeout_s is not None
        interval = max(0.005, min(0.25, self.dispatch_timeout_s / 4.0))
        while not self._closing.wait(interval):
            now = time.monotonic()
            with self._lock:
                # retiring replicas stay scanned until their worker
                # exits (drop the ones that finished cleanly); warming
                # replicas are scanned so a wedged warmup dispatch
                # deadline-fails instead of blocking add_replica
                self._retiring = [r for r in self._retiring
                                  if r.thread.is_alive()]
                scan = (list(self.replicas) + list(self._retiring)
                        + list(self._warming))
            for r in scan:
                work = r.current_work
                if work is None or work.done.is_set():
                    continue
                t0 = work.started_at
                if t0 is None or now - t0 <= self.dispatch_timeout_s:
                    continue
                already = False
                with self._lock:
                    # re-verify under the lock: the worker clears
                    # current_work BEFORE its success/failure accounting,
                    # so a dispatch that completed since the unlocked
                    # read above is visible here — marking it hung would
                    # quarantine a healthy replica with no completion
                    # left to ever clear the flag
                    if r.current_work is not work or work.done.is_set():
                        continue
                    # resolution claim (same protocol as _on_failure):
                    # the wedged worker's current_work stays pointed at
                    # this work until its thread unwedges, so without
                    # the claim every later tick would re-fire on the
                    # stale reference and fail a batch that a previous
                    # tick already re-routed to a healthy replica
                    if work.owner is not r:
                        continue
                    work.owner = None
                    already = not r.breaker.trip()
                    r.hung = True
                _metrics().hung.inc()
                if not already:
                    _metrics().quarantined.inc()
                flight.record_event(
                    "replica.hung", replica=r.index,
                    timeout_s=self.dispatch_timeout_s,
                )
                flight.trigger_dump("hung_dispatch", replica=r.index)
                _log.error(
                    "watchdog: dispatch on replica %d exceeded %.2fs; "
                    "re-routing the batch and quarantining the replica "
                    "as hung (it rejoins if the wedged program "
                    "completes)", r.index, self.dispatch_timeout_s,
                )
                # rider protection applies to watchdogged work too: the
                # same re-route-once that covers executor errors (the
                # wedged executor's late completion is first-writer-wins
                # discarded by _Work's idempotent resolution)
                self._retry_or_fail(work, HungDispatchError(
                    f"dispatch on replica {r.index} exceeded the "
                    f"{self.dispatch_timeout_s}s deadline"
                ), exclude=r)
                self._requeue_queued(r)

    # -- lifecycle / introspection -------------------------------------------
    def close(self, *, drain: bool = True,
              timeout_s: "float | None" = 30.0) -> None:
        """Stop the pool. ``drain=True`` serves everything already
        routed first; ``drain=False`` fails queued batches now."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        flight.record_event(
            "pool.close", pool=self._flight_name, drain=drain)
        flight.remove_context_provider(self._flight_name)
        self._closing.set()
        for r in self.replicas:
            if not drain:
                while True:
                    try:
                        work = r.queue.get_nowait()
                    except queue_mod.Empty:
                        break
                    if work is not None:
                        work.fail(RuntimeError("ReplicaPool closed"))
            r.queue.put(None)  # wake + stop the worker after the drain
        for r in self.replicas:
            r.thread.join(timeout_s)
            if r.thread.is_alive():  # pragma: no cover - watchdog only
                _log.warning("replica %d did not stop in %ss",
                             r.index, timeout_s)
        if self._watchdog is not None:
            self._watchdog.join(timeout_s)

    # -- elasticity (the autoscaler's replica actuator) -----------------------
    def add_replica(self, *,
                    warmup_arrays: "dict[str, np.ndarray] | None" = None
                    ) -> int:
        """Grow the pool by one replica at runtime. The executor is
        built (and, with ``warmup_arrays``, compiled) BEFORE the replica
        joins routing, so live traffic never waits on a cold replica's
        first compile. Devices round-robin off the construction ring
        (simulated replicas: several on one card). Returns the
        new replica's index — indices are never reused, so flight events
        and per-replica metric labels stay unambiguous across scale
        cycles."""
        with self._lock:
            if self._closed:
                raise RuntimeError("ReplicaPool is closed")
            index = self._next_index
            self._next_index += 1
        device = self._devices[index % len(self._devices)]
        replica = _Replica(index, device, self._make_runner(device), self)
        if warmup_arrays is not None:
            work = _Work(warmup_arrays)
            work.reroutable = False  # a failed warmup must SURFACE
            work.owner = replica
            with self._lock:
                replica.outstanding += 1
                self._warming.append(replica)
                replica.queue.put(work)
            try:
                # unbounded wait is safe: the watchdog scans _warming,
                # so with dispatch_timeout_s armed a wedged warmup is
                # deadline-failed (reroutable=False -> the error
                # surfaces here) exactly like a live replica's warmup
                _PoolFuture(work).result()
            except BaseException:
                replica.queue.put(None)  # never joined routing: stop it
                raise
            finally:
                with self._lock:
                    if replica in self._warming:
                        self._warming.remove(replica)
        with self._lock:
            if self._closed:
                replica.queue.put(None)
                raise RuntimeError("ReplicaPool is closed")
            self.replicas.append(replica)
            self._worker_ids[replica.thread.ident] = replica
        flight.record_event(
            "pool.scale_up", pool=self._flight_name, replica=index,
            replicas=len(self.replicas),
        )
        _log.info("replica %d (%s) added; pool now %d replica(s)",
                  index, device, len(self.replicas))
        return index

    def remove_replica(self, index: "int | None" = None, *,
                       timeout_s: "float | None" = 30.0) -> int:
        """Drain-safe scale-down: retire one replica with ZERO accepted
        batches lost. The victim (``index``, or auto-picked: a
        quarantined replica first, else the least-loaded) leaves routing
        immediately, its queued-but-unstarted work re-routes to
        survivors through the same requeue path a quarantine uses, and
        its in-flight batch finishes on the victim before the worker
        stops — the fleet-level drain contract applied to one host's
        cards. ``replica.scale_down`` is a fault site AT THE
        TOP: an injected fault aborts the scale-down before any state
        moves, so the autoscaler defers the decision instead of losing
        work mid-drain. Raises ValueError below one replica."""
        fault_point("replica.scale_down")
        with self._lock:
            if self._closed:
                raise RuntimeError("ReplicaPool is closed")
            if len(self.replicas) <= 1:
                raise ValueError(
                    "cannot scale below one replica; close() the pool "
                    "to stop serving")
            if index is not None:
                victim = next(
                    (r for r in self.replicas if r.index == index), None)
                if victim is None:
                    raise KeyError(f"no replica with index {index}")
            else:
                quarantined = [r for r in self.replicas if r.quarantined]
                victim = min(quarantined or self.replicas,
                             key=lambda r: r.outstanding)
            self.replicas.remove(victim)
            self._worker_ids.pop(victim.thread.ident, None)
            # the watchdog keeps scanning the victim until its worker
            # exits: an in-flight dispatch that wedges mid-retirement
            # is still deadline-failed instead of hanging its riders
            self._retiring.append(victim)
        # unstarted work transfers to survivors (the victim no longer
        # routes, so _route picks only live replicas); the in-flight
        # batch — if any — resolves on the victim's worker below
        self._requeue_queued(victim)
        victim.queue.put(None)  # stop the worker after its last batch
        victim.thread.join(timeout_s)
        if victim.thread.is_alive():  # pragma: no cover - wedged program
            _log.warning(
                "replica %d worker did not stop in %ss (wedged "
                "dispatch); its thread is daemon, off routing, and "
                "stays under watchdog scan until it exits",
                victim.index, timeout_s)
        else:
            with self._lock:
                if victim in self._retiring:
                    self._retiring.remove(victim)
        _metrics().depth.set(0, replica=str(victim.index))
        flight.record_event(
            "pool.scale_down", pool=self._flight_name,
            replica=victim.index, replicas=len(self.replicas),
        )
        _log.info("replica %d (%s) drained and removed; pool now %d "
                  "replica(s)", victim.index, victim.device,
                  len(self.replicas))
        return victim.index

    def warmup(self, arrays: dict[str, np.ndarray]) -> None:
        """Dispatch ``arrays`` to EVERY replica (compile its buckets)
        before measurement/traffic — steady-state serving never pays a
        first-request compile."""
        # route one copy to each replica directly (bypass least-work:
        # warmup must touch all of them)
        futs = []
        for r in self.replicas:
            work = _Work(arrays)
            work.reroutable = False  # a failed warmup must SURFACE
            work.owner = r
            with self._lock:
                if self._closed:
                    # a closed replica's worker has consumed its shutdown
                    # token: queued work would hang forever
                    raise RuntimeError("ReplicaPool is closed")
                r.outstanding += 1
                r.queue.put(work)
            futs.append(_PoolFuture(work))
        for f in futs:
            f.result()

    def snapshot(self) -> dict[str, Any]:
        """Operator view: per-replica depth, in-flight, totals,
        quarantine/probation state, latency percentiles."""
        now = time.monotonic()
        with self._lock:
            replicas = [
                {
                    "replica": r.index,
                    "device": str(r.device),
                    "depth": r.queue.qsize(),
                    "in_flight": r.outstanding,
                    "dispatched": r.dispatched,
                    "consecutive_failures": r.consecutive_failures,
                    "quarantined": r.quarantined,
                    "hung": r.hung,
                    "probing": r.probing,
                    "next_probe_in_s": (
                        max(0.0, r.probation_until - now)
                        if r.quarantined and not r.hung
                        and self.probation_s is not None else None
                    ),
                    "latency_s": r.latency.step_time_percentiles((50, 95)),
                }
                for r in self.replicas
            ]
        return {
            "replica_count": len(self.replicas),
            "healthy_count": sum(
                not r["quarantined"] for r in replicas),
            "replicas": replicas,
        }

    def __enter__(self) -> "ReplicaPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close(drain=exc == (None, None, None))
