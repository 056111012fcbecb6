"""Cache-aware router tier over per-host serving engines.

ReplicaPool scales across the cards of ONE host; this router is the
front door over MANY hosts (the coordinator/worker
split of distributed TensorFlow — arXiv 1603.04467, 1603.02339 —
applied to serving). Every placement decision folds three signals:

* **Load** — weighted least-outstanding-work: the router tracks its own
  in-flight count per host and divides by the host's capacity weight
  (``replica_count × n_slots`` from the engine's ``capacity()``
  structure), so a 4-replica host legitimately absorbs 4x a 1-replica
  host's depth before looking equally busy.
* **Affinity** — the prefix cache made placement *stateful*: the
  host already holding a prompt's prefix blocks prefills only the
  uncached tail. Hosts publish bounded prefix→host digests
  (:mod:`~sparkdl_torch.fabric.digest`); the score adds
  ``affinity_weight × min(matched_blocks, affinity_cap_blocks)`` —
  the **cap is the anti-hotspot trade**: past ``affinity_cap_blocks``
  of cached prefix, more affinity buys nothing, so a single hot prefix
  cannot out-bid an arbitrarily large load imbalance and pile the
  whole fleet's traffic on one host. Sticky **sessions** (bounded LRU
  ``session → host`` map) keep a conversation on the host whose cache
  holds its history without re-scoring every turn.
* **Health** — a host answering ``unhealthy`` (its ``/healthz``-shaped
  ``health()``), or failing ``max_failures`` consecutive submissions,
  is quarantined behind the same probation circuit breaker ReplicaPool
  uses: after ``probation_s`` ONE live request probes it (the rider
  protected by the failover re-route), success rejoins, failure doubles
  the backoff up to ``probation_max_s``.

**Spillover admission control**: a host past its saturation bound
(``max_queue_depth + n_slots`` from its capacity, or the explicit
``max_outstanding``) is skipped even when affinity prefers it — the
request lands on the best host WITH room (``sparkdl_fabric_spillover_total``)
— and only an all-saturated fleet rejects (``QueueFullError``), the
same reject-with-error backpressure the single-host queue applies.

**Drain** (rolling restarts): :meth:`drain_host` stops new placements,
extracts the host's accepted-but-unstarted requests, and re-queues them
onto surviving hosts — in-process hosts transfer the live
:class:`~sparkdl_torch.serving.queue.Request` objects queue-to-queue
(trace ids, deadlines, Futures intact; ``RequestQueue.requeue``),
HTTP hosts fail their blocked submits with
:class:`~sparkdl_torch.fabric.host.HostDrainingError` and the failover
path re-places them. In-flight requests finish on the draining host.

**Failover**: a Future that fails with a *host-level* error
(:data:`~sparkdl_torch.fabric.host.HOST_LEVEL_ERRORS` — engine shut
down, transport dead, draining) is re-submitted to a surviving host up
to ``max_failovers`` times before the error reaches the caller; every
hop lands in ``sparkdl_retries_total{site="host.submit"}`` and the
flight ring, and a host quarantine triggers a postmortem bundle whose
router context captures the failover sequence.

Fault sites: ``router.route`` (every placement decision),
``host.submit`` / ``host.drain`` (on the handles).
"""

from __future__ import annotations

import collections
import json
import threading
import time
from concurrent.futures import CancelledError, Future, InvalidStateError
from typing import Any, Iterable

from sparkdl_torch.observability import flight
from sparkdl_torch.observability.registry import registry
from sparkdl_torch.reliability.breaker import ProbationBreaker
from sparkdl_torch.reliability.faults import fault_point
from sparkdl_torch.reliability.retry import record_retry
from sparkdl_torch.serving.queue import QueueFullError, Request

from sparkdl_torch.fabric.digest import (
    HostDigest,
    hrw_preferred_host,
    hrw_score,
    match_blocks,
    path_anchor,
    placement_key,
    prompt_block_hashes,
    session_key,
)
from sparkdl_torch.fabric.host import (
    HOST_LEVEL_ERRORS,
    HostDrainingError,
    HostHandle,
)

__all__ = ["AllHostsUnavailableError", "Router"]

_M_ROUTED = registry().counter(
    "sparkdl_fabric_routed_total",
    "requests the router placed, by receiving host",
    labels=("host",))
_M_SPILLOVER = registry().counter(
    "sparkdl_fabric_spillover_total",
    "placements diverted off a saturated preferred host, by the host "
    "that absorbed them",
    labels=("host",))
_M_AFFINITY = registry().counter(
    "sparkdl_fabric_affinity_hits_total",
    "placements that landed on a host whose prefix digest matched the "
    "prompt (cache-affine routing wins)",
    labels=("host",))
_M_REQUEUED = registry().counter(
    "sparkdl_fabric_requeued_total",
    "accepted requests re-queued off a draining or failed host onto a "
    "surviving host")
_M_FAILOVERS = registry().counter(
    "sparkdl_fabric_failovers_total",
    "requests re-submitted to another host after a host-level failure")
_M_HOST_QUARANTINED = registry().counter(
    "sparkdl_fabric_host_quarantined_total",
    "hosts quarantined by the router's circuit breaker")
_M_DIGEST_BLOCKS = registry().gauge(
    "sparkdl_fabric_digest_blocks",
    "prefix-digest entries the router holds per host",
    labels=("host",))
_M_DELTA_BYTES = registry().counter(
    "sparkdl_fabric_digest_delta_bytes_total",
    "wire bytes of digest DELTA payloads the router consumed (the "
    "steady-state refresh cost; compare sparkdl_fabric_digest_"
    "wholesale_bytes_total)")
_M_WHOLESALE_BYTES = registry().counter(
    "sparkdl_fabric_digest_wholesale_bytes_total",
    "wire bytes of WHOLESALE digest snapshots the router pulled "
    "(first contact, delta gaps, and hosts without a journal)")
_M_DELTA_APPLIED = registry().counter(
    "sparkdl_fabric_digest_delta_applied_total",
    "digest delta consumption outcomes (applied: folded in; replayed: "
    "stale duplicate skipped idempotently; gap: journal rolled past "
    "this router, wholesale re-sync; error: torn delta fetch, "
    "wholesale re-sync)",
    labels=("outcome",))


class AllHostsUnavailableError(RuntimeError):
    """Every fabric host is quarantined, draining, or unhealthy and
    none is due a probation probe; the fabric cannot place work."""


class _Placement:
    """One routed request's record: what the failover path needs to
    re-submit it somewhere else."""

    __slots__ = ("payload", "session", "deadline", "timeout_s",
                 "attempts", "probe")

    def __init__(self, payload, session, timeout_s):
        self.payload = payload
        self.session = session
        self.timeout_s = timeout_s
        self.deadline = (time.monotonic() + timeout_s
                         if timeout_s is not None else None)
        self.attempts = 0
        self.probe = False


class _HostState:
    """Router-side view of one host (all mutable fields under the
    router lock)."""

    __slots__ = ("handle", "host_id", "outstanding", "routed",
                 "breaker", "draining", "health_status", "digest",
                 "weight", "saturation", "free_slots", "kv_free",
                 "kv_total", "kv_cold", "kv_parked_sessions",
                 "overload_level")

    def __init__(self, handle: HostHandle, saturation: "int | None",
                 breaker: ProbationBreaker):
        self.handle = handle
        self.host_id = handle.host_id
        self.outstanding = 0
        self.routed = 0
        #: the shared quarantine/probation state machine (mutated under
        #: the router lock — one implementation with ReplicaPool)
        self.breaker = breaker
        self.draining = False
        self.health_status = "ok"
        self.digest: "HostDigest | None" = None
        self.weight = 1
        self.saturation = saturation if saturation is not None else 256
        #: headroom-policy signals off the host's capacity() (None
        #: until the first refresh, or when the engine has no paged
        #: pool): slot occupancy + KV availability
        self.free_slots: "int | None" = None
        self.kv_free: "int | None" = None
        self.kv_total: "int | None" = None
        #: tiered-KV signals: refcount-0 cached
        #: blocks that can page out on demand, and sessions already
        #: parked in the host/disk tiers — pressure that is NOT "full"
        self.kv_cold: "int | None" = None
        self.kv_parked_sessions: "int | None" = None
        #: brownout ladder level off capacity(): a browned-
        #: out host's headroom is discounted so the fleet routes new
        #: work around local overload while the ladder sheds it
        self.overload_level = 0

    # breaker state read-throughs (tests and snapshots read these; all
    # WRITES go through the breaker's transition verbs)
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


class Router:
    """Route generation requests over :class:`HostHandle` hosts.

    ``submit(payload, timeout_s=, session=)`` returns a Future; payload
    is ``{"prompt": ids, "max_new_tokens": n}`` for GPT hosts (the
    ``prompt`` feeds affinity scoring) or an opaque feature payload for
    micro-batching hosts. ``policy="round_robin"`` disables scoring
    (the bench baseline); health/saturation/drain handling is identical
    in both policies, so the comparison isolates cache-awareness.

    Construct with ``auto_refresh=False`` for deterministic tests and
    call :meth:`refresh` manually; the default refreshes digests,
    capacity, and health every ``refresh_interval_s`` on a daemon
    thread.
    """

    def __init__(self, hosts: "Iterable[HostHandle]", *,
                 policy: str = "affinity",
                 affinity_weight: float = 1.0,
                 load_weight: float = 1.0,
                 affinity_cap_blocks: int = 8,
                 digest_entries: int = 1024,
                 max_failovers: int = 2,
                 max_failures: int = 3,
                 probation_s: "float | None" = 1.0,
                 probation_max_s: float = 30.0,
                 max_outstanding: "int | None" = None,
                 session_capacity: int = 4096,
                 refresh_interval_s: float = 2.0,
                 auto_refresh: bool = True,
                 placement_block_size: "int | None" = None):
        if policy not in ("affinity", "round_robin", "headroom"):
            raise ValueError(
                f"policy must be 'affinity', 'round_robin', or "
                f"'headroom', got {policy!r}")
        if affinity_cap_blocks < 0:
            raise ValueError(
                f"affinity_cap_blocks must be >= 0, got "
                f"{affinity_cap_blocks}")
        if max_failures < 1:
            raise ValueError(
                f"max_failures must be >= 1, got {max_failures}")
        if probation_s is not None and probation_s <= 0:
            raise ValueError(
                f"probation_s must be > 0 or None, got {probation_s}")
        if placement_block_size is not None and placement_block_size < 1:
            raise ValueError(
                f"placement_block_size must be >= 1 or None, got "
                f"{placement_block_size}")
        self.policy = policy
        #: block grid the rendezvous placement key hashes under; None
        #: derives it from the fleet's published digests (min block
        #: size). Pin it when routers must agree before any digest
        #: arrives (cross-process determinism).
        self.placement_block_size = placement_block_size
        self.affinity_weight = affinity_weight
        self.load_weight = load_weight
        self.affinity_cap_blocks = affinity_cap_blocks
        self.digest_entries = digest_entries
        self.max_failovers = max_failovers
        self.max_failures = max_failures
        self.probation_s = probation_s
        self.probation_max_s = probation_max_s
        self.max_outstanding = max_outstanding
        self.session_capacity = session_capacity
        self.refresh_interval_s = refresh_interval_s
        states = [_HostState(h, max_outstanding, self._make_breaker())
                  for h in hosts]
        if not states:
            raise ValueError("a Router needs at least one host")
        ids = [s.host_id for s in states]
        if len(set(ids)) != len(ids):
            raise ValueError(f"duplicate host ids: {sorted(ids)}")
        self._hosts: "dict[str, _HostState]" = {
            s.host_id: s for s in states}
        self._sessions: "collections.OrderedDict[Any, str]" = \
            collections.OrderedDict()
        self._rr = 0
        self._closed = False
        self._lock = threading.Lock()
        self._closing = threading.Event()
        self.refresh()
        # process-wide registrations LAST (the engine-constructor rule):
        # /healthz and postmortem bundles read live fabric state here —
        # the snapshot exposes replica_count/healthy_count in the pool
        # shape healthz_report() aggregates, so an all-hosts-down fabric
        # answers 503 at the front door
        self._flight_name = flight.add_context_provider(
            f"fabric-router-{id(self):x}", self.snapshot)
        flight.record_event(
            "fabric.start", router=self._flight_name, hosts=len(states),
            policy=policy)
        self._refresh_thread: "threading.Thread | None" = None
        if auto_refresh and refresh_interval_s > 0:
            self._refresh_thread = threading.Thread(
                target=self._refresh_worker,
                name="sparkdl-fabric-refresh", daemon=True)
            self._refresh_thread.start()

    def _make_breaker(self) -> ProbationBreaker:
        return ProbationBreaker(
            max_failures=self.max_failures,
            probation_s=self.probation_s,
            probation_max_s=self.probation_max_s,
        )

    # -- submission ----------------------------------------------------------
    def submit(self, payload: Any, *, timeout_s: "float | None" = None,
               session: Any = None) -> Future:
        """Place one request on the best host; returns a Future that
        survives host-level failures up to ``max_failovers`` re-routes.
        Raises :class:`QueueFullError` when every eligible host is
        saturated and :class:`AllHostsUnavailableError` when none is
        eligible at all."""
        if self._closed:
            raise RuntimeError("Router is closed")
        rec = _Placement(payload, session, timeout_s)
        caller: Future = Future()
        self._dispatch(rec, caller, exclude=None)
        return caller

    def _dispatch(self, rec: _Placement, caller: Future,
                  exclude: "_HostState | None") -> None:
        state = self._place(rec, exclude)
        remaining = rec.timeout_s
        if rec.deadline is not None:
            remaining = max(0.001, rec.deadline - time.monotonic())
        try:
            inner = state.handle.submit(rec.payload, timeout_s=remaining)
        except Exception as e:
            reroute = (isinstance(e, QueueFullError)
                       or isinstance(e, HOST_LEVEL_ERRORS))
            with self._lock:
                state.outstanding -= 1
                if rec.probe and not reroute:
                    # same release as the async path: a request-level
                    # reject at the door (bad prompt) says nothing
                    # about the host — free the probe slot
                    state.breaker.release_probe()
            if reroute:
                # the host refused at the door (raced saturation, drain,
                # injected host.submit fault): same failover path as an
                # asynchronous host failure
                self._fail_or_reroute(rec, state, caller, e)
                return
            raise
        inner.add_done_callback(
            lambda f, rec=rec, state=state, caller=caller:
            self._on_result(rec, state, caller, f))

    def _payload_prompt(self, payload: Any):
        if isinstance(payload, dict):
            return payload.get("prompt")
        return getattr(payload, "prompt", None)

    def _place(self, rec: _Placement,
               exclude: "_HostState | None", *,
               transfer: bool = False) -> _HostState:
        """Pick a host and charge it one outstanding unit. Handle calls
        never happen under the router lock (deadlock discipline shared
        with ReplicaPool). ``transfer=True`` is the drain-transfer
        placement: quarantined hosts are out entirely (a transfer
        bypasses the router's completion callbacks, so it can neither
        release a probe slot nor survive landing in a dead host's
        queue) and saturation does NOT reject — the requests were
        already accepted, and the target queue's cross-queue ``requeue``
        absorbs transfers past ``max_depth`` by contract."""
        fault_point("router.route")
        prompt = (self._payload_prompt(rec.payload)
                  if self.policy == "affinity" else None)
        # hash outside the lock (pure CPU work); one digest grid per
        # distinct block size in the fleet (normally exactly one)
        hashes_by_bs: "dict[int, list[int]]" = {}
        pkey: "int | None" = None
        if prompt is not None and len(prompt):
            with self._lock:
                sizes = {s.digest.block_size
                         for s in self._hosts.values()
                         if s.digest is not None}
            hashes_by_bs = {
                bs: prompt_block_hashes(prompt, bs,
                                        self.affinity_cap_blocks)
                for bs in sizes}
            pbs = (self.placement_block_size
                   or (min(sizes) if sizes else 16))
            pkey = placement_key(prompt, pbs)
        spilled = False
        affine = False
        probe = False
        chosen: "_HostState | None" = None
        with self._lock:
            now = time.monotonic()
            candidates = [
                s for s in self._hosts.values()
                if s is not exclude and not s.draining
                and s.health_status not in ("unhealthy", "unreachable")
                and (not s.quarantined
                     or (not transfer and s.breaker.probe_due(now)))
            ]
            if candidates:
                chosen = self._sticky_locked(rec, candidates,
                                             hashes_by_bs)
                if chosen is None:
                    chosen, spilled, affine = self._score_locked(
                        rec, candidates, hashes_by_bs, pkey,
                        include_saturated=transfer)
                if chosen.quarantined:
                    chosen.breaker.begin_probe()
                    probe = True
                chosen.outstanding += 1
                chosen.routed += 1
                if rec.session is not None:
                    self._sessions[rec.session] = chosen.host_id
                    self._sessions.move_to_end(rec.session)
                    while len(self._sessions) > self.session_capacity:
                        self._sessions.popitem(last=False)
        if chosen is None:
            # event + postmortem trigger outside the lock (the dump's
            # providers call snapshot(), which takes it again)
            flight.record_event(
                "fabric.no_hosts", hosts=len(self._hosts))
            flight.trigger_dump("fabric_unavailable")
            raise AllHostsUnavailableError(
                f"none of the {len(self._hosts)} fabric hosts can "
                "take work (quarantined/draining/unhealthy)")
        if probe:
            rec.probe = True
        _M_ROUTED.inc(host=chosen.host_id)
        if spilled:
            _M_SPILLOVER.inc(host=chosen.host_id)
        if affine:
            _M_AFFINITY.inc(host=chosen.host_id)
        return chosen

    def _sticky_locked(self, rec: _Placement,
                       candidates: "list[_HostState]",
                       hashes_by_bs: "dict[int, list[int]]"
                       ) -> "_HostState | None":
        """Place a continuing session on the host that holds its
        history. Three steps, strongest evidence first (the
        per-router LRU alone silently dropped affinity under churn and
        never survived a router restart):

        1. the LRU remembers a still-eligible host with room — the
           fast path, same as always;
        2. no LRU entry, but some host's DIGEST matches the prompt —
           real cache evidence (this router restarted, or another
           router placed the session, or the session migrated): fall
           through to scoring, which follows the match;
        3. neither — rendezvous-hash the session id over the open
           candidates, so every router (and every restart of this one)
           derives the same home without sharing the LRU.
        First placements with no session and failover re-routes fall
        through to scoring."""
        if rec.session is None or rec.attempts:
            return None
        host_id = self._sessions.get(rec.session)
        if host_id is not None:
            for s in candidates:
                if (s.host_id == host_id and not s.quarantined
                        and s.outstanding < s.saturation):
                    return s
            return None
        if hashes_by_bs:
            for s in candidates:
                if s.digest is None:
                    continue
                hashes = hashes_by_bs.get(s.digest.block_size)
                if hashes and match_blocks(hashes, s.digest):
                    return None  # cache evidence beats the hash
        open_hosts = [s for s in candidates if not s.quarantined
                      and s.outstanding < s.saturation]
        if not open_hosts:
            return None
        skey = session_key(rec.session)
        best = max(open_hosts,
                   key=lambda s: (hrw_score(skey, s.host_id), s.host_id))
        return best

    def _score_locked(self, rec: _Placement,
                      candidates: "list[_HostState]",
                      hashes_by_bs: "dict[int, list[int]]",
                      pkey: "int | None" = None,
                      include_saturated: bool = False
                      ) -> "tuple[_HostState, bool, bool]":
        """(chosen, spilled, affine): affinity-bonus minus load-penalty
        over the non-saturated candidates; ``spilled`` reports that a
        saturated host would have scored best (spillover admission
        control diverted the request). ``include_saturated`` (drain
        transfers) scores every candidate — already-accepted traffic is
        never re-rejected. ``pkey`` (the prompt's rendezvous placement
        key) breaks score TIES deterministically so N routers with the
        same view agree — it never outvotes load or affinity, which is
        the whole disagreement-window story: routers whose views differ
        disagree only inside the tie set, costing at most one cold
        prefill, never correctness."""
        def bonus(s: _HostState) -> int:
            if not hashes_by_bs or s.digest is None:
                return 0
            # .get: a refresh may have swapped in a digest with a block
            # size unseen when the prompt was hashed (pre-lock) — worth
            # zero affinity this placement, correct next one
            hashes = hashes_by_bs.get(s.digest.block_size)
            if hashes is None:
                return 0
            hit = match_blocks(hashes, s.digest)
            return min(hit, self.affinity_cap_blocks)

        open_hosts = (list(candidates) if include_saturated
                      else [s for s in candidates
                            if s.outstanding < s.saturation])
        if not open_hosts:
            raise QueueFullError(
                f"all {len(candidates)} eligible fabric hosts are "
                "saturated; retry with backoff or add hosts")
        if self.policy == "round_robin":
            chosen = open_hosts[self._rr % len(open_hosts)]
            self._rr += 1
            return chosen, False, False
        if self.policy == "headroom":
            # decode-tier placement: slot headroom discounted
            # by KV availability — a host with free slots but a nearly
            # exhausted block pool would only DEFER the installed
            # request, so it scores like a busy one. The router-side
            # outstanding count keeps the score live between capacity
            # refreshes; the load penalty breaks ties the stale
            # free-slot reading cannot. Cold cached blocks count as
            # available: a tiered host pages them out
            # on demand, so pressure that is parkable idle sessions
            # must not score the host as full.
            def room(s: _HostState) -> float:
                free = (s.free_slots if s.free_slots is not None
                        else s.weight)
                free = max(0.0, free - s.outstanding)
                kv = 1.0
                if s.kv_total:
                    avail = max(0.0, s.kv_free or 0) + (s.kv_cold or 0)
                    kv = min(1.0, avail / s.kv_total)
                # brownout discount: each ladder level halves
                # the advertised room — a browned-out host keeps serving
                # but stops attracting NEW work over healthy peers
                return free * kv / (1 << min(s.overload_level, 4))

            scores = {
                s.host_id: (room(s)
                            - self.load_weight * s.outstanding / s.weight)
                for s in candidates}
            best_score = max(scores[s.host_id] for s in open_hosts)
            ties = [s for s in open_hosts
                    if scores[s.host_id] == best_score]
            chosen = ties[self._rr % len(ties)]
            self._rr += 1
            return chosen, max(scores.values()) > best_score, False
        # score each host exactly once (nothing can change under the
        # held lock): the digest walks are the lock's hot-path cost
        bonuses = {s.host_id: bonus(s) for s in candidates}
        # the brownout penalty mirrors the headroom policy's discount
        #: one load_weight unit per ladder level, so a
        # browned-out host loses affinity ties to healthy peers
        scores = {
            s.host_id: (self.affinity_weight * bonuses[s.host_id]
                        - self.load_weight * s.outstanding / s.weight
                        - self.load_weight * s.overload_level)
            for s in candidates}
        best_score = max(scores[s.host_id] for s in open_hosts)
        ties = [s for s in open_hosts if scores[s.host_id] == best_score]
        if pkey is not None:
            # rendezvous tie-break: every router resolves the same tie
            # the same way, with no shared state
            chosen = max(ties, key=lambda s: (hrw_score(pkey, s.host_id),
                                              s.host_id))
        else:
            chosen = ties[self._rr % len(ties)]
            self._rr += 1
        # spillover: a saturated host would have outscored the choice
        spilled = max(scores.values()) > best_score
        return chosen, spilled, bonuses[chosen.host_id] > 0

    # -- completion / failover (runs on host worker threads) -----------------
    @staticmethod
    def _resolve_caller(caller: Future, *, result: Any = None,
                        exc: "BaseException | None" = None) -> None:
        """Resolve the caller-facing Future, tolerating a caller that
        cancelled it while the work was in flight (the router never
        marks it RUNNING, so cancel() can win any time before this; the
        result is simply dropped — the work already happened)."""
        try:
            if exc is not None:
                caller.set_exception(exc)
            else:
                caller.set_result(result)
        except InvalidStateError:
            pass

    def _on_result(self, rec: _Placement, state: _HostState,
                   caller: Future, fut: Future) -> None:
        try:
            self._on_result_inner(rec, state, caller, fut)
        except Exception as e:  # a hung caller Future is worse than
            self._resolve_caller(caller, exc=e)  # any error it carries

    def _on_result_inner(self, rec: _Placement, state: _HostState,
                         caller: Future, fut: Future) -> None:
        exc = (CancelledError("host cancelled the request")
               if fut.cancelled() else fut.exception())
        if exc is None:
            with self._lock:
                state.outstanding -= 1
                rejoined = state.breaker.record_success()
            if rejoined:
                flight.record_event(
                    "fabric.host_reintegrated", host=state.host_id)
            if rec.attempts:
                record_retry("host.submit", "recovered")
            self._resolve_caller(caller, result=fut.result())
            return
        with self._lock:
            state.outstanding -= 1
            if rec.probe and not isinstance(exc, HOST_LEVEL_ERRORS):
                # the probe's request failed for its own reasons
                # (deadline on the recovering host's queue, bad
                # prompt): inconclusive about the HOST — release the
                # probe slot so the next due probe can run, else the
                # host stays quarantined forever
                state.breaker.release_probe()
        if isinstance(exc, HOST_LEVEL_ERRORS):
            self._fail_or_reroute(rec, state, caller, exc)
        else:
            # the request's own outcome (deadline, bad prompt, model
            # error): pass through exactly once — the host already
            # accounted it
            self._resolve_caller(caller, exc=exc)

    def _fail_or_reroute(self, rec: _Placement, state: _HostState,
                         caller: Future, exc: BaseException) -> None:
        if not isinstance(exc, (HostDrainingError, QueueFullError)):
            # a drain or a full queue is planned backpressure, not a
            # host failure — only real failures feed the breaker
            self._record_host_failure(state, exc)
        elif rec.probe:
            self._record_host_failure(state, exc)
        expired = (rec.deadline is not None
                   and time.monotonic() >= rec.deadline)
        if rec.attempts < self.max_failovers and not expired:
            rec.attempts += 1
            rec.probe = False
            _M_FAILOVERS.inc()
            record_retry("host.submit", "retried")
            flight.record_event(
                "fabric.failover", host=state.host_id,
                attempt=rec.attempts, error=type(exc).__name__)
            try:
                self._dispatch(rec, caller, exclude=state)
                return
            except Exception as e:
                record_retry("host.submit", "exhausted")
                self._resolve_caller(caller, exc=e)
                return
        if self.max_failovers:
            record_retry("host.submit", "exhausted")
        self._resolve_caller(caller, exc=exc)

    def _record_host_failure(self, state: _HostState,
                             exc: BaseException) -> None:
        quarantined_now = False
        probe_failed = False
        with self._lock:
            now = time.monotonic()
            if state.probing and state.quarantined:
                # failed probation probe: stay out, back off harder
                state.breaker.record_probe_failure(now)
                probe_failed = True
            else:
                quarantined_now = state.breaker.record_failure(now)
        if probe_failed:
            flight.record_event(
                "fabric.probe_failed", host=state.host_id,
                next_probe_s=round(state.probation_backoff_s, 3),
                error=type(exc).__name__)
        if quarantined_now:
            _M_HOST_QUARANTINED.inc()
            # event + postmortem OUTSIDE the lock: the dump's providers
            # call snapshot(), which takes it again
            flight.record_event(
                "fabric.host_quarantined", host=state.host_id,
                failures=state.consecutive_failures,
                error=type(exc).__name__)
            flight.trigger_dump("host_failover", host=state.host_id)

    # -- refresh (digests, capacity, health) ---------------------------------
    def refresh(self) -> None:
        """Pull every host's capacity/digest/health once (handle calls
        outside the router lock). The auto-refresh thread calls this on
        its cadence; tests call it manually after seeding caches."""
        for state in list(self._hosts.values()):
            self._refresh_host(state)

    def _refresh_digest(self, state: _HostState) -> "HostDigest | None":
        """Advance one host's digest, delta-first: ask the
        host for the journal since the version we hold and fold it in —
        KBs/sec regardless of pool size — falling back to ONE wholesale
        snapshot on first contact, journal gaps, torn fetches
        (``digest.delta`` fault), or hosts that publish no journal
        (``prefix_digest_delta`` → None). Host-level errors propagate:
        the caller's unreachable-marking is about the HOST, not the
        refresh mode."""
        prev = state.digest
        if prev is not None:
            delta = None
            try:
                delta = state.handle.prefix_digest_delta(
                    prev.version, max_entries=self.digest_entries)
            except HOST_LEVEL_ERRORS:
                raise
            except Exception:
                # torn delta fetch: the journal said nothing usable —
                # re-sync wholesale below, same as a gap
                _M_DELTA_APPLIED.inc(outcome="error")
            else:
                if delta is not None:
                    advanced = prev.apply_delta(delta)
                    if advanced is not None:
                        _M_DELTA_BYTES.inc(len(json.dumps(delta)))
                        _M_DELTA_APPLIED.inc(
                            outcome=("applied" if advanced is not prev
                                     else "replayed"))
                        return advanced
                    _M_DELTA_APPLIED.inc(outcome="gap")
        snap = state.handle.prefix_digest(self.digest_entries)
        if snap is not None:
            _M_WHOLESALE_BYTES.inc(len(json.dumps(snap)))
        return HostDigest.from_snapshot(snap)

    def _refresh_host(self, state: _HostState) -> None:
        try:
            cap = state.handle.capacity()
            digest = self._refresh_digest(state)
            health = state.handle.health()
        except Exception as e:
            with self._lock:
                state.health_status = "unreachable"
            flight.record_event(
                "fabric.refresh_failed", host=state.host_id,
                error=type(e).__name__)
            return
        weight = (max(1, int(cap.get("replica_count") or 1))
                  * max(1, int(cap.get("n_slots") or 1)))
        saturation = self.max_outstanding
        if saturation is None:
            saturation = (int(cap.get("max_queue_depth") or 256)
                          + int(cap.get("n_slots") or 0))
        with self._lock:
            if self._hosts.get(state.host_id) is not state:
                # the host was removed (or replaced) while this poll
                # was in flight: publishing now would resurrect a
                # departed host's digest gauge/placement state
                return
            state.weight = weight
            state.saturation = saturation
            state.digest = digest
            fs = cap.get("free_slots")
            state.free_slots = int(fs) if fs is not None else None
            kf = cap.get("kv_blocks_free")
            state.kv_free = int(kf) if kf is not None else None
            kt = cap.get("kv_blocks_total")
            state.kv_total = int(kt) if kt is not None else None
            kc = cap.get("kv_blocks_cold")
            state.kv_cold = int(kc) if kc is not None else None
            ps = cap.get("kv_parked_sessions")
            state.kv_parked_sessions = (int(ps) if ps is not None
                                        else None)
            state.overload_level = int(cap.get("overload_level") or 0)
            state.health_status = str(
                health.get("status") or "ok")
            # gauge published under the same lock as the membership
            # check: remove_host's zeroing can never be overwritten by
            # a poll that raced the removal
            _M_DIGEST_BLOCKS.set(
                len(digest.hashes) if digest is not None else 0,
                host=state.host_id)

    def _refresh_worker(self) -> None:
        while not self._closing.wait(self.refresh_interval_s):
            try:
                self.refresh()
            except Exception:  # pragma: no cover - observability guard
                flight.record_event("fabric.refresh_error")

    # -- drain / lifecycle ---------------------------------------------------
    def drain_host(self, host_id: str, *,
                   wait_s: "float | None" = None,
                   migrate_parked: bool = True) -> int:
        """Gracefully drain one host for a rolling restart: no new
        placements, unstarted requests re-queued onto surviving hosts
        (queue-level :class:`Request` transfer for in-process hosts —
        trace ids/deadlines/Futures intact; transport hosts fail their
        blocked submits with :class:`HostDrainingError` and the
        failover path re-places them), in-flight requests finish where
        they are, and — unless ``migrate_parked=False`` — the host's
        PARKED sessions re-park on survivors chosen by the fleet-agreed
        rendezvous hash, so idle conversations resume with a
        page-in instead of a cold re-prefill. Returns the number of
        requests re-queued. ``wait_s`` blocks (bounded) until the
        router sees zero outstanding work on the host."""
        state = self._hosts.get(host_id)
        if state is None:
            raise KeyError(f"unknown fabric host {host_id!r}")
        with self._lock:
            state.draining = True
            self._purge_host_placement_state_locked(state)
        _M_DIGEST_BLOCKS.set(0, host=host_id)
        flight.record_event("fabric.drain_begin", host=host_id)
        try:
            reqs = state.handle.drain()
        except Exception as e:
            # one retry: a drain interrupted by a transient (or an
            # injected host.drain fault) must not strand the host
            # half-drained
            record_retry("host.drain", "retried")
            try:
                reqs = state.handle.drain()
            except Exception:
                record_retry("host.drain", "exhausted")
                raise
            record_retry("host.drain", "recovered")
            flight.record_event(
                "fabric.drain_retried", host=host_id,
                error=type(e).__name__)
        moved = self._requeue_requests(reqs)
        flight.record_event(
            "fabric.drain_requeued", host=host_id, requeued=moved)
        if migrate_parked:
            self._migrate_parked(state)
        if wait_s is not None:
            deadline = time.monotonic() + wait_s
            while time.monotonic() < deadline:
                with self._lock:
                    if state.outstanding <= 0:
                        break
                time.sleep(0.01)
        return moved

    def _migrate_parked(self, state: _HostState) -> int:
        """Move a draining host's parked sessions onto survivors, each
        to the host the fleet-agreed rendezvous hash of its path anchor
        picks — the SAME key a next-turn prompt extending that session
        hashes to, so stickiness re-derives without any router having
        to remember the move. Best-effort by design: any session a torn
        export/import drops simply re-prefills on resume (exactly the
        pre-migration cost), never fails a request. Returns sessions
        successfully adopted by survivors."""
        try:
            bundle = state.handle.export_parked_sessions()
        except Exception as e:
            flight.record_event(
                "fabric.migrate_export_failed", host=state.host_id,
                error=type(e).__name__)
            return 0
        if not bundle or not bundle.get("sessions"):
            return 0
        bs = int(bundle.get("block_size") or 0)
        with self._lock:
            survivors = sorted(
                hid for hid, s in self._hosts.items()
                if s is not state and not s.draining)
        if not survivors or bs < 1:
            return 0
        per_target: "dict[str, list]" = {}
        for sess in bundle["sessions"]:
            target = hrw_preferred_host(
                path_anchor(sess["tokens"], bs), survivors)
            per_target.setdefault(target, []).append(sess)
        moved = 0
        for hid, sessions in per_target.items():
            tstate = self._hosts.get(hid)
            if tstate is None:
                continue
            sub = dict(bundle)
            sub["sessions"] = sessions
            try:
                moved += int(tstate.handle.import_parked_sessions(sub))
            except Exception as e:
                flight.record_event(
                    "fabric.migrate_import_failed", host=hid,
                    error=type(e).__name__)
        flight.record_event(
            "fabric.migrate", host=state.host_id, sessions=moved,
            targets=sorted(per_target))
        return moved

    def requeue(self, reqs: "list[Request]") -> int:
        """Public transfer entry: hand already-accepted
        :class:`Request` objects to this fabric — the cross-TIER half
        of the drain contract. A :class:`~sparkdl_torch.disagg.PhaseRouter`
        whose decode tier lost a KV handoff re-queues the victim here,
        at the chosen host's queue HEAD (``RequestQueue.requeue``), so
        it re-prefills ahead of later arrivals — zero accepted requests
        lost. Returns the number placed; unplaceable requests fail with
        the placement error, counted once."""
        return self._requeue_requests(reqs)

    def _requeue_requests(self, reqs: "list[Request]") -> int:
        """Hand drained :class:`Request` objects to surviving hosts:
        queue-level transfer where the target is in-process (the
        ``RequestQueue.requeue`` cross-queue contract), submit-and-
        bridge where it is remote. Requests that cannot be placed
        anywhere fail with the placement error — counted once, by this
        final owner."""
        if not reqs:
            return 0
        per_target: "dict[str, list[Request]]" = {}
        moved = 0
        for req in reqs:
            rec = _Placement(req.payload, None, None)
            rec.deadline = req.deadline
            try:
                state = self._place(rec, exclude=None, transfer=True)
            except Exception as e:
                self._fail_transferred(req, e)
                continue
            if hasattr(state.handle, "requeue"):
                per_target.setdefault(state.host_id, []).append(req)
                # the engine owns it now; the router's outstanding
                # charge from _place would never be repaid
                with self._lock:
                    state.outstanding -= 1
            else:
                try:
                    self._bridge_transfer(req, rec, state)
                except Exception as e:
                    # the surviving host refused at the door (raced
                    # drain/close): repay the charge, count the loss
                    # once, here — its final owner
                    with self._lock:
                        state.outstanding -= 1
                    self._fail_transferred(req, e)
                    continue
            moved += 1
        for host_id, batch in per_target.items():
            self._hosts[host_id].handle.requeue(batch)
            flight.record_event(
                "fabric.requeued", host=host_id, requests=len(batch),
                request_ids=[r.request_id for r in batch])
        if moved:
            _M_REQUEUED.inc(moved)
        return moved

    def _fail_transferred(self, req: Request, exc: BaseException) -> None:
        """A drained request that could not be re-placed anywhere dies
        here, counted exactly once (its original host recorded nothing —
        the no-double-count contract)."""
        from sparkdl_torch.serving.queue import record_request_failure

        if req.started or req.future.set_running_or_notify_cancel():
            record_request_failure(exc, request_id=req.request_id)
            try:
                req.future.set_exception(exc)
            except InvalidStateError:
                pass

    def _bridge_transfer(self, req: Request, rec: _Placement,
                         state: _HostState) -> None:
        """Re-place one drained request on a remote host by submitting
        its payload and forwarding the result into the original
        Future (the transfer form queue-level requeue cannot reach)."""
        remaining = None
        if req.deadline is not None:
            remaining = max(0.001, req.deadline - time.monotonic())
        payload = req.payload
        if not isinstance(payload, dict):
            payload = {"prompt": payload.prompt,
                       "max_new_tokens": payload.max_new_tokens}
        inner = state.handle.submit(payload, timeout_s=remaining)
        if not req.started:
            req.future.set_running_or_notify_cancel()
            req.started = True

        def forward(f, req=req, state=state):
            with self._lock:
                state.outstanding -= 1
            exc = (CancelledError("host cancelled the request")
                   if f.cancelled() else f.exception())
            if exc is None:
                try:
                    req.future.set_result(f.result())
                except InvalidStateError:
                    pass
            else:
                self._fail_transferred(req, exc)

        inner.add_done_callback(forward)

    def _purge_host_placement_state_locked(self, state: _HostState
                                           ) -> None:
        """Forget everything that would steer NEW placements at a
        departing host: its sticky sessions re-place on
        survivors at their next turn instead of repeatedly failing over
        to a drained/removed host, and its cached prefix digest stops
        feeding affinity scores for a cache that is about to vanish."""
        state.digest = None
        for k in [k for k, v in self._sessions.items()
                  if v == state.host_id]:
            del self._sessions[k]

    # -- elasticity (the autoscaler's fabric actuators) ----------------------
    def add_host(self, handle: HostHandle) -> str:
        """Join one host to the fabric at runtime (fleet scale-up, or
        the revert of a not-yet-drained scale-down). The host starts
        taking placements as soon as the post-add refresh seeds its
        capacity/digest/health. Returns the host id."""
        state = _HostState(handle, self.max_outstanding,
                           self._make_breaker())
        with self._lock:
            if self._closed:
                raise RuntimeError("Router is closed")
            if state.host_id in self._hosts:
                raise ValueError(
                    f"duplicate host id {state.host_id!r}")
            self._hosts[state.host_id] = state
        flight.record_event(
            "fabric.host_added", host=state.host_id,
            hosts=len(self._hosts))
        # seed only the NEW host (the background thread keeps the rest
        # fresh): joining must not cost O(fleet) handle round-trips
        self._refresh_host(state)
        return state.host_id

    def remove_host(self, host_id: str, *, drain: bool = True
                    ) -> HostHandle:
        """Fleet scale-down: drain one host through the shared
        :meth:`drain_host` path (unstarted requests transfer to
        survivors — zero accepted requests lost) and forget it. The
        HANDLE is returned, not closed — the caller owns the host's
        lifecycle (the autoscaler parks it as spare capacity; an
        un-drained handle can rejoin via :meth:`add_host`). Raises
        ValueError when this is the last host."""
        with self._lock:
            if host_id not in self._hosts:
                raise KeyError(f"unknown fabric host {host_id!r}")
            if len(self._hosts) <= 1:
                raise ValueError(
                    "cannot remove the last fabric host; close() the "
                    "router to stop the fabric")
        if drain:
            requeued = self.drain_host(host_id)
        else:
            requeued = 0
        with self._lock:
            if host_id not in self._hosts:  # raced another removal
                raise KeyError(f"unknown fabric host {host_id!r}")
            if len(self._hosts) <= 1:
                # two concurrent removals of the last two hosts both
                # passed the pre-drain check: the loser stays (drained
                # but listed) rather than emptying the fleet
                raise ValueError(
                    "cannot remove the last fabric host; close() the "
                    "router to stop the fabric")
            state = self._hosts.pop(host_id)
            self._purge_host_placement_state_locked(state)
        _M_DIGEST_BLOCKS.set(0, host=host_id)
        flight.record_event(
            "fabric.host_removed", host=host_id, requeued=requeued,
            hosts=len(self._hosts))
        return state.handle

    def hosts(self) -> "list[str]":
        return list(self._hosts)

    @property
    def closed(self) -> bool:
        return self._closed

    def preferred_host(self, prompt) -> "str | None":
        """PURE fleet-agreed placement for ``prompt`` — the rendezvous
        max over ALL member host ids, ignoring load/health/digests.
        Every router over the same host set returns the same answer in
        any process (the cross-process determinism contract); live
        placement only diverges from it to follow load, affinity, or
        failures. None for an empty prompt."""
        if prompt is None or not len(prompt):
            return None
        with self._lock:
            host_ids = sorted(self._hosts)
            sizes = {s.digest.block_size
                     for s in self._hosts.values()
                     if s.digest is not None}
        pbs = self.placement_block_size or (min(sizes) if sizes else 16)
        return hrw_preferred_host(placement_key(prompt, pbs), host_ids)

    def host_handles(self) -> "list[HostHandle]":
        """Live handles: tier-level aggregations — e.g. the
        PhaseRouter's per-tier depth gauge and the per-tier autoscaler
        signal readers — poll ``capacity()`` across the fleet without
        reaching into router internals."""
        with self._lock:
            return [s.handle for s in self._hosts.values()]

    def fleet_hosts(self) -> "dict[str, HostHandle]":
        """``{host_id: handle}`` for the whole fleet — what
        :meth:`~sparkdl_torch.observability.fleet.FleetScraper.from_router`
        registers so the observability plane polls the same handles the
        router routes over."""
        with self._lock:
            return {hid: s.handle for hid, s in self._hosts.items()}

    def snapshot(self) -> "dict[str, Any]":
        """Operator/postmortem view. Exposes ``replica_count`` /
        ``healthy_count`` in the pool shape ``healthz_report()``
        aggregates — the fabric's hosts ARE this tier's replicas, so an
        all-hosts-down fabric degrades /healthz to unhealthy exactly
        like a dead replica pool would."""
        with self._lock:
            hosts = [
                {
                    "host": s.host_id,
                    "outstanding": s.outstanding,
                    "routed": s.routed,
                    "weight": s.weight,
                    "saturation": s.saturation,
                    "quarantined": s.quarantined,
                    "draining": s.draining,
                    "health": s.health_status,
                    "free_slots": s.free_slots,
                    "kv_free": s.kv_free,
                    "kv_total": s.kv_total,
                    "kv_cold": s.kv_cold,
                    "kv_parked_sessions": s.kv_parked_sessions,
                    "consecutive_failures": s.consecutive_failures,
                    "digest_blocks": (len(s.digest.hashes)
                                      if s.digest is not None else 0),
                    "digest_age_s": (round(s.digest.age_s(), 3)
                                     if s.digest is not None else None),
                }
                for s in self._hosts.values()
            ]
            sessions = len(self._sessions)
        healthy = sum(
            not h["quarantined"] and not h["draining"]
            and h["health"] not in ("unhealthy", "unreachable")
            for h in hosts)
        return {
            "policy": self.policy,
            "replica_count": len(hosts),
            "healthy_count": healthy,
            "hosts": hosts,
            "sessions": sessions,
        }

    def close(self) -> None:
        """Stop the router (refresh thread, registrations). Hosts are
        NOT closed — the caller owns their lifecycle (a router restart
        must not restart the fleet)."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        self._closing.set()
        if self._refresh_thread is not None:
            self._refresh_thread.join(timeout=5)
        flight.record_event("fabric.close", router=self._flight_name)
        flight.remove_context_provider(self._flight_name)

    def __enter__(self) -> "Router":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
