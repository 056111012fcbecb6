"""Fleet-level elastic autoscaler.

The ingest AutoTuner closes the loop from the metrics spine to the
*ingest* knobs; this controller closes the same loop at the *fleet*
level — the dynamic-placement posture the TensorFlow system paper
(arXiv 1605.08695) argues a long-running service needs. It reads
three pressure signals —

* **SLO burn rate** — the worst dimension across every registered
  :class:`~sparkdl_torch.observability.slo.SLOTracker` (latency burn,
  availability burn);
* **queue depth** — ``sparkdl_queue_depth``, normalized per healthy
  replica;
* **KV deferral streaks** — the block pool's
  :attr:`~sparkdl_torch.serving.kv_blocks.KVBlockPool.deferral_streak`
  (admissions deferring = capacity pressure *before* it becomes SLO
  burn)

— and actuates three tiers:

* **replicas** — :meth:`ReplicaPool.add_replica` /
  :meth:`ReplicaPool.remove_replica`: scale-down is drain-safe (the
  victim's unstarted work transfers to survivors through the same
  requeue path a quarantine uses — zero accepted requests lost);
* **KV blocks** — :meth:`KVBlockPool.grow` / :meth:`KVBlockPool.shrink`
  between serving and spare capacity: grow on deferral streaks, shrink
  only when the free list covers the worst recorded need;
* **fabric hosts** — :meth:`Router.remove_host`, which rides the
  router's ``drain_host`` transfer path, so the router and pool tiers share ONE
  drain contract. Removed handles park on :attr:`AutoScaler.spare_hosts`
  (the caller owns their lifecycle).

The control law is the AutoTuner's discipline transplanted: a direction
must hold for ``hysteresis`` consecutive ticks before anything moves,
every move is one bounded step followed by ``cooldown_ticks`` of
quiet, and every scale-DOWN arms an SLO-burn **veto** — burn at or above
``veto_burn`` inside ``veto_window_ticks`` reverts the move (a replica
comes back, parked KV blocks return to service, a parked fabric host
rejoins) and puts the direction on a ``tabu_ticks`` blocklist. The
fabric tier scales BOTH ways: a sustained up-vote with no replica
headroom re-opens the most recently parked ``spare_hosts`` handle
(``InProcessHost.reopen`` → ``Router.add_host``), bounded by
``max_hosts``; the same rejoin path reverts a vetoed host scale-down.

Reliability: ``autoscale.decide`` is a fault site at the top of every
decision pass, and the actuators carry their own sites
(``replica.scale_down``, ``kv_pool.resize``) *before* any state moves —
an injected fault therefore **defers** the decision (state
``deferred``, retried next tick) instead of losing work mid-drain.
``/healthz`` reads the controller's state through its flight context
provider: ``degraded`` during a vetoed/deferred scale event, ``ok``
after recovery. Every decision lands in the flight recorder
(``autoscale.decision`` / ``autoscale.veto`` / ``autoscale.deferred``)
and the ``sparkdl_autoscale_*`` metric families.

Pinning: ``replicas=`` or ``SPARKDL_TORCH_REPLICAS`` (via the shared
``resolve_pin`` contract) pins the replica count — the controller then
*converges* the pool to the pinned count through the same drain-safe
actuators and never reacts to signals (KV and fabric tiers keep
scaling; they have their own capacity meaning).

On the card, ``warmup_arrays`` (a dict, or a list of dicts: one per
bucket) runs on an added replica before it joins routing, so each of
its buckets' CUDA graphs is captured before live traffic reaches it.

Determinism for tests: the signal reader and clock are injectable and
``tick()`` may be driven manually instead of via :meth:`AutoScaler.start`.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from typing import Any, Callable, NamedTuple

from sparkdl_torch.observability import flight
from sparkdl_torch.observability.registry import GaugeShare, registry
from sparkdl_torch.reliability.faults import fault_point

__all__ = [
    "AutoScaler",
    "AutoscalePolicy",
    "read_autoscale_signals",
]

_log = logging.getLogger(__name__)

_METRICS = None


class _ScalerMetrics(NamedTuple):
    ticks: Any
    decisions: Any
    vetoes: Any
    deferred: Any
    replicas: Any
    errors: Any


def _metrics() -> _ScalerMetrics:
    global _METRICS
    if _METRICS is None:
        _METRICS = _ScalerMetrics(
            ticks=registry().counter(
                "sparkdl_autoscale_ticks_total",
                "autoscaler control-loop samples taken"),
            decisions=registry().counter(
                "sparkdl_autoscale_decisions_total",
                "autoscaler scale moves applied (reverts included)",
                labels=("actuator", "direction")),
            vetoes=registry().counter(
                "sparkdl_autoscale_vetoes_total",
                "scale-downs reverted/tabued by an SLO-burn spike "
                "inside the veto window",
                labels=("actuator",)),
            deferred=registry().counter(
                "sparkdl_autoscale_deferred_total",
                "scale decisions deferred by a fault mid-pass (the "
                "faulted actuator moved nothing; already-applied "
                "moves this tick keep their cooldown; retried next "
                "tick)"),
            replicas=registry().gauge(
                "sparkdl_autoscale_replicas",
                "replica count of each autoscaled pool, all "
                "controllers"),
            errors=registry().counter(
                "sparkdl_autoscale_tick_errors_total",
                "autoscaler samples that raised outside the decision "
                "path (broken signal reader)"),
        )
    return _METRICS


def read_autoscale_signals() -> "tuple[float, float]":
    """The default signal reader: ``(queue_depth, slo_burn_rate)``
    straight off the spine — the summed ``sparkdl_queue_depth`` gauge
    and the worst burn dimension across every registered SLO tracker
    (sampling them refreshes the ``sparkdl_slo_*`` gauges too, exactly
    like a ``/slo.json`` scrape)."""
    from sparkdl_torch.observability.slo import slo_report

    burn = 0.0
    for rep in slo_report():
        for dim in ("latency", "availability"):
            d = rep.get(dim)
            if isinstance(d, dict) and d.get("burn_rate") is not None:
                burn = max(burn, float(d["burn_rate"]))
    depth = 0.0
    fam = registry().get("sparkdl_queue_depth")
    if fam is not None:
        for v in fam.snapshot_values().values():
            if isinstance(v, (int, float)):
                depth += float(v)
    return depth, burn


@dataclasses.dataclass(frozen=True)
class AutoscalePolicy:
    """The control-law constants (see module docstring).

    ``queue_high``/``queue_low`` are queued requests PER HEALTHY
    REPLICA: a vote to grow needs sustained depth or burn
    (``burn_high``), a vote to shrink needs BOTH depth and burn quiet
    (``queue_low`` and ``burn_low``) — scale-down is the dangerous
    direction, so its gate is conjunctive. ``veto_burn`` is the
    post-scale-down burn that reverts the move inside
    ``veto_window_ticks``. ``kv_step_blocks`` is the KV resize grain;
    shrink additionally keeps ``2 x kv_step_blocks`` of free headroom
    over the pool's worst recorded need.
    """

    min_replicas: int = 1
    max_replicas: int = 8
    queue_high: float = 4.0
    queue_low: float = 0.5
    burn_high: float = 1.0
    burn_low: float = 0.25
    hysteresis: int = 2
    cooldown_ticks: int = 2
    veto_window_ticks: int = 3
    veto_burn: float = 1.0
    tabu_ticks: int = 20
    kv_step_blocks: int = 8
    min_hosts: int = 1
    max_hosts: int = 8

    def __post_init__(self):
        if self.min_replicas < 1:
            raise ValueError(
                f"min_replicas must be >= 1, got {self.min_replicas}")
        if self.max_replicas < self.min_replicas:
            raise ValueError(
                f"max_replicas {self.max_replicas} < min_replicas "
                f"{self.min_replicas}")
        if self.hysteresis < 1:
            raise ValueError(
                f"hysteresis must be >= 1, got {self.hysteresis}")
        if self.queue_low >= self.queue_high:
            raise ValueError(
                f"queue_low {self.queue_low} must be < queue_high "
                f"{self.queue_high}")
        if self.kv_step_blocks < 1:
            raise ValueError(
                f"kv_step_blocks must be >= 1, got {self.kv_step_blocks}")
        if self.min_hosts < 1:
            raise ValueError(
                f"min_hosts must be >= 1, got {self.min_hosts}")
        if self.max_hosts < self.min_hosts:
            raise ValueError(
                f"max_hosts {self.max_hosts} < min_hosts "
                f"{self.min_hosts}")


class AutoScaler:
    """The fleet controller (see module docstring). Wire any subset of
    actuators::

        scaler = AutoScaler(
            pool=replica_pool,                  # replica tier
            kv_pool=pool, kv_lock=lock,         # engine.kv_autoscale_binding()
            router=router,                      # fabric tier
            policy=AutoscalePolicy(max_replicas=4),
        ).start()

    ``kv_lock`` is the lock guarding the pool's bookkeeping (the engine
    lock — :meth:`ContinuousGPTEngine.kv_autoscale_binding` returns the
    pair). ``signals``/``clock`` are injectable; drive :meth:`tick`
    manually for deterministic tests. ``warmup_arrays`` (optional; a
    dict, or a list of dicts, one per bucket) is dispatched to every
    replica the controller adds BEFORE it joins routing, so scale-up
    never serves a cold graph capture to live traffic.
    """

    def __init__(self, *,
                 pool: Any = None,
                 kv_pool: Any = None,
                 kv_lock: "threading.Lock | None" = None,
                 router: Any = None,
                 policy: "AutoscalePolicy | None" = None,
                 replicas: "int | None" = None,
                 warmup_arrays: "dict | list[dict] | None" = None,
                 host_selector: "Callable[[dict], str | None] | None" = None,
                 signals: "Callable[[], tuple] | None" = None,
                 interval_s: float = 0.25,
                 clock: Callable[[], float] = time.monotonic):
        from sparkdl_torch.ingest.pipeline import resolve_pin

        if pool is None and kv_pool is None and router is None:
            raise ValueError(
                "an AutoScaler needs at least one actuator: pool=, "
                "kv_pool=, or router=")
        if kv_pool is not None and kv_lock is None:
            # a silently-manufactured private lock would let grow/shrink
            # race the engine's allocate/release — the exact corruption
            # kv_autoscale_binding() exists to prevent. Controller-
            # private pools pass their own threading.Lock().
            raise ValueError(
                "kv_pool= needs kv_lock= — the lock that guards the "
                "pool's bookkeeping (ContinuousGPTEngine."
                "kv_autoscale_binding() returns the pair)")
        self.policy = policy if policy is not None else AutoscalePolicy()
        self.pool = pool
        self.kv_pool = kv_pool
        self._kv_lock = kv_lock if kv_lock is not None else threading.Lock()
        self.router = router
        self.warmup_arrays = warmup_arrays
        self._host_selector = host_selector
        pin_value, pinned, pin_source = resolve_pin(
            replicas, "SPARKDL_TORCH_REPLICAS", 0, what="replicas")
        #: pinned replica count (None = elastic): the controller
        #: CONVERGES the pool to the pin and never reacts to signals
        self._pin: "int | None" = pin_value if pinned else None
        self._pin_source = pin_source
        self._signals = (signals if signals is not None
                         else read_autoscale_signals)
        self._clock = clock
        self.interval_s = interval_s
        #: "ok" | "deferred" (a decision hit a fault; retrying) |
        #: "vetoed" (a scale-down was reverted; cooling down) — what
        #: healthz_report() reads as degraded until recovery
        self.state = "ok"
        self._streak_dir = 0
        self._streak = 0
        self._cooldown = 0
        #: consecutive quiet ticks where a KV shrink was blocked by
        #: the host tier's unpark reservations —
        #: snapshot()/healthz read >0 as degraded; self-clearing
        self._kv_shrink_blocked_streak = 0
        #: direction ("up"/"down") -> ticks it stays blocked
        self._tabu: "dict[str, int]" = {}
        #: armed scale-downs awaiting their SLO-burn verdict
        self._pending_vetoes: "list[dict]" = []
        #: fabric handles removed by fleet scale-down (caller-owned)
        self.spare_hosts: "list[Any]" = []
        self.decision_count = 0
        self.last_decision: "dict | None" = None
        self.last_signals: "dict[str, float]" = {}
        self._g_replicas = GaugeShare(_metrics().replicas)
        self._thread: "threading.Thread | None" = None
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._closed = False
        # process-wide registrations LAST (the engine-constructor rule):
        # /healthz and postmortem bundles read live controller state here
        self._flight_name = flight.add_context_provider(
            f"autoscale-{id(self):x}", self.snapshot)
        flight.record_event(
            "autoscale.start", controller=self._flight_name,
            replicas=(len(pool.replicas) if pool is not None else None),
            pinned=self._pin,
        )
        self._publish_gauges()

    # -- the control loop ----------------------------------------------------
    def tick(self) -> int:
        """One sample -> at most a handful of bounded moves; returns
        the moves applied (reverts included). A fault anywhere in the
        decision path (the ``autoscale.decide`` site, or an actuator's
        own site firing before state moved) DEFERS the decision: state
        ``deferred``, the faulted actuator moved nothing (its site
        fires before mutation), and the pass retries next tick — a
        move that already landed earlier in the same pass keeps its
        post-move cooldown."""
        m = _metrics()
        m.ticks.inc()
        now = self._clock()
        sig = self._signals()
        queue_depth, burn = float(sig[0]), float(sig[1])
        self.last_signals = {"queue_depth": queue_depth,
                             "burn_rate": burn}
        for d in list(self._tabu):
            self._tabu[d] -= 1
            if self._tabu[d] <= 0:
                del self._tabu[d]
        try:
            moved = self._decide(now, queue_depth, burn)
        except Exception as e:
            self.state = "deferred"
            m.deferred.inc()
            flight.record_event(
                "autoscale.deferred", error=type(e).__name__)
            _log.warning("autoscale decision deferred: %r", e)
            moved = 0
        self._publish_gauges()
        return moved

    def _decide(self, now: float, queue_depth: float,
                burn: float) -> int:
        fault_point("autoscale.decide")
        if self.state == "deferred":
            self.state = "ok"  # the decision path is reachable again
        moved = 0
        # 1) the veto watch runs FIRST — including during cooldown: a
        # scale-down that spikes burn must revert promptly
        if self._pending_vetoes:
            if burn >= self.policy.veto_burn:
                # the veto IS this tick's decision: the reverts land,
                # cooldown starts NEXT tick, and the vetoed state holds
                # until that cooldown recovers
                return self._veto_all(burn)
            else:
                for entry in self._pending_vetoes:
                    entry["ticks"] -= 1
                self._pending_vetoes = [
                    e for e in self._pending_vetoes if e["ticks"] > 0]
        # 2) post-move cooldown: the last move's effect is what the
        # next vote must see, not the transient it caused
        if self._cooldown > 0:
            self._cooldown -= 1
            self._streak = 0
            self._streak_dir = 0
            if self._cooldown == 0 and self.state == "vetoed" \
                    and not self._pending_vetoes:
                self.state = "ok"  # recovered
            return moved
        if self.state == "vetoed" and not self._pending_vetoes:
            self.state = "ok"
        # 3) pinned replica count: converge, never react
        if self._pin is not None:
            moved += self._converge_pin()
            if moved:
                self._cooldown = self.policy.cooldown_ticks
            return moved
        # 4) urgent KV grow first: a deferral streak is LIVE pressure
        # (admissions deferring right now), no hysteresis needed
        moved += self._kv_grow_if_starved()
        try:
            # 5) replica/fleet tier: direction vote with hysteresis
            direction = self._vote(queue_depth, burn)
            from sparkdl_torch.serving import tenancy

            if direction < 0 and tenancy.overload_level() > 0:
                # brownout veto: the process is above normal
                # on the overload ladder — shrinking capacity now would
                # deepen the very overload the ladder is shedding. A
                # down-vote simply does not count until level 0.
                direction = 0
                flight.record_event(
                    "autoscale.overload_vetoed_down",
                    level=tenancy.overload_level())
            key = "up" if direction > 0 else "down"
            if direction == 0 or key in self._tabu:
                self._streak = 0
                self._streak_dir = 0
            else:
                if direction != self._streak_dir:
                    self._streak_dir = direction
                    self._streak = 1
                else:
                    self._streak += 1
                if self._streak >= self.policy.hysteresis:
                    moved += (self._scale_up() if direction > 0
                              else self._scale_down())
                    self._streak = 0
                    self._streak_dir = 0
            # 6) KV shrink LAST, and only on a tick where nothing else
            # moved and the queue is quiet too: parking capacity mid-
            # spike (or mid-scale) would starve the very scale-up the
            # spike needs — each shrink's cooldown would eat the
            # up-vote's window
            if not moved:
                moved += self._kv_shrink_if_quiet(queue_depth, burn)
        except Exception:
            # a later actuator faulted (the pass defers) — but a KV
            # grow that already landed this tick keeps its post-move
            # cooldown: the one-bounded-move discipline holds even on
            # a deferred pass
            if moved:
                self._cooldown = self.policy.cooldown_ticks
            raise
        if moved:
            self._cooldown = self.policy.cooldown_ticks
        return moved

    def _vote(self, queue_depth: float, burn: float) -> int:
        per = queue_depth / max(1, self._healthy_replicas())
        if per >= self.policy.queue_high or burn >= self.policy.burn_high:
            return 1
        if per <= self.policy.queue_low and burn <= self.policy.burn_low:
            return -1
        return 0

    def _healthy_replicas(self) -> int:
        if self.pool is not None:
            return sum(1 for r in list(self.pool.replicas)
                       if not r.quarantined)
        if self.router is not None:
            return int(self.router.snapshot().get("healthy_count") or 1)
        return 1

    # -- actuators -----------------------------------------------------------
    def _scale_up(self) -> int:
        if self.pool is not None \
                and len(self.pool.replicas) < self.policy.max_replicas:
            index = self.pool.add_replica(
                warmup_arrays=self.warmup_arrays)
            self._record("replica", "up", replica=index,
                         replicas=len(self.pool.replicas))
            return 1
        if (self.router is not None and self.spare_hosts
                and len(self.router.hosts()) < self.policy.max_hosts):
            # fabric-tier scale-UP: re-open the most
            # recently parked handle and rejoin it — the scaler can
            # grow a tier again, not just shrink it
            host = self._rejoin_spare_host()
            if host is not None:
                self._record("host", "up", host=host,
                             hosts=len(self.router.hosts()))
                return 1
        return 0

    def _rejoin_spare_host(self) -> "str | None":
        """Reopen the newest ``spare_hosts`` handle and rejoin it via
        :meth:`Router.add_host`. On failure the handle goes back on the
        spare list (nothing is half-joined: add_host is the last step)."""
        handle = self.spare_hosts.pop()
        try:
            fn = getattr(handle, "reopen", None)
            if callable(fn):
                fn()
            return self.router.add_host(handle)
        except Exception:
            self.spare_hosts.append(handle)
            _log.warning(
                "spare-host rejoin failed (handle stays parked)",
                exc_info=True)
            return None

    def _scale_down(self) -> int:
        pool = self.pool
        if pool is not None \
                and len(pool.replicas) > self.policy.min_replicas:
            # short join: the transfer + in-flight-completion contract
            # does not depend on the worker's exit, and a wedged victim
            # stays under the pool's watchdog scan — the control loop
            # (veto watch, urgent KV grow) must not stall 30 s on it
            index = pool.remove_replica(timeout_s=1.0)
            self._record("replica", "down", replica=index,
                         replicas=len(pool.replicas))
            self._arm_veto("replica", {})
            return 1
        if self.router is not None \
                and len(self.router.hosts()) > self.policy.min_hosts:
            host = self._select_host()
            if host is not None:
                # rides drain_host: unstarted requests transfer to
                # survivors; the handle parks as spare capacity
                handle = self.router.remove_host(host)
                self.spare_hosts.append(handle)
                self._record("host", "down", host=host,
                             hosts=len(self.router.hosts()))
                self._arm_veto("host", {"host": host})
                return 1
        return 0

    def _select_host(self) -> "str | None":
        snap = self.router.snapshot()
        hosts = [h for h in snap.get("hosts", ())
                 if not h.get("draining")]
        if self._host_selector is not None:
            return self._host_selector(snap)
        if not hosts:
            return None
        # least outstanding work = cheapest drain
        return min(hosts, key=lambda h: h.get("outstanding") or 0)["host"]

    def _kv_grow_if_starved(self) -> int:
        pool = self.kv_pool
        if pool is None:
            return 0
        with self._kv_lock:
            starved = pool.deferral_streak > 0 and pool.spare_count > 0
            if not starved:
                return 0
            n = pool.grow(self.policy.kv_step_blocks)
            # the kv_pool.resize site fires inside grow() BEFORE any
            # bookkeeping moves: an injected fault propagates out of
            # this tick as a deferred decision
        if n:
            self._record("kv", "up", blocks=n, spare=pool.spare_count)
            return 1
        return 0

    def _kv_shrink_if_quiet(self, queue_depth: float,
                            burn: float) -> int:
        pool = self.kv_pool
        if pool is None:
            return 0
        step = self.policy.kv_step_blocks
        per = queue_depth / max(1, self._healthy_replicas())
        with self._kv_lock:
            quiet = (pool.deferral_streak == 0
                     and burn <= self.policy.burn_low
                     and per <= self.policy.queue_low
                     and pool.free_count >= max(1, pool.need_peak)
                     + 2 * step)
            if not quiet:
                return 0
            n = pool.shrink(step)
            reserved = getattr(pool, "unpark_reserved", 0)
        if n:
            self._kv_shrink_blocked_streak = 0
            self._record("kv", "down", blocks=n,
                         spare=pool.spare_count)
            self._arm_veto("kv", {"blocks": n})
            return 1
        if reserved > 0:
            # quiet by every signal, yet shrink moved nothing: the
            # host tier's unpark reservations hold the floor. Defer —
            # scaling down now would strand parked sessions' resumes
            # behind re-prefills. The streak reads
            # as degraded in healthz and self-clears when sessions
            # resume (reservations drop) or the next shrink lands.
            self._kv_shrink_blocked_streak += 1
            if self._kv_shrink_blocked_streak == 1:
                # record the episode's start, not every blocked tick —
                # the streak in snapshot()/healthz carries the duration
                self._record("kv", "shrink_blocked",
                             unpark_reserved=reserved)
        else:
            self._kv_shrink_blocked_streak = 0
        return 0

    def _converge_pin(self) -> int:
        if self.pool is None:
            return 0
        cur = len(self.pool.replicas)
        target = max(1, int(self._pin or 0))
        if cur < target:
            index = self.pool.add_replica(
                warmup_arrays=self.warmup_arrays)
            self._record("replica", "up", replica=index, pinned=True)
            return 1
        if cur > target:
            index = self.pool.remove_replica(timeout_s=1.0)
            self._record("replica", "down", replica=index, pinned=True)
            return 1
        return 0

    # -- veto ----------------------------------------------------------------
    def _arm_veto(self, actuator: str, detail: dict) -> None:
        self._pending_vetoes.append({
            "actuator": actuator,
            "ticks": self.policy.veto_window_ticks,
            "detail": detail,
        })

    def _veto_all(self, burn: float) -> int:
        """SLO burn spiked inside a scale-down's veto window: revert
        every armed scale-down (replica back in, parked KV blocks back
        in service, the parked host handle reopened and rejoined),
        tabu the direction, and read degraded until the cooldown
        recovers."""
        vetoes, self._pending_vetoes = self._pending_vetoes, []
        n = 0
        for entry in vetoes:
            actuator = entry["actuator"]
            _metrics().vetoes.inc(actuator=actuator)
            reverted = False
            if actuator == "replica" and self.pool is not None \
                    and len(self.pool.replicas) < self.policy.max_replicas:
                # the ceiling binds reverts too: a scale-up that landed
                # between the scale-down and this veto must not let the
                # revert push the pool past max_replicas
                try:
                    self.pool.add_replica(
                        warmup_arrays=self.warmup_arrays)
                    reverted = True
                except Exception:
                    _log.warning("veto revert add_replica failed "
                                 "(tabu still holds)", exc_info=True)
            elif actuator == "kv" and self.kv_pool is not None:
                with self._kv_lock:
                    blocks = int(entry["detail"].get("blocks") or 0)
                    try:
                        reverted = self.kv_pool.grow(blocks) > 0
                    except Exception:
                        _log.warning("veto revert kv grow failed "
                                     "(tabu still holds)",
                                     exc_info=True)
            elif actuator == "host" and self.router is not None \
                    and self.spare_hosts \
                    and len(self.router.hosts()) < self.policy.max_hosts:
                # the rejoin path closes the tabu-only asymmetry: a
                # vetoed host scale-down brings the parked handle back
                # instead of waiting for an operator
                reverted = self._rejoin_spare_host() is not None
            self._record(actuator, "revert", reverted=reverted,
                         burn=round(burn, 3))
            flight.record_event(
                "autoscale.veto", actuator=actuator,
                burn=round(burn, 3), reverted=reverted)
            n += 1
        self._tabu["down"] = self.policy.tabu_ticks
        self._cooldown = max(self._cooldown, self.policy.cooldown_ticks)
        self.state = "vetoed"
        return n

    # -- bookkeeping ---------------------------------------------------------
    def _record(self, actuator: str, direction: str, **detail) -> None:
        _metrics().decisions.inc(actuator=actuator, direction=direction)
        self.decision_count += 1
        self.last_decision = {"actuator": actuator,
                              "direction": direction, **detail}
        # the decision HISTORY is what postmortems need (the AutoTuner
        # lesson): the replica count alone hides the causality
        flight.record_event(
            "autoscale.decision", actuator=actuator,
            direction=direction, **detail)

    def _publish_gauges(self) -> None:
        if self.pool is not None:
            self._g_replicas.set(
                0 if self._closed else len(self.pool.replicas))

    def snapshot(self) -> "dict[str, Any]":
        """Operator/healthz view, under the ``"autoscaler"`` key the
        :func:`~sparkdl_torch.observability.flight.healthz_report`
        aggregation reads (``vetoed``/``deferred`` -> degraded)."""
        kv = None
        if self.kv_pool is not None:
            kv = {
                "serving": self.kv_pool.serving_count,
                "spare": self.kv_pool.spare_count,
                "free": self.kv_pool.free_count,
                "need_peak": self.kv_pool.need_peak,
                "deferral_streak": self.kv_pool.deferral_streak,
                "unpark_reserved": getattr(
                    self.kv_pool, "unpark_reserved", 0),
                "shrink_blocked_streak": self._kv_shrink_blocked_streak,
            }
        return {"autoscaler": {
            "state": self.state,
            "replicas": (len(self.pool.replicas)
                         if self.pool is not None else None),
            "pinned": self._pin,
            "pin_source": self._pin_source,
            "cooldown_ticks": self._cooldown,
            "tabu": dict(self._tabu),
            "pending_vetoes": len(self._pending_vetoes),
            "decisions": self.decision_count,
            "last_decision": self.last_decision,
            "signals": dict(self.last_signals),
            "kv": kv,
            "hosts": (len(self.router.hosts())
                      if self.router is not None else None),
            "spare_hosts": len(self.spare_hosts),
        }}

    # -- cadence thread / lifecycle ------------------------------------------
    def start(self) -> "AutoScaler":
        """Run :meth:`tick` every ``interval_s`` on a daemon thread
        (idempotent; the AutoTuner's fresh-stop-event discipline)."""
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return self
            stop = self._stop = threading.Event()
            self._thread = threading.Thread(
                target=self._loop, args=(stop,),
                name="sparkdl-autoscale", daemon=True,
            )
            self._thread.start()
        return self

    def _loop(self, stop: threading.Event) -> None:
        logged = False
        while not stop.wait(self.interval_s):
            try:
                self.tick()
            except Exception:
                # tick() already absorbs decision-path faults as
                # "deferred"; only a broken signal reader lands here —
                # count every failure, log the first with traceback
                _metrics().errors.inc()
                if not logged:
                    logged = True
                    _log.warning(
                        "autoscaler tick failed (continuing; counted "
                        "in sparkdl_autoscale_tick_errors_total)",
                        exc_info=True)
                continue

    def stop(self) -> None:
        with self._lock:
            self._stop.set()
            t = self._thread
            self._thread = None
        if t is not None and t.is_alive():
            t.join(timeout=2.0)

    def close(self) -> None:
        """Stop the cadence thread and retract process-wide
        registrations (idempotent). Actuated objects are NOT closed —
        the caller owns pool/engine/router lifecycles."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        self.stop()
        flight.record_event(
            "autoscale.close", controller=self._flight_name,
            decisions=self.decision_count)
        flight.remove_context_provider(self._flight_name)
        self._g_replicas.set(0)

    def __enter__(self) -> "AutoScaler":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()
