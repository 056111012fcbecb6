"""Multi-tenant QoS: admission quotas, fair weights, brownout ladder.

Without it every request is anonymous: one hot tenant flooding
``RequestQueue.submit`` starves everyone else, and the only overload
response is a binary ``QueueFullError``. This module is the identity
and policy layer:

* :class:`TenantRegistry` — per-tenant **token buckets** (rate +
  burst, runtime re-configurable) reject over-quota submits with a
  typed :class:`TenantThrottledError` at the door, *before* the
  request consumes queue depth. Unknown tenants (and the ``default``
  tenant nobody configured) are admitted unconditionally — every
  existing single-user call site behaves bitwise as before. The
  registry also owns per-tenant accounting: admitted/shed/failed
  counters, a per-tenant latency histogram, and rolling per-tenant
  SLO compliance/burn reusing the exact
  :meth:`~sparkdl_torch.observability.slo.SLOTracker._dimension`
  arithmetic, published under the same ``sparkdl_slo_*`` gauges with
  ``slo="tenant:<name>"`` labels.
* **Priority classes** — requests carry an integer ``priority``
  (LOWER is MORE urgent; :data:`PRIORITY_INTERACTIVE` = 0 is the
  default, :data:`PRIORITY_BACKGROUND` = 10 is the offline class).
  :class:`~sparkdl_torch.serving.queue.RequestQueue` serves classes in
  strict priority order and tenants *within* a class by
  deficit-weighted round-robin, so a deep queue from one tenant
  cannot monopolize micro-batch slots.
* :class:`OverloadController` — the process-wide **brownout ladder**.
  Driven by SLO burn + queue depth, it steps through degradation
  levels (shed the background class → shrink spec_k/chain_tokens →
  double-charge quota'd tenants → reject new work) and back down,
  with the same hold-N-consecutive-ticks hysteresis discipline the
  AutoTuner/AutoScaler use, so a noisy signal cannot flap the fleet.
  Levels land in ``/healthz`` (via a flight health fact), in
  flight-recorder events, and in every engine's ``capacity()`` so the
  fabric's routers steer traffic around browned-out hosts.

Everything here is deliberately import-light (observability spine
only): ``queue.py`` imports this module, never the reverse.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Any, Callable, Dict, Optional

from sparkdl_torch.observability import flight
from sparkdl_torch.observability.registry import registry
from sparkdl_torch.observability.slo import SLOTracker

__all__ = [
    "BrownoutShedError",
    "OverloadController",
    "PRIORITY_BACKGROUND",
    "PRIORITY_INTERACTIVE",
    "TenantRegistry",
    "TenantThrottledError",
    "TokenBucket",
    "overload_level",
    "process_overload",
    "set_process_overload",
]

#: The default class every existing call site lands in (lower = more
#: urgent; anything < PRIORITY_BACKGROUND is "interactive-ish").
PRIORITY_INTERACTIVE = 0
#: The lowest class: offline/batch work (BatchPrefillFiller, bulk
#: scoring). First shed by the brownout ladder, last served by the
#: scheduler, preemptible mid-prefill by any higher class.
PRIORITY_BACKGROUND = 10

_M_ADMITTED = registry().counter(
    "sparkdl_tenant_admitted_total",
    "requests admitted through a tenant quota check", labels=("tenant",))
_M_SHED = registry().counter(
    "sparkdl_tenant_shed_total",
    "submits rejected over-quota (TenantThrottledError) or by the "
    "brownout ladder (BrownoutShedError)", labels=("tenant",))
_M_FAILED = registry().counter(
    "sparkdl_tenant_failed_total",
    "accepted requests that resolved with an error, per tenant",
    labels=("tenant",))
_M_LATENCY = registry().histogram(
    "sparkdl_tenant_latency_seconds",
    "request latency (submit to result) per tenant",
    labels=("tenant",))
_M_PREEMPTIONS = registry().counter(
    "sparkdl_tenant_preemptions_total",
    "chunked prefills preempted between chunks by a higher-priority "
    "arrival (victim re-queued at its class head, zero lost)")
_M_OVERLOAD_LEVEL = registry().gauge(
    "sparkdl_overload_level",
    "current brownout ladder level (0=normal, 1=shed background, "
    "2=degrade quality, 3=throttle tenants, 4=reject)")
_M_OVERLOAD_TRANSITIONS = registry().counter(
    "sparkdl_overload_transitions_total",
    "brownout ladder level changes", labels=("direction",))
_M_OVERLOAD_SHED = registry().counter(
    "sparkdl_overload_shed_total",
    "submits rejected by the brownout ladder, by the level that shed "
    "them", labels=("level",))


class TenantThrottledError(RuntimeError):
    """Over-quota submit: the tenant's token bucket is empty. Typed —
    the flooder's overage is shed at the door, distinguishable from
    capacity backpressure (``QueueFullError``) and never a timeout."""

    def __init__(self, tenant: str, msg: "str | None" = None):
        super().__init__(
            msg or f"tenant {tenant!r} is over its admission quota; "
            "retry with backoff")
        self.tenant = tenant


class BrownoutShedError(RuntimeError):
    """The brownout ladder shed this submit (level >= 1 sheds the
    background class, level 4 sheds everything). Admission-time only —
    accepted requests are never failed by a level change."""

    def __init__(self, level: int, msg: str):
        super().__init__(msg)
        self.level = level


class TokenBucket:
    """Classic rate + burst token bucket (not self-locking — the
    owning :class:`TenantRegistry` serializes). ``rate`` is tokens/sec
    refilled continuously, ``burst`` the bucket capacity (also the
    initial fill, so a fresh tenant can burst immediately)."""

    __slots__ = ("rate", "burst", "tokens", "_last")

    def __init__(self, rate: float, burst: float,
                 now: "float | None" = None):
        if rate <= 0:
            raise ValueError(f"rate must be > 0, got {rate}")
        if burst < 1:
            raise ValueError(f"burst must be >= 1, got {burst}")
        self.rate = float(rate)
        self.burst = float(burst)
        self.tokens = float(burst)
        self._last = now if now is not None else time.monotonic()

    def reconfigure(self, rate: "float | None" = None,
                    burst: "float | None" = None) -> None:
        """Runtime re-configuration: new rate applies from now; a
        shrunk burst clamps the current fill (no retroactive debt)."""
        if rate is not None:
            if rate <= 0:
                raise ValueError(f"rate must be > 0, got {rate}")
            self.rate = float(rate)
        if burst is not None:
            if burst < 1:
                raise ValueError(f"burst must be >= 1, got {burst}")
            self.burst = float(burst)
            self.tokens = min(self.tokens, self.burst)

    def try_acquire(self, now: "float | None" = None,
                    cost: float = 1.0) -> bool:
        now = now if now is not None else time.monotonic()
        if now > self._last:
            self.tokens = min(self.burst,
                              self.tokens + self.rate * (now - self._last))
        self._last = max(self._last, now)
        if self.tokens >= cost:
            self.tokens -= cost
            return True
        return False


class _TenantSpec:
    """One tenant's policy + rolling outcome window (registry-locked)."""

    __slots__ = ("name", "bucket", "weight", "priority", "admitted",
                 "shed", "failed", "completed", "outcomes")

    def __init__(self, name: str):
        self.name = name
        self.bucket: "TokenBucket | None" = None
        self.weight = 1.0
        self.priority: "int | None" = None
        self.admitted = 0
        self.shed = 0
        self.failed = 0
        self.completed = 0
        #: rolling (t, latency_s, ok) samples for per-tenant SLO math
        self.outcomes: "collections.deque[tuple]" = collections.deque()


class TenantRegistry:
    """Thread-safe tenant policy map + per-tenant accounting.

    ``configure(tenant, rate=, burst=, weight=, priority=)`` declares
    (or re-declares, at runtime) a tenant's quota and fair-share
    weight; ``admit(tenant)`` is the queue's admission hook — it
    raises :class:`TenantThrottledError` when the tenant's bucket is
    empty and counts every decision. Tenants never configured pass
    freely with weight 1 (the bitwise-compatible default path).

    ``slo`` (threshold seconds + targets) turns on per-tenant rolling
    compliance/burn: ``note_outcome`` feeds a bounded window per
    tenant, and :meth:`slo_report` publishes per-tenant rows under the
    shared ``sparkdl_slo_*`` gauges with ``slo="tenant:<name>"``.
    """

    def __init__(self, *,
                 latency_threshold_s: "float | None" = None,
                 latency_target: float = 0.95,
                 availability_target: float = 0.999,
                 window_s: float = 300.0,
                 clock: Callable[[], float] = time.monotonic):
        self._lock = threading.Lock()
        self._tenants: "Dict[str, _TenantSpec]" = {}
        self.latency_threshold_s = latency_threshold_s
        self.latency_target = latency_target
        self.availability_target = availability_target
        self.window_s = window_s
        self._clock = clock

    def _spec_locked(self, tenant: str) -> _TenantSpec:
        spec = self._tenants.get(tenant)
        if spec is None:
            spec = self._tenants[tenant] = _TenantSpec(tenant)
        return spec

    def configure(self, tenant: str, *,
                  rate: "float | None" = None,
                  burst: "float | None" = None,
                  weight: "float | None" = None,
                  priority: "int | None" = None) -> None:
        """Declare or update one tenant. ``rate``/``burst`` configure
        the bucket (rate alone defaults burst to max(1, rate));
        ``weight`` is the DRR fair share within its class (>= 1);
        ``priority`` pins a default class for the tenant's submits."""
        with self._lock:
            spec = self._spec_locked(tenant)
            if rate is not None:
                if spec.bucket is None:
                    spec.bucket = TokenBucket(
                        rate, burst if burst is not None
                        else max(1.0, rate), now=self._clock())
                else:
                    spec.bucket.reconfigure(rate, burst)
            elif burst is not None:
                if spec.bucket is None:
                    raise ValueError(
                        f"tenant {tenant!r} has no rate yet: configure "
                        "rate= before (or with) burst=")
                spec.bucket.reconfigure(None, burst)
            if weight is not None:
                if weight < 1:
                    raise ValueError(
                        f"weight must be >= 1, got {weight}")
                spec.weight = float(weight)
            if priority is not None:
                spec.priority = int(priority)

    def weight(self, tenant: str) -> float:
        with self._lock:
            spec = self._tenants.get(tenant)
            return spec.weight if spec is not None else 1.0

    def default_priority(self, tenant: str) -> "int | None":
        with self._lock:
            spec = self._tenants.get(tenant)
            return spec.priority if spec is not None else None

    def admit(self, tenant: str, now: "float | None" = None,
              cost: float = 1.0) -> None:
        """The admission hook: consume one bucket token (``cost`` > 1
        under brownout level 3) or raise :class:`TenantThrottledError`.
        Unconfigured tenants always pass. Counts both outcomes."""
        with self._lock:
            spec = self._spec_locked(tenant)
            if spec.bucket is not None and not spec.bucket.try_acquire(
                    now if now is not None else self._clock(), cost):
                spec.shed += 1
                _M_SHED.inc(tenant=tenant)
                raise TenantThrottledError(tenant)
            spec.admitted += 1
        _M_ADMITTED.inc(tenant=tenant)

    def count_shed(self, tenant: str) -> None:
        """Record a brownout shed against ``tenant`` (the ladder, not
        the bucket, made the call — same counter, same dashboards)."""
        with self._lock:
            self._spec_locked(tenant).shed += 1
        _M_SHED.inc(tenant=tenant)

    def note_outcome(self, tenant: str, latency_s: float, *,
                     ok: bool) -> None:
        """One finished request's outcome: per-tenant latency histogram,
        failure counter, and the rolling SLO window."""
        _M_LATENCY.observe(latency_s, tenant=tenant)
        if not ok:
            _M_FAILED.inc(tenant=tenant)
        now = self._clock()
        with self._lock:
            spec = self._spec_locked(tenant)
            if ok:
                spec.completed += 1
            else:
                spec.failed += 1
            spec.outcomes.append((now, latency_s, ok))
            horizon = now - self.window_s
            while spec.outcomes and spec.outcomes[0][0] <= horizon:
                spec.outcomes.popleft()

    def slo_report(self) -> "Dict[str, dict]":
        """Per-tenant rolling compliance/burn (the same `_dimension`
        arithmetic the engine-level SLOTracker publishes), pushed to
        the shared ``sparkdl_slo_*`` gauges as ``slo="tenant:<name>"``
        rows. Keyed by tenant name."""
        reg = registry()
        objective = reg.gauge(
            "sparkdl_slo_objective",
            "declared objective (target fraction) per SLO dimension",
            labels=("slo", "dimension"))
        compliance_g = reg.gauge(
            "sparkdl_slo_compliance",
            "rolling-window compliance fraction per SLO dimension",
            labels=("slo", "dimension"))
        burn_g = reg.gauge(
            "sparkdl_slo_burn_rate",
            "error-budget burn rate (error rate / budget; 1.0 = "
            "sustainable pace)",
            labels=("slo", "dimension"))
        now = self._clock()
        horizon = now - self.window_s
        out: "Dict[str, dict]" = {}
        with self._lock:
            for name, spec in self._tenants.items():
                window = [o for o in spec.outcomes if o[0] > horizon]
                total = len(window)
                ok_n = sum(1 for _, _, ok in window if ok)
                row: "dict[str, Any]" = {
                    "tenant": name,
                    "admitted": spec.admitted,
                    "shed": spec.shed,
                    "completed": spec.completed,
                    "failed": spec.failed,
                }
                labels = {"slo": f"tenant:{name}"}
                if self.latency_threshold_s is not None:
                    good = sum(
                        1 for _, lat, _ in window
                        if lat <= self.latency_threshold_s)
                    dim = SLOTracker._dimension(
                        good, total, self.latency_target)
                    dim["threshold_s"] = self.latency_threshold_s
                    row["latency"] = dim
                    objective.set(dim["target"], dimension="latency",
                                  **labels)
                    compliance_g.set(
                        dim["compliance"]
                        if dim["compliance"] is not None else 1.0,
                        dimension="latency", **labels)
                    burn_g.set(dim["burn_rate"], dimension="latency",
                               **labels)
                dim = SLOTracker._dimension(
                    ok_n, total, self.availability_target)
                row["availability"] = dim
                objective.set(dim["target"], dimension="availability",
                              **labels)
                compliance_g.set(
                    dim["compliance"]
                    if dim["compliance"] is not None else 1.0,
                    dimension="availability", **labels)
                burn_g.set(dim["burn_rate"], dimension="availability",
                           **labels)
                out[name] = row
        return out

    def snapshot(self) -> "Dict[str, dict]":
        with self._lock:
            return {
                name: {
                    "admitted": s.admitted, "shed": s.shed,
                    "completed": s.completed, "failed": s.failed,
                    "weight": s.weight, "priority": s.priority,
                    "bucket": ({"rate": s.bucket.rate,
                                "burst": s.bucket.burst,
                                "tokens": round(s.bucket.tokens, 3)}
                               if s.bucket is not None else None),
                }
                for name, s in self._tenants.items()
            }


# -- brownout ladder ----------------------------------------------------------

#: Ladder levels, in escalation order. Each level keeps the responses
#: of every level below it active.
LEVEL_NORMAL = 0          #: full service
LEVEL_SHED_BACKGROUND = 1  #: PRIORITY_BACKGROUND submits rejected
LEVEL_DEGRADE = 2          #: spec_k / chain_tokens forced to 1
LEVEL_THROTTLE = 3         #: quota'd tenants charged double per admit
LEVEL_REJECT = 4           #: every new submit rejected

LEVEL_NAMES = ("normal", "shed_background", "degrade_quality",
               "throttle_tenants", "reject")


class OverloadController:
    """Process-wide brownout ladder with AutoScaler-style hysteresis.

    ``evaluate(burn_rate=, queue_frac=)`` is the one verb, called on
    the owning engine's tick cadence. The overload *signal* is true
    when either input crosses its threshold; stepping UP one level
    requires the signal to hold ``hysteresis`` consecutive evaluates,
    stepping DOWN requires it quiet for ``recovery_ticks`` consecutive
    evaluates (recovery is deliberately slower — flapping in and out
    of brownout is worse than either state), and every transition is
    followed by ``cooldown_ticks`` evaluates of no movement — the
    exact discipline the AutoTuner/AutoScaler proved out. Transitions
    land in the flight ring (``overload.level``), the
    ``sparkdl_overload_*`` metrics, and the ``overload`` health fact
    ``/healthz`` aggregates (level > 0 reads degraded).
    """

    def __init__(self, *, burn_threshold: float = 2.0,
                 queue_threshold: float = 0.8,
                 hysteresis: int = 2,
                 recovery_ticks: int = 3,
                 cooldown_ticks: int = 2,
                 max_level: int = LEVEL_REJECT,
                 clock: Callable[[], float] = time.monotonic):
        if hysteresis < 1:
            raise ValueError(f"hysteresis must be >= 1, got {hysteresis}")
        if recovery_ticks < 1:
            raise ValueError(
                f"recovery_ticks must be >= 1, got {recovery_ticks}")
        if cooldown_ticks < 0:
            raise ValueError(
                f"cooldown_ticks must be >= 0, got {cooldown_ticks}")
        if not (LEVEL_NORMAL <= max_level <= LEVEL_REJECT):
            raise ValueError(f"max_level must be 0..4, got {max_level}")
        self.burn_threshold = burn_threshold
        self.queue_threshold = queue_threshold
        self.hysteresis = hysteresis
        self.recovery_ticks = recovery_ticks
        self.cooldown_ticks = cooldown_ticks
        self.max_level = max_level
        self._clock = clock
        self._lock = threading.Lock()
        self._level = LEVEL_NORMAL
        self._hot_streak = 0
        self._quiet_streak = 0
        self._cooldown = 0
        self.transitions = 0
        _M_OVERLOAD_LEVEL.set(0)
        self._publish_fact()

    @property
    def level(self) -> int:
        return self._level

    @property
    def level_name(self) -> str:
        return LEVEL_NAMES[self._level]

    def evaluate(self, *, burn_rate: "float | None" = None,
                 queue_frac: "float | None" = None) -> int:
        """One control tick: fold the signals, maybe move one level.
        Returns the (possibly new) level."""
        hot = ((burn_rate is not None
                and burn_rate >= self.burn_threshold)
               or (queue_frac is not None
                   and queue_frac >= self.queue_threshold))
        with self._lock:
            if hot:
                self._hot_streak += 1
                self._quiet_streak = 0
            else:
                self._quiet_streak += 1
                self._hot_streak = 0
            if self._cooldown > 0:
                self._cooldown -= 1
                return self._level
            if (hot and self._hot_streak >= self.hysteresis
                    and self._level < self.max_level):
                self._step_locked(+1, burn_rate, queue_frac)
            elif (not hot and self._quiet_streak >= self.recovery_ticks
                    and self._level > LEVEL_NORMAL):
                self._step_locked(-1, burn_rate, queue_frac)
            return self._level

    def _step_locked(self, direction: int, burn_rate, queue_frac) -> None:
        self._level += direction
        self._hot_streak = 0
        self._quiet_streak = 0
        self._cooldown = self.cooldown_ticks
        self.transitions += 1
        _M_OVERLOAD_LEVEL.set(self._level)
        _M_OVERLOAD_TRANSITIONS.inc(
            direction="up" if direction > 0 else "down")
        flight.record_event(
            "overload.level", level=self._level,
            name=LEVEL_NAMES[self._level],
            direction="up" if direction > 0 else "down",
            burn_rate=burn_rate, queue_frac=queue_frac)
        self._publish_fact()

    def _publish_fact(self) -> None:
        # the /healthz hook: healthz_report reads this fact and calls
        # any level > 0 "degraded" (self-recovering — the ladder steps
        # back down on its own once the signals quiet)
        flight.set_health_fact("overload", {
            "level": self._level,
            "name": LEVEL_NAMES[self._level],
        })

    def admission_check(self, tenant: str, priority: int) -> None:
        """Admission-time ladder enforcement (called by the queue with
        no queue lock held): level >= 1 sheds the background class,
        level 4 sheds everything. Raises :class:`BrownoutShedError`."""
        lvl = self._level
        if lvl >= LEVEL_REJECT:
            _M_OVERLOAD_SHED.inc(level=lvl)
            raise BrownoutShedError(
                lvl, "brownout level 4 (reject): all new submits shed; "
                "retry with backoff")
        if lvl >= LEVEL_SHED_BACKGROUND and priority >= PRIORITY_BACKGROUND:
            _M_OVERLOAD_SHED.inc(level=lvl)
            raise BrownoutShedError(
                lvl, f"brownout level {lvl}: background-class submits "
                f"shed (tenant {tenant!r})")

    def admit_cost(self) -> float:
        """Bucket tokens one admit costs at the current level: level 3+
        charges quota'd tenants double, halving every configured
        tenant's effective rate/burst while the incident lasts."""
        return 2.0 if self._level >= LEVEL_THROTTLE else 1.0

    def degrade_quality(self) -> bool:
        """True at level >= 2: engines cap ``spec_k``/``chain_tokens``
        to 1 (single-token dispatches — lowest latency variance, no
        wasted verify FLOPs while the host is hot)."""
        return self._level >= LEVEL_DEGRADE

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "level": self._level,
                "name": LEVEL_NAMES[self._level],
                "hot_streak": self._hot_streak,
                "quiet_streak": self._quiet_streak,
                "cooldown": self._cooldown,
                "transitions": self.transitions,
            }


# -- process-wide controller hook ---------------------------------------------

_PROCESS_OVERLOAD: "OverloadController | None" = None
_PROCESS_LOCK = threading.Lock()


def set_process_overload(
        ctrl: "OverloadController | None") -> "OverloadController | None":
    """Install (or clear, with None) the process-wide brownout
    controller every queue and engine consults. Returns the previous
    one so tests can restore it."""
    global _PROCESS_OVERLOAD
    with _PROCESS_LOCK:
        prev, _PROCESS_OVERLOAD = _PROCESS_OVERLOAD, ctrl
    if ctrl is None:
        _M_OVERLOAD_LEVEL.set(0)
        flight.set_health_fact("overload", None)
    return prev


def process_overload() -> "OverloadController | None":
    return _PROCESS_OVERLOAD


def overload_level() -> int:
    """The current process-wide brownout level (0 with no controller
    installed — the default, bitwise-identical path)."""
    ctrl = _PROCESS_OVERLOAD
    return ctrl.level if ctrl is not None else LEVEL_NORMAL


def note_preemption() -> None:
    """Count one prefill preemption (the engine's ``tenant.preempt``
    path calls this after the victim re-queued)."""
    _M_PREEMPTIONS.inc()
