"""Online autotuner: closes the control loop from the observability spine.

The tf.data AUTOTUNE idea (Murray et al., arXiv 2101.12127) applied to
this runtime's ingest knobs: the registry already measures the two sides
of every producer/consumer hand-off —

* **starvation** — consumer time blocked waiting on the feed
  (``sparkdl_prefetch_consumer_wait_seconds`` and the ring twin
  ``sparkdl_ring_consumer_wait_seconds``): the producer side is the
  bottleneck, so producer-side knobs (prefetch depth, map parallelism,
  ring slots, pack threads) should GROW;
* **producer blocking** — producer time blocked on a full buffer
  (``sparkdl_prefetch_producer_blocked_seconds_total`` and
  ``sparkdl_ring_slot_wait_seconds_total``): the consumer side is the
  bottleneck, so producer-side knobs shrink back (freeing memory) while
  consumer-side knobs (the dispatch chain K — marked ``inverted``) grow
  to amortize per-dispatch overhead.

The loop is a bounded hill-climb with hysteresis: a direction must hold
for ``hysteresis`` consecutive samples before any knob moves, every move
is one power-of-two step clamped to ``[lo, hi]``, and a post-move
``cooldown`` lets the change take effect before the next decision — so
the tuner cannot oscillate on a noisy signal. Explicitly configured
knobs (``prefetch=``, ``SPARKDL_TORCH_CHAIN_K``, ...) register as *pinned*
and are never moved.

Every decision is observable: ``sparkdl_autotune_decisions_total
{knob,direction}``, the current value gauge ``sparkdl_autotune_knob
{knob}``, ``sparkdl_autotune_ticks_total``, and an ``autotune.decision``
span per applied move — the same spine the tuner reads from records what
it did, so a bench artifact carries the full decision history.

Determinism for tests: the sample clock and the signal reader are both
injectable, and ``tick()`` may be driven manually instead of via the
cadence thread (:meth:`AutoTuner.start`).
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
from typing import Callable, Iterable

from sparkdl_torch.observability import flight, tracing
from sparkdl_torch.observability.registry import registry

__all__ = [
    "AutoTuner",
    "Knob",
    "autotune_enabled",
    "default_tuner",
    "read_feed_signals",
]

_METRICS = None


def _metrics():
    global _METRICS
    if _METRICS is None:
        _METRICS = (
            registry().counter(
                "sparkdl_autotune_decisions_total",
                "autotuner knob moves applied",
                labels=("knob", "direction")),
            registry().gauge(
                "sparkdl_autotune_knob",
                "current value of each autotuned knob",
                labels=("knob",)),
            registry().counter(
                "sparkdl_autotune_ticks_total",
                "autotuner control-loop samples taken"),
        )
    return _METRICS


@dataclasses.dataclass
class Knob:
    """One tunable integer setting.

    ``get``/``set`` close over the live object (a prefetch iterator's
    depth, a chainer's K, a module-level suggestion). ``inverted`` marks
    consumer-side knobs that move OPPOSITE the producer-side direction:
    when the feed starves the consumer, producer knobs grow while an
    inverted knob (dispatch chain K) shrinks toward its floor, and vice
    versa. ``pinned`` knobs are registered for visibility (the gauge
    still exports their value) but never moved; ``pin_source`` records
    why (the argument or env var that pinned it) for fail-loud conflict
    messages.
    """

    name: str
    get: Callable[[], int]
    set: Callable[[int], None]
    lo: int
    hi: int
    pinned: bool = False
    pin_source: "str | None" = None
    inverted: bool = False

    def __post_init__(self):
        if self.lo < 1 or self.hi < self.lo:
            raise ValueError(
                f"knob {self.name}: need 1 <= lo <= hi, got "
                f"[{self.lo}, {self.hi}]"
            )


def _pow2_step(cur: int, direction: int, lo: int, hi: int) -> int:
    """One bounded multiplicative step: double up / halve down, clamped.
    Powers-of-two moves keep jit-cache churn bounded for shape-keyed
    knobs (chain K) and converge in log2(hi/lo) decisions for the rest."""
    if direction > 0:
        return min(hi, max(cur + 1, cur * 2))
    return max(lo, cur // 2)


#: cumulative feed signals: (consumer-starved seconds, producer-blocked
#: seconds, items delivered) summed over the python-prefetch and
#: native-ring paths. The items counter gives the tuner an OBJECTIVE:
#: a move that shrinks delivered throughput gets reverted, whatever the
#: bottleneck shares said.
def read_feed_signals() -> "tuple[float, float, float]":
    """Read the cumulative starvation / producer-blocked seconds and the
    delivered-item count from the registry — the exact series
    ``/metrics`` exposes, no tuner-local bookkeeping."""
    snap_starve = 0.0
    snap_blocked = 0.0
    snap_items = 0.0
    reg = registry()
    for name in ("sparkdl_prefetch_consumer_wait_seconds",
                 "sparkdl_ring_consumer_wait_seconds"):
        fam = reg.get(name)
        if fam is None:
            continue
        for v in fam.snapshot_values().values():
            if isinstance(v, dict):
                snap_starve += float(v.get("sum") or 0.0)
    for name in ("sparkdl_prefetch_producer_blocked_seconds_total",
                 "sparkdl_ring_slot_wait_seconds_total"):
        fam = reg.get(name)
        if fam is None:
            continue
        for v in fam.snapshot_values().values():
            if isinstance(v, (int, float)):
                snap_blocked += float(v)
    for name in ("sparkdl_prefetch_batches_total",
                 "sparkdl_ring_batches_total"):
        fam = reg.get(name)
        if fam is None:
            continue
        for v in fam.snapshot_values().values():
            if isinstance(v, (int, float)):
                snap_items += float(v)
    return snap_starve, snap_blocked, snap_items


class AutoTuner:
    """Samples the feed signals at a fixed cadence and hill-climbs the
    registered knobs. See the module docstring for the control law.

    Thresholds: a sample's *starvation share* (starved seconds / elapsed
    wall) above ``starve_hi`` votes to grow the producer side; a
    *blocked share* above ``blocked_hi`` with starvation below
    ``starve_lo`` votes to shrink it. Anything else is a neutral sample
    and resets the streak — only ``hysteresis`` consecutive same-
    direction votes move knobs, and after a move ``cooldown_ticks``
    samples are skipped so the change's effect is what the next vote
    sees.

    Objective feedback: when the signal reader supplies a delivered-item
    counter, the first sample after a move's cooldown compares delivered
    throughput against the pre-move rate — a drop beyond
    ``revert_tolerance`` reverts the move and puts that direction on a
    ``tabu_ticks`` blocklist, so a move that the bottleneck shares
    suggested but the throughput refutes (e.g. chaining dispatches on a
    backend with a negligible dispatch gap) is undone once and not
    retried every few samples.
    """

    def __init__(
        self,
        *,
        interval_s: float = 0.25,
        hysteresis: int = 2,
        cooldown_ticks: int = 2,
        starve_hi: float = 0.10,
        starve_lo: float = 0.02,
        blocked_hi: float = 0.10,
        revert_tolerance: float = 0.2,
        tabu_ticks: int = 50,
        clock: Callable[[], float] = time.monotonic,
        signals: "Callable[[], tuple] | None" = None,
    ):
        if hysteresis < 1:
            raise ValueError(f"hysteresis must be >= 1, got {hysteresis}")
        self.interval_s = interval_s
        self.hysteresis = hysteresis
        self.cooldown_ticks = cooldown_ticks
        self.starve_hi = starve_hi
        self.starve_lo = starve_lo
        self.blocked_hi = blocked_hi
        self.revert_tolerance = revert_tolerance
        self.tabu_ticks = tabu_ticks
        self._clock = clock
        self._signals = signals if signals is not None else read_feed_signals
        self._lock = threading.Lock()
        self._knobs: "dict[str, Knob]" = {}
        #: (now, starve, blocked, items|None) of the previous sample
        self._last_sample: "tuple | None" = None
        self._streak_dir = 0
        self._streak = 0
        self._cooldown = 0
        #: (direction, {knob: pre-move value}, pre-move rate) awaiting
        #: its post-cooldown throughput verdict
        self._pending_eval: "tuple | None" = None
        #: direction -> ticks it stays blocked after a revert
        self._tabu: "dict[int, int]" = {}
        self.decision_count = 0
        self._thread: "threading.Thread | None" = None
        self._stop = threading.Event()

    # -- knob registry -------------------------------------------------------
    def register(self, knob: Knob) -> Knob:
        """Add (or replace) a knob; exports its current value on the
        ``sparkdl_autotune_knob`` gauge immediately, pinned or not."""
        with self._lock:
            self._knobs[knob.name] = knob
        _metrics()[1].set(float(knob.get()), knob=knob.name)
        return knob

    def register_all(self, knobs: Iterable[Knob]) -> "list[Knob]":
        return [self.register(k) for k in knobs]

    def unregister(self, name: str, knob: "Knob | None" = None) -> None:
        """Remove a knob by name. Pass the :class:`Knob` object to make
        the removal identity-checked: if another stream re-registered
        the same name in the meantime, ITS live knob is left in place
        (a closing pipeline must never deregister a successor's)."""
        with self._lock:
            if knob is not None and self._knobs.get(name) is not knob:
                return
            self._knobs.pop(name, None)

    @property
    def knobs(self) -> "dict[str, Knob]":
        with self._lock:
            return dict(self._knobs)

    # -- the control loop ----------------------------------------------------
    def tick(self) -> int:
        """Take one sample and maybe move knobs; returns the number of
        knob moves applied this tick (reverts included)."""
        now = self._clock()
        sig = self._signals()
        starve, blocked = float(sig[0]), float(sig[1])
        items = float(sig[2]) if len(sig) > 2 else None
        _metrics()[2].inc()
        last = self._last_sample
        self._last_sample = (now, starve, blocked, items)
        for d in list(self._tabu):
            self._tabu[d] -= 1
            if self._tabu[d] <= 0:
                del self._tabu[d]
        if last is None:
            return 0
        dt = now - last[0]
        if dt <= 0:
            return 0
        starve_share = max(0.0, starve - last[1]) / dt
        blocked_share = max(0.0, blocked - last[2]) / dt
        rate = (max(0.0, items - last[3]) / dt
                if items is not None and last[3] is not None else None)

        if self._cooldown > 0:
            # a fresh move is still taking effect; don't let the
            # transient it causes count toward the next decision
            self._cooldown -= 1
            self._streak = 0
            self._streak_dir = 0
            return 0
        if self._pending_eval is not None:
            # the throughput verdict on the last move: a drop beyond
            # tolerance means the bottleneck shares pointed the wrong
            # way for THIS workload — undo it and stop retrying
            d, before, rate0 = self._pending_eval
            self._pending_eval = None
            if (rate is not None and rate0 is not None and rate0 > 0
                    and rate < (1.0 - self.revert_tolerance) * rate0):
                return self._revert(d, before)

        if starve_share >= self.starve_hi and starve_share >= blocked_share:
            direction = 1  # feed starved: grow the producer side
        elif blocked_share >= self.blocked_hi and starve_share < self.starve_lo:
            direction = -1  # consumer-bound: shrink back
        else:
            direction = 0

        if direction == 0 or direction in self._tabu:
            self._streak_dir = 0
            self._streak = 0
            return 0
        if direction != self._streak_dir:
            self._streak_dir = direction
            self._streak = 1
        else:
            self._streak += 1
        if self._streak < self.hysteresis:
            return 0
        # decision: move every unpinned knob one bounded step
        moved = self._apply(direction, rate)
        self._streak = 0
        self._streak_dir = 0
        if moved:
            self._cooldown = self.cooldown_ticks
        return moved

    def _apply(self, direction: int, rate: "float | None") -> int:
        decisions_m, gauge_m, _ = _metrics()
        moved = 0
        before: "dict[str, int]" = {}
        t0 = time.monotonic()
        for knob in self.knobs.values():
            if knob.pinned:
                continue
            d = -direction if knob.inverted else direction
            cur = int(knob.get())
            want = _pow2_step(cur, d, knob.lo, knob.hi)
            if want == cur:
                continue
            knob.set(want)
            new = int(knob.get())  # a knob may clamp (policy ceilings):
            if new == cur:         # only a REAL change is a decision
                continue
            before[knob.name] = cur
            moved += 1
            self.decision_count += 1
            direction_s = "grow" if new > cur else "shrink"
            decisions_m.inc(knob=knob.name, direction=direction_s)
            gauge_m.set(float(new), knob=knob.name)
            # the decision HISTORY is what postmortems need (tf.data's
            # AUTOTUNE lesson): the knob value alone hides the causality
            flight.record_event(
                "autotune.decision", knob=knob.name,
                direction=direction_s, value=new, previous=cur,
            )
        if moved:
            self._pending_eval = (direction, before, rate)
            tracing.record_span(
                "autotune.decision", t0, time.monotonic(),
                direction="grow" if direction > 0 else "shrink",
                knobs_moved=moved,
            )
        return moved

    def _revert(self, direction: int, before: "dict[str, int]") -> int:
        decisions_m, gauge_m, _ = _metrics()
        knobs = self.knobs
        moved = 0
        t0 = time.monotonic()
        for name, old in before.items():
            knob = knobs.get(name)
            if knob is None:
                continue
            knob.set(old)
            moved += 1
            self.decision_count += 1
            decisions_m.inc(knob=name, direction="revert")
            gauge_m.set(float(int(knob.get())), knob=name)
            flight.record_event(
                "autotune.decision", knob=name, direction="revert",
                value=old,
            )
        self._tabu[direction] = self.tabu_ticks
        self._cooldown = self.cooldown_ticks
        if moved:
            tracing.record_span(
                "autotune.decision", t0, time.monotonic(),
                direction="revert", knobs_moved=moved,
            )
        return moved

    # -- cadence thread ------------------------------------------------------
    def start(self) -> "AutoTuner":
        """Run :meth:`tick` every ``interval_s`` on a daemon thread.
        Idempotent; :meth:`stop` joins the thread."""
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return self
            # each cadence thread owns a FRESH stop event (captured by
            # argument, never re-read): a start() racing a stop() can
            # therefore never resurrect the old thread — the old event
            # stays set and that thread exits at its next wake, while
            # the new thread waits on the new event (sparkdl-lint
            # lock-discipline follow-up: re-using one cleared event
            # here used to leave TWO live tick loops)
            stop = self._stop = threading.Event()
            self._thread = threading.Thread(
                target=self._loop, args=(stop,),
                name="sparkdl-autotune", daemon=True,
            )
            self._thread.start()
        return self

    def _loop(self, stop: threading.Event) -> None:
        import logging

        log = logging.getLogger(__name__)
        errors_m = registry().counter(
            "sparkdl_autotune_tick_errors_total",
            "autotuner samples that raised (knob raced its stream "
            "closing, or a broken signal reader)")
        logged = False
        while not stop.wait(self.interval_s):
            try:
                self.tick()
            except Exception:
                # usually a knob's set() racing its stream closing —
                # survivable — but a PERSISTENTLY failing reader would
                # otherwise be indistinguishable from 'correctly idle':
                # count every failure, log the first with traceback
                errors_m.inc()
                if not logged:
                    logged = True
                    log.warning("autotuner tick failed (continuing; "
                                "counted in sparkdl_autotune_tick_"
                                "errors_total)", exc_info=True)
                continue

    def stop(self) -> None:
        # the stop signal AND the thread-handle claim happen under the
        # same lock start() uses (sparkdl-lint lock-discipline): a stop
        # racing a start can no longer clobber the fresh handle with
        # None, and since every thread owns its event (start swaps in a
        # fresh one under this lock), setting the current event can
        # only ever stop the current thread. The join stays OUTSIDE the
        # lock — tick() takes it, so joining while holding it would
        # deadlock.
        with self._lock:
            self._stop.set()
            t = self._thread
            self._thread = None
        if t is not None and t.is_alive():
            t.join(timeout=2.0)

    def __enter__(self) -> "AutoTuner":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


_DEFAULT_TUNER: "AutoTuner | None" = None
_DEFAULT_LOCK = threading.Lock()


def default_tuner() -> AutoTuner:
    """The process-wide tuner instance (not started until a consumer
    with autotuning enabled starts it)."""
    global _DEFAULT_TUNER
    with _DEFAULT_LOCK:
        if _DEFAULT_TUNER is None:
            _DEFAULT_TUNER = AutoTuner()
        return _DEFAULT_TUNER


def autotune_telemetry() -> dict:
    """Decision count + steady-state knob values, straight off the
    registry (the same series ``/metrics`` scrapes) — the
    ``"autotune"`` field the benches embed in their JSON line. The knob
    gauge keeps its last value after streams close, so this reads the
    steady state a run converged to."""
    reg = registry()
    dec_fam = reg.get("sparkdl_autotune_decisions_total")
    decisions = (sum(dec_fam.labelled_values("knob").values())
                 if dec_fam else 0)
    knob_fam = reg.get("sparkdl_autotune_knob")
    knobs = ({k: int(v) for k, v in
              knob_fam.labelled_values("knob").items()}
             if knob_fam else {})
    return {"decisions": int(decisions), "knobs": knobs}


def autotune_enabled(flag: "bool | None" = None) -> bool:
    """Resolve a consumer's ``autotune`` setting: an explicit bool wins;
    None defers to ``SPARKDL_TORCH_AUTOTUNE`` (default off — a background
    control thread must be asked for)."""
    if flag is not None:
        return flag
    return os.environ.get("SPARKDL_TORCH_AUTOTUNE", "").lower() in (
        "1", "true", "yes", "on")
