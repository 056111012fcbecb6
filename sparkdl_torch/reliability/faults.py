"""Deterministic fault injection: armed sites that raise on demand.

Every robustness mechanism in this framework — retry, checkpoint
fallback, replica probation, the resumable-finetune supervisor — exists
to survive failures that are by nature rare and unrepeatable. This
module makes them repeatable: a :class:`FaultPlan` arms named *sites*
(``dispatch``, ``fetch``, ``replica.execute``, ``checkpoint.save``,
``worker.rank``) to raise a chosen exception on the Nth hit of the site
or with a seeded probability, and each production hot path carries a
:func:`fault_point` call that consults the armed plan.

Contracts:

* **Zero cost disarmed.** With no plan armed, :func:`fault_point` is a
  module-global load, an ``is None`` test, and a return — measured
  ~60 ns on the CPU harness (PERF.md), invisible next to a device
  dispatch. CI bench-guards this (run-tests.sh).
* **Deterministic.** ``@N`` rules count hits process-wide per site under
  a lock; ``%p`` rules draw from one seeded ``random.Random``. The same
  plan against the same execution order injects the same faults — the
  chaos soak and the recovery-parity tests depend on it.
* **Observable.** Every injected fault lands in the metrics spine as
  ``sparkdl_faults_injected_total{site=...}``.

Plan syntax (``SPARKDL_TORCH_FAULT_PLAN`` or :meth:`FaultPlan.parse`) —
``;``-separated entries::

    seed=42                      # plan seed for %p rules
    dispatch@3                   # RuntimeError on the 3rd hit of site
    dispatch:OSError@3           # a chosen exception type (builtins)
    replica.execute:OSError@5*4  # hits 5,6,7,8 (4 injections from 5)
    checkpoint.save@2*           # every hit from the 2nd on
    fetch:TimeoutError%0.05      # each hit fails with probability 0.05

Subprocess workers inherit the plan through the environment: the module
parses ``SPARKDL_TORCH_FAULT_PLAN`` once at import, so a
``LocalProcessBackend`` child (``worker.rank`` site) arms itself with no
plumbing. In-process tests use :func:`inject`/:func:`arm` instead —
changing the env var after import deliberately has no effect.
"""

from __future__ import annotations

import builtins
import contextlib
import dataclasses
import os
import random
import threading
from typing import Iterator

from sparkdl_torch.observability import flight
from sparkdl_torch.observability.registry import registry

__all__ = [
    "ENV_VAR",
    "FaultPlan",
    "FaultRule",
    "active_plan",
    "arm",
    "disarm",
    "fault_point",
    "inject",
]

ENV_VAR = "SPARKDL_TORCH_FAULT_PLAN"

#: The sites production code arms today (informational — plans may name
#: new sites freely; a rule for a site nothing hits simply never fires).
KNOWN_SITES = (
    "dispatch",
    "fetch",
    "replica.execute",
    "checkpoint.save",
    "kv.alloc",
    "kv.quantize",
    "kv_pool.resize",
    "autoscale.decide",
    "replica.scale_down",
    "spec.verify",
    "sp.permute",
    "sp.gather",
    "router.route",
    "host.submit",
    "host.drain",
    "handoff.export",
    "handoff.install",
    "worker.rank",
    "kv.park",
    "kv.unpark",
    "digest.delta",
    "kv.migrate",
    "tenant.preempt",
)

_M_INJECTED = None


def _injected_counter():
    global _M_INJECTED
    if _M_INJECTED is None:
        _M_INJECTED = registry().counter(
            "sparkdl_faults_injected_total",
            "faults raised by the injection harness", labels=("site",))
    return _M_INJECTED


def _resolve_exception(name: str) -> type:
    exc = getattr(builtins, name, None)
    if isinstance(exc, type) and issubclass(exc, BaseException):
        return exc
    raise ValueError(
        f"unknown exception type {name!r} in fault plan (must be a "
        "builtin exception name, e.g. RuntimeError, OSError, TimeoutError)"
    )


@dataclasses.dataclass
class FaultRule:
    """One armed site: raise ``exc_type`` per the trigger below.

    ``on_hit``/``times`` is the deterministic trigger — inject on hits
    ``on_hit .. on_hit+times-1`` (``times=None`` = every hit from
    ``on_hit`` on). ``p`` is the probabilistic trigger (seeded by the
    plan). Exactly one of the two is active.
    """

    site: str
    exc_type: type = RuntimeError
    on_hit: "int | None" = None
    times: "int | None" = 1
    p: "float | None" = None
    message: str = ""
    injected: int = 0  # injections so far (plan-lock protected)

    def __post_init__(self):
        if (self.on_hit is None) == (self.p is None):
            raise ValueError(
                f"rule for {self.site!r}: exactly one of on_hit (@N) or "
                f"p (%p) must be set"
            )
        if self.on_hit is not None and self.on_hit < 1:
            raise ValueError(f"on_hit is 1-based, got {self.on_hit}")
        if self.times is not None and self.times < 1:
            raise ValueError(f"times must be >= 1 or None, got {self.times}")
        if self.p is not None and not (0.0 < self.p <= 1.0):
            raise ValueError(f"p must be in (0, 1], got {self.p}")

    def _should_fire(self, hit: int, rng: random.Random) -> bool:
        if self.on_hit is not None:
            if hit < self.on_hit:
                return False
            return self.times is None or self.injected < self.times
        return rng.random() < self.p

    def _make(self, hit: int) -> BaseException:
        detail = f": {self.message}" if self.message else ""
        return self.exc_type(
            f"injected fault at site {self.site!r} (hit {hit}){detail}"
        )

    @classmethod
    def parse(cls, entry: str) -> "FaultRule":
        """Parse one plan entry: ``site[:Exc][@N[*M|*]][%p]``."""
        text = entry.strip()
        p = None
        on_hit, times = None, 1
        if "%" in text:
            text, _, p_s = text.partition("%")
            try:
                p = float(p_s)
            except ValueError:
                raise ValueError(f"bad probability in fault rule {entry!r}")
        if "@" in text:
            text, _, hit_s = text.partition("@")
            if "*" in hit_s:
                hit_s, _, times_s = hit_s.partition("*")
                times = int(times_s) if times_s else None  # "@N*" = forever
            try:
                on_hit = int(hit_s)
            except ValueError:
                raise ValueError(f"bad hit number in fault rule {entry!r}")
        exc_type = RuntimeError
        if ":" in text:
            text, _, exc_name = text.partition(":")
            exc_type = _resolve_exception(exc_name.strip())
        site = text.strip()
        if not site:
            raise ValueError(f"fault rule {entry!r} names no site")
        if on_hit is None and p is None:
            on_hit = 1  # bare "site" / "site:Exc": first hit
        return cls(site=site, exc_type=exc_type, on_hit=on_hit,
                   times=times, p=p)


class FaultPlan:
    """A set of :class:`FaultRule` plus per-site hit counters.

    Build in code (``FaultPlan([FaultRule("dispatch", on_hit=3)])`` or
    ``FaultPlan.parse("dispatch@3")``) and activate with :func:`arm` /
    :func:`inject`. Thread-safe: sites are hit from serving worker
    threads and the training loop alike.
    """

    def __init__(self, rules: "list[FaultRule] | None" = None, *,
                 seed: int = 0):
        self.seed = seed
        self.rules: "list[FaultRule]" = list(rules or ())
        self._by_site: "dict[str, list[FaultRule]]" = {}
        for r in self.rules:
            self._by_site.setdefault(r.site, []).append(r)
        self._rng = random.Random(seed)
        self._hits: "dict[str, int]" = {}
        self._lock = threading.Lock()

    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        """Parse a full ``;``-separated plan string (see module doc)."""
        rules: "list[FaultRule]" = []
        seed = 0
        for entry in spec.split(";"):
            entry = entry.strip()
            if not entry:
                continue
            if entry.startswith("seed="):
                seed = int(entry[len("seed="):])
                continue
            rules.append(FaultRule.parse(entry))
        if not rules:
            raise ValueError(f"fault plan {spec!r} contains no rules")
        return cls(rules, seed=seed)

    @classmethod
    def from_env(cls) -> "FaultPlan | None":
        spec = os.environ.get(ENV_VAR, "").strip()
        return cls.parse(spec) if spec else None

    def hit(self, site: str) -> None:
        """Count one hit of ``site``; raise if an armed rule fires."""
        rules = self._by_site.get(site)
        if rules is None:
            return
        with self._lock:
            n = self._hits[site] = self._hits.get(site, 0) + 1
            fire = None
            for rule in rules:
                if rule._should_fire(n, self._rng):
                    rule.injected += 1
                    fire = rule
                    break
        if fire is not None:
            _injected_counter().inc(site=site)
            # flight ring first: a postmortem triggered by the
            # failure this injection causes must contain its cause
            flight.record_event(
                "fault.injected", site=site, hit=n,
                error=fire.exc_type.__name__,
            )
            raise fire._make(n)

    def snapshot(self) -> dict:
        """Hit/injection counts per site (test/debug introspection)."""
        with self._lock:
            return {
                "hits": dict(self._hits),
                "injected": {
                    r.site: sum(
                        x.injected for x in self._by_site[r.site]
                    )
                    for r in self.rules
                },
            }


#: The armed plan. One module-global so the disarmed fault_point path is
#: a load + None-test; parsed from the environment once at import so
#: subprocess ranks inherit the parent's plan with no plumbing.
_ACTIVE: "FaultPlan | None" = FaultPlan.from_env()


def fault_point(site: str) -> None:
    """Hit the named fault site — raises iff an armed rule fires.

    This sits on every production hot path; keep the disarmed cost at
    one global load (bench-guarded in run-tests.sh and PERF.md).
    """
    plan = _ACTIVE
    if plan is not None:
        plan.hit(site)


def active_plan() -> "FaultPlan | None":
    return _ACTIVE


def arm(plan: "FaultPlan | str") -> FaultPlan:
    """Activate ``plan`` (a :class:`FaultPlan` or a plan string)."""
    global _ACTIVE
    if isinstance(plan, str):
        plan = FaultPlan.parse(plan)
    _ACTIVE = plan
    return plan


def disarm() -> None:
    global _ACTIVE
    _ACTIVE = None


@contextlib.contextmanager
def inject(plan: "FaultPlan | str") -> Iterator[FaultPlan]:
    """Arm ``plan`` for the body, restoring the previous plan after —
    the test/chaos-harness form (exception-safe)."""
    global _ACTIVE
    prev = _ACTIVE
    armed = arm(plan)
    try:
        yield armed
    finally:
        _ACTIVE = prev
