"""Bounded retry with exponential backoff, full jitter, and a budget —
a copy of ``sparkdl_tpu.reliability.retry`` (framework-free).

:class:`RetryPolicy` is the one retry loop every layer shares, so the
semantics cannot drift per call site:

* **Bounded attempts** — ``max_attempts`` total tries, never infinite.
* **Exponential backoff, full jitter** — attempt *n* sleeps a uniform
  draw from ``[0, min(max_delay, base * multiplier**(n-1))]``.
* **Retryable vs fatal classification** — ``fatal`` types propagate
  immediately (programming errors must not burn retries); ``retryable``
  types retry; anything else propagates untouched.
* **Per-process retry budget** — a global token pool
  (``SPARKDL_TORCH_RETRY_BUDGET``, default 256) caps total retries per
  process, so a persistent fault degrades to fail-fast instead of an
  unbounded retry storm amplifying the outage.
* **Observable** — each outcome lands in
  ``sparkdl_retries_total{site,outcome}`` (outcome ∈ retried /
  recovered / exhausted / budget / fatal) and the flight ring
  (:func:`record_retry`, which loops of their own — the ReplicaPool's
  re-routes — call too), and every attempt runs under a
  ``retry.attempt`` span.

``sleep`` and ``seed`` are injectable so tests assert the exact backoff
sequence without wall-clock time.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import random
import threading
import time
from typing import Any, Callable

from sparkdl_torch.observability import flight
from sparkdl_torch.observability.registry import registry
from sparkdl_torch.observability.tracing import span

__all__ = [
    "RetryBudget",
    "RetryExhaustedError",
    "RetryPolicy",
    "process_retry_budget",
    "record_retry",
]

_log = logging.getLogger(__name__)

_M_RETRIES = None


def _retries_counter():
    global _M_RETRIES
    if _M_RETRIES is None:
        _M_RETRIES = registry().counter(
            "sparkdl_retries_total",
            "retry outcomes per site (retried/recovered/exhausted/"
            "budget/fatal)",
            labels=("site", "outcome"))
    return _M_RETRIES


def record_retry(site: str, outcome: str) -> None:
    """Record one retry outcome into the spine — shared with callers
    that implement their own recovery loop (ReplicaPool re-routes,
    checkpoint fallback) so every second chance lands in ONE metric.
    Each outcome also lands in the flight ring: a postmortem shows the
    retry storm that preceded the trigger, not just its count."""
    _retries_counter().inc(site=site, outcome=outcome)
    flight.record_event("retry", site=site, outcome=outcome)


class RetryExhaustedError(RuntimeError):
    """All attempts failed (or the budget ran dry); ``__cause__`` holds
    the last underlying error."""


class RetryBudget:
    """Thread-safe token pool bounding total retries.

    Each retry consumes one token; success refunds nothing (the budget
    is a per-process lifetime cap, not a rate). ``reset()`` refills —
    test isolation and long-lived servers that want an epoch budget.
    """

    def __init__(self, tokens: int = 256):
        if tokens < 0:
            raise ValueError(f"tokens must be >= 0, got {tokens}")
        self.initial = tokens
        self._left = tokens
        self._lock = threading.Lock()

    def try_acquire(self) -> bool:
        with self._lock:
            if self._left <= 0:
                return False
            self._left -= 1
            return True

    @property
    def remaining(self) -> int:
        return self._left

    def reset(self, tokens: "int | None" = None) -> None:
        with self._lock:
            if tokens is not None:
                self.initial = tokens
            self._left = self.initial


_PROCESS_BUDGET: "RetryBudget | None" = None
_PROCESS_BUDGET_LOCK = threading.Lock()


def process_retry_budget() -> RetryBudget:
    """The per-process budget every default policy draws from
    (``SPARKDL_TORCH_RETRY_BUDGET`` sets the size, default 256)."""
    global _PROCESS_BUDGET
    with _PROCESS_BUDGET_LOCK:
        if _PROCESS_BUDGET is None:
            _PROCESS_BUDGET = RetryBudget(
                int(os.environ.get("SPARKDL_TORCH_RETRY_BUDGET", "256"))
            )
        return _PROCESS_BUDGET


@dataclasses.dataclass
class RetryPolicy:
    """The shared retry loop: ``policy.call(fn, site=...)``.

    ``retryable``/``fatal`` are exception-type tuples; fatal wins when
    both match (it is checked first), and exceptions matching neither
    propagate untouched — a retry policy must never convert a
    programming error into three programming errors and a sleep.
    """

    max_attempts: int = 3
    base_delay_s: float = 0.1
    max_delay_s: float = 30.0
    multiplier: float = 2.0
    retryable: "tuple[type, ...]" = (Exception,)
    fatal: "tuple[type, ...]" = ()
    #: None = the process-wide budget; pass a RetryBudget to isolate.
    budget: "RetryBudget | None" = None
    #: None = nondeterministic jitter; an int seeds it (tests).
    seed: "int | None" = None
    sleep: Callable[[float], None] = time.sleep

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError(
                f"max_attempts must be >= 1, got {self.max_attempts}"
            )

    def delay_s(self, attempt: int, rng: "random.Random") -> float:
        """Full-jitter backoff before attempt ``attempt + 1``."""
        ceiling = min(
            self.max_delay_s,
            self.base_delay_s * self.multiplier ** (attempt - 1),
        )
        return rng.uniform(0.0, ceiling)

    def call(self, fn: Callable[..., Any], *args: Any,
             site: str = "default", **kwargs: Any) -> Any:
        """Run ``fn(*args, **kwargs)`` under this policy.

        Raises :class:`RetryExhaustedError` (``__cause__`` = last error)
        when attempts or the budget run out; fatal and unclassified
        exceptions propagate as themselves immediately.
        """
        rng = random.Random(self.seed)
        budget = self.budget if self.budget is not None \
            else process_retry_budget()
        for attempt in range(1, self.max_attempts + 1):
            try:
                with span("retry.attempt", site=site, attempt=attempt):
                    out = fn(*args, **kwargs)
            except self.fatal:
                record_retry(site, "fatal")
                raise
            except self.retryable as e:
                if attempt >= self.max_attempts:
                    record_retry(site, "exhausted")
                    raise RetryExhaustedError(
                        f"{site}: all {self.max_attempts} attempts "
                        f"failed; last error: {e!r}"
                    ) from e
                if not budget.try_acquire():
                    record_retry(site, "budget")
                    raise RetryExhaustedError(
                        f"{site}: process retry budget exhausted "
                        f"(SPARKDL_TORCH_RETRY_BUDGET) after attempt "
                        f"{attempt}; last error: {e!r}"
                    ) from e
                record_retry(site, "retried")
                delay = self.delay_s(attempt, rng)
                _log.warning(
                    "%s: attempt %d/%d failed (%r); retrying in %.3fs",
                    site, attempt, self.max_attempts, e, delay,
                )
                if delay > 0:
                    self.sleep(delay)
            else:
                if attempt > 1:
                    record_retry(site, "recovered")
                return out
        raise AssertionError("unreachable")  # pragma: no cover
