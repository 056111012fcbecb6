"""The per-process retry budget (the part of the reference's retry module
that the flight recorder's health report reads).

A global token pool (``SPARKDL_TORCH_RETRY_BUDGET``, default 256) caps
total retries per process, so a persistent fault degrades to fail-fast
instead of an unbounded retry storm. The reference's shared retry loop
(``RetryPolicy``) has no caller in the port yet.
"""

from __future__ import annotations

import os
import threading

__all__ = ["RetryBudget", "process_retry_budget"]


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
    """The per-process budget every retry draws from
    (``SPARKDL_TORCH_RETRY_BUDGET`` sets the size, default 256)."""
    global _PROCESS_BUDGET
    with _PROCESS_BUDGET_LOCK:
        if _PROCESS_BUDGET is None:
            _PROCESS_BUDGET = RetryBudget(
                int(os.environ.get("SPARKDL_TORCH_RETRY_BUDGET", "256"))
            )
        return _PROCESS_BUDGET
