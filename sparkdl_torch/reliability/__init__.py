"""Reliability pieces of the port, copied from ``sparkdl_tpu.reliability``
(all framework-free): named fault-injection sites (``faults.py``,
``fault_point``), the shared retry loop with its per-process budget
(``retry.py``) and the quarantine/probation circuit breaker the
ReplicaPool runs (``breaker.py``). The reference's ``resumable_finetune``
supervisor is not ported yet (ROADMAP A5).
"""

from sparkdl_torch.reliability.breaker import ProbationBreaker
from sparkdl_torch.reliability.faults import (
    FaultPlan,
    FaultRule,
    active_plan,
    arm,
    disarm,
    fault_point,
    inject,
)
from sparkdl_torch.reliability.retry import (
    RetryBudget,
    RetryExhaustedError,
    RetryPolicy,
    process_retry_budget,
    record_retry,
)

__all__ = [
    "FaultPlan",
    "FaultRule",
    "ProbationBreaker",
    "RetryBudget",
    "RetryExhaustedError",
    "RetryPolicy",
    "active_plan",
    "arm",
    "disarm",
    "fault_point",
    "inject",
    "process_retry_budget",
    "record_retry",
]
