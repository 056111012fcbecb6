"""Fixture: fault-coverage NEGATIVE — sites covered by the plans in
fault_plans_testfile.py (a literal plan and a parametrized one)."""

from sparkdl_torch.reliability.faults import fault_point


def hot_path(rank):
    fault_point("fixture.covered")
    fault_point("fixture.param")
    fault_point(f"fixture.rank.{rank}")
