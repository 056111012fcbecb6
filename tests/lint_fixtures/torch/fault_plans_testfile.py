"""Fixture (linted under a tests/ rel path, so classified as a test
file; it imports the port, so it is one of the port's tests): plans
exercising real sites and naming one ghost site."""

import pytest

from sparkdl_torch.reliability.faults import FaultPlan, arm, inject


def test_plan():
    with inject("fixture.covered:RuntimeError@1"):
        pass
    with inject("fixture.ghost@2"):  # names a site that does not exist
        pass


@pytest.mark.parametrize("plan", ["seed=3;fixture.param:OSError%0.5"])
def test_parametrized_plan(plan):
    arm(FaultPlan.parse(plan))


def test_rank_prefix():
    arm(FaultPlan.parse("fixture.rank.0@1"))
