"""Fixture: fault-coverage POSITIVE — an unexercised production site,
and a catalogued site no code raises."""

from sparkdl_torch.reliability.faults import fault_point


def hot_path():
    fault_point("fixture.orphan")  # no port test plan names this site
    fault_point("fixture.jaxonly")  # only a JAX-package test names it
