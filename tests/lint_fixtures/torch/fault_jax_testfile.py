"""Fixture (linted under a tests/ rel path): a JAX-package test. It
does not import the port, so its plans neither cover nor name the
port's sites."""

from sparkdl_tpu.reliability.faults import inject


def test_plan():
    with inject("fixture.jaxonly:RuntimeError@1"):
        pass
    with inject("fixture.jaxghost@1"):
        pass
