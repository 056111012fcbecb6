"""Fixture: a reliability/faults.py catalogue (linted under that rel
path): one site no code raises."""

KNOWN_SITES = (
    "fixture.covered",
    "fixture.param",
    "fixture.rank",
    "fixture.orphan",
    "fixture.jaxonly",
    "fixture.catalogued_only",
)
