"""Fixture: metric-drift NEGATIVE — one documented family, declared
with one shape at two sites (one through a module constant)."""

from sparkdl_torch.observability.registry import registry

_NAME = "sparkdl_lintfixture_total"

_A = registry().counter(
    "sparkdl_lintfixture_total", "demo", labels=("site",))
_B = registry().counter(_NAME, "demo", labels=("site",))
