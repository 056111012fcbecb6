"""Fixture: metric-drift POSITIVE — one family, two shapes; plus an
undocumented family."""

from sparkdl_torch.observability.registry import registry

_A = registry().counter(
    "sparkdl_lintfixture_total", "demo", labels=("site",))
_B = registry().counter(
    "sparkdl_lintfixture_total", "demo", labels=("site", "outcome"))

_C = registry().gauge("sparkdl_lintfixture_undocumented", "demo")
