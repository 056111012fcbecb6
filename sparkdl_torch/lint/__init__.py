"""sparkdl-lint for the port: AST invariant checks over ``sparkdl_torch``.

The port's serving, reliability and fleet threads rest on conventions no
compiler enforces: lock-guarded mutable state, the ``sparkdl_*`` metric
families, the ``fault_point`` site names, the ``resolve_pin`` env-var
contract, and a device loop that never blocks the host on the card. This
package machine-checks them, with the JAX package's rules carried over
to the port's names (``SPARKDL_TORCH_*``, its fault sites, the torch
calls that wait on the device).

Zero-dependency by construction: stdlib ``ast`` + ``re`` only, so it runs
without importing torch.

Usage::

    python -m sparkdl_torch.lint sparkdl_torch/ chip_smoke.py tools/ tests/
    python -m sparkdl_torch.lint --format json sparkdl_torch/
    python -m sparkdl_torch.lint --list-rules

Exit codes: 0 = clean, 1 = findings, 2 = usage/internal error.

Suppressions are line-scoped comments with REQUIRED justification text::

    x = 1  # sparkdl-lint: disable=lock-discipline -- published before start()

(on the flagged line, or alone on the line above it). A suppression
without ``-- <why>`` is itself a finding. See README "Static analysis
(port)".
"""

from sparkdl_torch.lint.core import (
    Finding,
    LintReport,
    Project,
    Rule,
    SourceFile,
    lint_paths,
)
from sparkdl_torch.lint.rules import ALL_RULES

__all__ = [
    "ALL_RULES",
    "Finding",
    "LintReport",
    "Project",
    "Rule",
    "SourceFile",
    "lint_paths",
]
