"""CLI: ``python -m sparkdl_torch.lint [paths...]``.

Exit codes: 0 clean, 1 findings, 2 usage/internal error.
"""

from __future__ import annotations

import argparse
import json
import sys

from sparkdl_torch.lint.core import lint_paths
from sparkdl_torch.lint.rules import ALL_RULES, DROPPED_RULES


def main(argv: "list[str] | None" = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m sparkdl_torch.lint",
        description="sparkdl-lint for the port: AST invariant checker "
                    "for concurrency, device syncs and contract drift "
                    "(README: Static analysis (port))",
    )
    parser.add_argument(
        "paths", nargs="*",
        default=["sparkdl_torch", "chip_smoke.py", "tools", "tests"],
        help="files/dirs to lint (.py parsed; other files become aux "
             "texts for the fault-plan scanner). Default: sparkdl_torch "
             "chip_smoke.py tools tests")
    parser.add_argument(
        "--format", choices=("text", "json"), default="text",
        help="stdout format (default text)")
    parser.add_argument(
        "--output", metavar="PATH",
        help="also write the full JSON report here")
    parser.add_argument(
        "--rule", action="append", metavar="NAME",
        help="run only the named rule(s); repeatable")
    parser.add_argument(
        "--root", default=None,
        help="repo root for README/PERF/run-tests.sh discovery and "
             "relative paths (default: cwd)")
    parser.add_argument(
        "--list-rules", action="store_true",
        help="print the rule catalog and exit")
    args = parser.parse_args(argv)

    if args.list_rules:
        for cls in ALL_RULES:
            print(f"{cls.name:22s} {cls.description}")
        for name, why in DROPPED_RULES.items():
            print(f"{name:22s} (dropped) {why}")
        return 0

    rules = None
    if args.rule:
        by_name = {cls.name: cls for cls in ALL_RULES}
        unknown = [r for r in args.rule if r not in by_name]
        if unknown:
            print(f"unknown rule(s): {', '.join(unknown)} "
                  f"(see --list-rules)", file=sys.stderr)
            return 2
        rules = [by_name[r]() for r in args.rule]

    try:
        report = lint_paths(args.paths, rules=rules, root=args.root)
    except OSError as e:
        print(f"sparkdl-lint: {e}", file=sys.stderr)
        return 2

    if args.output:
        with open(args.output, "w", encoding="utf-8") as fh:
            fh.write(report.to_json() + "\n")
    if args.format == "json":
        print(report.to_json())
    else:
        print(report.render_text())
    return report.exit_code


if __name__ == "__main__":
    sys.exit(main())
