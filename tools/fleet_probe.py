#!/usr/bin/env python3
"""``chip_smoke.py``'s ``[card]``, ``[fabric]`` and ``[disagg]`` phases
alone, on the card: their checks and their printed lines, without the
rest of the script.

    python3 tools/fleet_probe.py                  # all three
    python3 tools/fleet_probe.py --skip-fabric    # [card] and [disagg]

With two or more visible cards ``[disagg]`` also places the prefill
tier on cuda:0 and the decode tier on cuda:1.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# chip_smoke's main() pins the same workspace before its phases
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import chip_smoke as cs  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--skip-fabric", action="store_true",
                    help="run [card] and [disagg] only")
    args = ap.parse_args()
    t = time.perf_counter()
    card = cs.phase_card()
    if not args.skip_fabric:
        cs.phase_fabric(card)
    cs.phase_disagg(card)
    print(f"probe {time.perf_counter() - t:.1f} s")


if __name__ == "__main__":
    main()
