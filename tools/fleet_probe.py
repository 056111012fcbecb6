#!/usr/bin/env python3
"""Some of ``chip_smoke.py``'s serving phases alone, on the card: their
checks and their printed lines after ``[card]`` and ``[build]``, without
the rest of the script.

    python3 tools/fleet_probe.py                            # fabric, disagg
    python3 tools/fleet_probe.py disagg autoscale           # any of PHASES
    python3 tools/fleet_probe.py serve sp_serve --lock-ab 3

``--lock-ab N`` runs the named phases N rounds of two runs each, one
with the continuous engine's FIFO lock and one with a plain
``threading.Lock`` in its place (plain then FIFO, then FIFO then plain,
and so on), prints each run's numbers and each lock's medians, and times
an acquire and release of either lock on one thread.

With two or more visible cards ``[disagg]`` also places the prefill tier
on cuda:0 and the decode tier on cuda:1, and ``[autoscale]`` the fresh
fabric host and one decode worker on cuda:1.
"""

from __future__ import annotations

import argparse
import os
import statistics
import sys
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# chip_smoke's main() pins the same workspace before its phases
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import chip_smoke as cs  # noqa: E402

PHASES = ("serve", "sp_serve", "fabric", "disagg", "autoscale")
LOCK_PAIRS = 200_000  # acquire + release pairs timed a lock


def run_phases(names, card: str) -> dict:
    """Each phase of ``names`` in order; ``[autoscale]`` answers against
    ``[serve]``'s featurizer rows, or computes them when serve is not run."""
    out, served = {}, None
    for name in names:
        if name == "serve":
            served = out[name] = cs.phase_serve(card)
        elif name == "autoscale":
            if served is None:
                rows, want = cs._featurizer_rows()
                served = {"rows": rows, "want": want}
            out[name] = cs.phase_autoscale(card, served)
        else:
            out[name] = getattr(cs, f"phase_{name}")(card)
    return out


def _numbers(out: dict) -> dict:
    """The end-to-end numbers a lock could move, from the phases' results."""
    got = {}
    if "serve" in out:
        s = out["serve"]
        got.update({"serve warm tokens/s": s["tokens_s"], "serve warm TTFT p50 ms": s["ttft_ms"],
                    "ServingEngine requests/s": s["requests_s"],
                    "ServingEngine p99 ms": s["p99_ms"]})
    if "sp_serve" in out:
        for sp, r in out["sp_serve"].items():
            got[f"sp={sp} warm TTFT p50 ms"] = statistics.median(r["ttft"][1]) * 1e3
    return got


def _pair_us(lock) -> float:
    t = time.perf_counter()
    for _ in range(LOCK_PAIRS):
        with lock:
            pass
    return (time.perf_counter() - t) / LOCK_PAIRS * 1e6


def lock_ab(names, card: str, rounds: int) -> None:
    from sparkdl_torch.serving import continuous

    fifo = continuous._FifoLock
    locks = {"plain": threading.Lock, "fifo": fifo}
    print(f"[lock_ab] {card}: acquire + release on one thread, {LOCK_PAIRS} pairs: "
          + ", ".join(f"{k} {_pair_us(make()):.3f} us" for k, make in locks.items()))
    runs = {k: [] for k in locks}
    try:
        for r in range(rounds):
            for k in (("plain", "fifo") if r % 2 == 0 else ("fifo", "plain")):
                continuous._FifoLock = locks[k]
                got = _numbers(run_phases(names, card))
                runs[k].append(got)
                print(f"[lock_ab] round {r + 1} lock={k}: "
                      + ", ".join(f"{n} {v:.1f}" for n, v in got.items()))
    finally:
        continuous._FifoLock = fifo
    for k, rs in runs.items():
        print(f"[lock_ab] lock={k}, median (min..max) of {len(rs)} runs: " + ", ".join(
            f"{n} {statistics.median(r[n] for r in rs):.1f} ({min(r[n] for r in rs):.1f}.."
            f"{max(r[n] for r in rs):.1f})" for n in rs[0]))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("phases", nargs="*", metavar="PHASE",
                    help=f"one of {', '.join(PHASES)}, run in the order given "
                         "(default: fabric disagg)")
    ap.add_argument("--lock-ab", type=int, default=0, metavar="ROUNDS",
                    help="compare the engine's FIFO lock with a plain Lock over "
                         "ROUNDS rounds of the phases")
    args = ap.parse_args()
    args.phases = args.phases or ["fabric", "disagg"]
    if not set(args.phases) <= set(PHASES):
        ap.error(f"phases are {', '.join(PHASES)}, not {args.phases}")
    t = time.perf_counter()
    card = cs.phase_card()
    cs.phase_build()
    if args.lock_ab:
        lock_ab(args.phases, card, args.lock_ab)
    else:
        run_phases(args.phases, card)
    print(f"probe {time.perf_counter() - t:.1f} s")


if __name__ == "__main__":
    main()
