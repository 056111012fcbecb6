"""The harness: one run of one cell, found by name.

``BENCHMARK.json`` names the cells, configurations and metrics; each cell
is ``benchmark/workloads/<cell>.json`` (its configuration, mode, traffic,
chips and the limits of its correctness checks), each configuration
``benchmark/configs/<config>.json``, each mode (the driver of one kind of
window) ``benchmark/modes/<mode>.py`` and each per-layer metric a reader
``benchmark/metrics/<metric>.py``. A mode's ``run(run, *, device="cuda")``
returns an :class:`Outcome` (``device="cpu"`` is for the harness's own
tests, as is the featurize mode's ``inline=True``, every task inside this
process); the harness turns it into the result line. Nothing here knows a
cell by name.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import os
import sys
from typing import Any, Callable

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
#: top-level module names the process may not hold once the window closes
FORBIDDEN = ("jax", "jaxlib", "flax", "sparkdl_tpu")


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark_spec(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def load_cell(name: str) -> dict:
    return load_json(os.path.join(BENCH_DIR, "workloads", f"{name}.json"))


def load_config(name: str) -> dict:
    return load_json(os.path.join(BENCH_DIR, "configs", f"{name}.json"))


def load_mode(mode: str):
    return importlib.import_module(f"benchmark.modes.{mode}")


def load_reader(metric: str):
    """The per-layer metric's reader module, ``benchmark/metrics/<metric>.py``
    (a metric name may hold dots, so it is loaded from its path)."""
    path = os.path.join(BENCH_DIR, "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def cell_metrics(spec: dict, cell: str, kind: str) -> list[dict]:
    """The ``end_to_end`` or ``per_layer`` entries a cell reports: those
    whose ``workloads`` list it. An end-to-end metric without the key
    (``setup_s``) is every cell's; every per-layer metric lists its cells."""
    if kind == "end_to_end":
        return [m for m in spec["end_to_end"] if cell in m.get("workloads", [cell])]
    return [m for m in spec["per_layer"] if cell in m["workloads"]]


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one the benchmark may not
    load, compared whole."""
    return sorted(n for n in list(sys.modules) if n.split(".", 1)[0] in FORBIDDEN)


@dataclasses.dataclass
class Check:
    """One number compared: correct while ``value <= limit``."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value == self.value and self.value <= self.limit


@dataclasses.dataclass
class Outcome:
    """What a mode hands back from one run."""

    attempted: int
    failed: int
    #: end-to-end metric name -> value (host clock)
    end_to_end: dict[str, float]
    checks: list[Check]
    device: dict[str, Any]
    #: the traced run's records, read by the per-layer metrics' readers
    records: "dict | None" = None
    breakdown: "dict | None" = None
    #: reasons the run is not correct beyond the checks (a crash, no answers)
    faults: list[str] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class Run:
    """Everything a mode needs to know about this run."""

    args: Any
    cell_name: str
    cell: dict
    config: dict
    spec: dict
    t_process: float
    log: Callable[[str], None]

    def limit(self, check: str) -> float:
        return float(self.cell["checks"][check]["limit"])


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def result_line(run: Run, out: Outcome) -> dict:
    """The result object: metrics by name with units, the device, the
    breakdown, and last the numbers compared with their limits."""
    kind = "per_layer" if run.args.trace else "end_to_end"
    metrics = {}
    for m in cell_metrics(run.spec, run.cell_name, kind):
        if kind == "end_to_end":
            value = out.end_to_end.get(m["name"])
        else:
            value = load_reader(m["name"]).read(out.records or {})
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    correct = not out.faults and out.failed == 0 and all(c.ok for c in out.checks)
    line = {"correct": correct, "attempted": out.attempted, "failed": out.failed,
            "metrics": metrics, "device": out.device}
    if run.args.trace and out.breakdown:
        line["breakdown"] = out.breakdown
    line["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in out.checks}
    return line
