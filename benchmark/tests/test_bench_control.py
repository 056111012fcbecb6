"""The control on the card: the program with its TF32 path switched on
(``--precision tf32``, the step below the float32 the configurations
state) must come out not correct, and the same run in float32 correct.
Each cell at its own size with a short window."""

import json
import os
import subprocess
import sys

import pytest

from benchmark import harness

CELLS = [w["name"] for w in harness.benchmark_spec()["workloads"]]


def _run(cell, seed, *extra):
    out = subprocess.run(
        [sys.executable, os.path.join(harness.BENCH_DIR, "run.py"), "--workload", cell,
         "--seed", str(seed), "--seconds", "8", "--trace", "0", *extra],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_the_tf32_control_is_not_correct(card, cell):
    assert _run(cell, 2 ** 31 + 101)["correct"]
    assert not _run(cell, 2 ** 31 + 101, "--precision", "tf32")["correct"]
