"""The harness's own tests: ``python -m pytest benchmark/tests -q`` from the
repository root. Tests marked ``card`` need a CUDA card and skip without
one; the rest run on the CPU at small sizes."""

import os
import sys
import types

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skipped without one")


@pytest.fixture
def card():
    """Skip unless a CUDA card is present (decided here, when the test
    runs, never while the module is imported)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.fixture
def small_run():
    """``small_run(cell_name, seed=..., fault=..., trace=..., seconds=...)``:
    see :func:`_small_run`."""
    return _small_run


def _small_run(cell_name: str, *, seed: int = 2 ** 31 + 17, fault=None, trace: int = 1,
               seconds: float = 0.3):
    """A run of ``cell_name`` cut to a size the CPU holds: one task, two
    partitions of four images, batch 4 (featurization); batch 32 at 32 px
    (training). Returns (Run, mode module)."""
    import time

    from benchmark import harness

    cell = harness.load_cell(cell_name)
    config = harness.load_config(cell["config"])
    if cell["mode"] == "featurize":
        cell["traffic"].update(tasks=1, partition_images=[4, 8],
                               batch_size=4, compared_rows_per_task=3, warmup_partitions=1)
    else:
        cell["traffic"].update(batch_size=32, pool_batches=4)
        config["input_size"] = [32, 32]
    args = types.SimpleNamespace(workload=cell_name, seed=seed, seconds=seconds, trace=trace,
                                 precision="float32", fault=fault)
    run = harness.Run(args=args, cell_name=cell_name, cell=cell, config=config,
                      spec=harness.benchmark_spec(), t_process=time.monotonic(),
                      log=lambda msg: None)
    return run, harness.load_mode(cell["mode"])
