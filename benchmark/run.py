"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for. With ``--trace 0`` the result line's metrics are the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics. The last
line of standard output is the result (JSON); the last lines of standard
error are the numbers the correctness checks compared, each with its
limit. ``--precision tf32`` (the control) and ``--fault <name>`` exist for
the readings the checks' limits were set from; the benchmark's own runs
use neither.
"""

from __future__ import annotations

import time

T_PROCESS = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--precision", choices=("float32", "tf32"), default="float32")
    p.add_argument("--fault", default=None)
    args = p.parse_args(argv)
    if args.seed < 0:
        p.error("--seed must be a whole number >= 0")
    return args


def environment(trace: bool) -> None:
    """Caches inside the checkout at fixed paths; the program's own
    settings left at their defaults, tracing as asked."""
    cache = os.path.join(ROOT, ".bench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(cache, "cuda")
    os.environ["USE_FLAX"] = "0"
    for key in [k for k in os.environ if k.startswith("SPARKDL_TORCH_")]:
        del os.environ[key]
    if trace:
        os.environ["SPARKDL_TORCH_TRACE"] = "1"


def restrict_cards(chips: int, count: int) -> None:
    """Leave the cell's cards visible and no others."""
    if count <= chips:
        return
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    ids = visible.split(",") if visible else [str(i) for i in range(count)]
    os.environ["CUDA_VISIBLE_DEVICES"] = ",".join(ids[:chips])


def main(argv=None) -> int:
    args = parse(argv)
    sys.path.insert(0, ROOT)
    environment(bool(args.trace))
    from benchmark import harness

    spec = harness.benchmark_spec()
    entry = next((w for w in spec["workloads"] if w["name"] == args.workload), None)
    if entry is None:
        harness.log(f"no workload {args.workload!r} in BENCHMARK.json")
        return 2
    cell = harness.load_cell(args.workload)
    config = harness.load_config(entry["config"])
    if (cell.get("config"), cell.get("chips"), cell["traffic"].get("name")) != (
            entry["config"], entry["chips"], entry["traffic"]):
        harness.log(f"{args.workload}: its file and BENCHMARK.json disagree")
        return 2
    mode = harness.load_mode(cell["mode"])
    if args.fault is not None and args.fault not in mode.FAULTS:
        harness.log(f"mode {cell['mode']!r} plants no fault {args.fault!r}: {mode.FAULTS}")
        return 2

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        harness.log(f"{args.workload} needs {entry['chips']} CUDA card(s); "
                    f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3
    restrict_cards(entry["chips"], torch.cuda.device_count())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    run = harness.Run(args=args, cell_name=args.workload, cell=cell, config=config,
                      spec=spec, t_process=T_PROCESS, log=harness.log)
    out = mode.run(run)
    loaded = harness.forbidden_modules()
    if loaded:
        harness.log(f"the process loaded modules the benchmark may not load: {loaded}")
        return 4
    line = harness.result_line(run, out)
    for fault in out.faults:
        harness.log(f"not correct: {fault}")
    for name, check in line["checks"].items():
        harness.log(f"check {name}: {check['value']!r} limit {check['limit']!r}")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
