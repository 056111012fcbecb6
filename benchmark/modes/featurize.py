"""Featurization as a Spark executor with one card runs it: ``tasks``
Python worker processes share the card (``spark.task.resource.gpu.amount
= 1 / tasks``), each calling ``DeepImageFeaturizer.transform`` on one
partition after another.

The parent builds the program's kernels and host library once, starts the
task processes (spawned: each a fresh interpreter, as PySpark's workers
are), waits until every task has made its weights, rows and warm-up, then
opens the window for all of them at once. A task runs partitions until the
window closes; every partition started in the window counts, also the one
that ends after it. Tasks send back small records over a pipe: the
partitions' times, the results of the exact checks, the features of the
rows drawn for the comparison, and with ``--trace 1`` the device activity
and spans. After every task has exited the parent works out the sampled
rows' features again with the plain reference and compares.
"""

from __future__ import annotations

import importlib
import os
import time
import traceback

import numpy as np

from benchmark import harness, stats, trace, traffic, weights

#: the fault a ``--fault`` run plants in the task (for the readings of
#: the checks' limits; the benchmark's own runs plant none)
FAULTS = ("altered_answer", "half_batch")


def _reference(config: dict):
    return importlib.import_module(f"benchmark.reference.{config['reference']}")


def _size(config: dict) -> tuple[int, int]:
    return tuple(config["input_size"])


# -- the task process ---------------------------------------------------------

def task_main(conn, p: dict) -> None:
    """A task process: set up, wait for the window, run it, report."""
    try:
        conn.send(("done", _task(conn, p)))
    except BaseException:  # the parent reports the traceback
        conn.send(("error", traceback.format_exc()))
    finally:
        conn.close()


def _plant(fault: str, named_image):
    """Break the timed path underneath the featurizer: every batch's
    output with one row's answer altered, or with the second half of the
    batch left out and given the first half's answers. Returns what puts
    the path back."""
    inner = named_image._named_apply

    def broken_apply(*a, **kw):
        apply_fn = inner(*a, **kw)

        def apply(batch):
            out = apply_fn(batch)
            if fault == "altered_answer":
                out = out.clone()
                out[0] += out[0].abs() * 0.01 + 1e-3
                return out
            half = out.shape[0] // 2
            return out[:half].repeat(2, 1)[:out.shape[0]] if half else out
        return apply

    named_image._named_apply = broken_apply
    return lambda: setattr(named_image, "_named_apply", inner)


def _task(conn, p: dict) -> dict:
    from sparkdl_torch.transformers import named_image

    # a task owns its process; run inside the parent (the CPU tests) it
    # starts from empty model caches and leaves the path as it found it
    named_image._load_named_model.cache_clear()
    named_image._named_model_runner.cache_clear()
    restore = _plant(p["fault"], named_image) if p["fault"] else None
    try:
        return _run_task(conn, p, named_image)
    finally:
        if restore is not None:
            restore()
        named_image._named_model_runner.cache_clear()
        named_image._load_named_model.cache_clear()


def _run_task(conn, p: dict, named_image) -> dict:
    import torch

    cfg, tr, task, seed = p["config"], p["traffic"], p["task"], p["seed"]
    device, size = p["device"], _size(cfg)
    cuda = device == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = p["tf32"]
    torch.backends.cudnn.allow_tf32 = p["tf32"]
    torch.set_num_threads(p["threads"])

    from sparkdl_torch import DeepImageFeaturizer, LocalDataFrame
    from sparkdl_torch.observability import tracing

    if p["trace"]:
        tracing.enable_tracing()
    featurizer = DeepImageFeaturizer(
        inputCol="image", outputCol="features", modelName=cfg["model_name"],
        weights="random", batchSize=tr["batch_size"], device=device)
    # DeepImageFeaturizer takes no weights object: load the seed's into the
    # module it builds, before its first batch prepares them
    module = named_image._load_named_model(cfg["model_name"], "random", False, device)
    with torch.device("meta"):
        shapes = _reference(cfg).build()
    module.load_state_dict(weights.make_state(shapes, seed, device))

    n_parts = len(tr["partition_images"])
    parts = [traffic.partition_rows(seed, task, i, tr, size) for i in range(n_parts)]
    ids = [[r["id"] for r in part] for part in parts]
    holes = [set(traffic.undefined_at(seed, task, i, tr)) for i in range(n_parts)]

    def transform(part):
        return featurizer.transform(LocalDataFrame.from_rows(part, 1)).collect()

    for i in range(tr["warmup_partitions"]):
        transform(parts[i % len(parts)])
    if named_image._load_named_model.cache_info().currsize != 1:
        raise RuntimeError("the featurizer built a second model beside the one "
                           "holding the seed's weights")
    runner = _runner(named_image, cfg, tr, device)
    graphs_before = _graph_count(runner)
    used_peak = _device_used() if cuda else 0
    if p["trace"]:
        tracing.clear_trace()
    prof = trace.start_profiler() if p["trace"] and cuda else None

    conn.send(("ready", {"device": torch.cuda.get_device_name() if cuda else "cpu"}))
    _, t_start, t_end = conn.recv()
    while time.monotonic() < t_start:
        time.sleep(t_start - time.monotonic())

    records, outputs, failures, bench_spans = [], [], [], []
    n = 0
    while True:
        t0 = time.monotonic()
        if t0 >= t_end:
            break
        i = n % len(parts)
        try:
            out = transform(parts[i])
            outputs.append((i, [(r["id"], r["features"]) for r in out]))
        except Exception:
            failures.append(traceback.format_exc())
            out = None
        t1 = time.monotonic()
        images = len(parts[i]) - len(holes[i])
        records.append((t0, t1, images if out is not None else 0))
        bench_spans.append(("bench.partition", t0, t1, {}))
        if cuda:
            used_peak = max(used_peak, _device_used())
        n += 1
    if cuda:
        torch.cuda.synchronize()
    events = trace.stop_profiler(prof) if prof is not None else []
    spans = trace.program_spans() + bench_spans if p["trace"] else []

    # the exact checks on every partition of the window: ids passed
    # through in order, the undefined rows null, every other row a finite
    # feature vector
    wrong = 0
    sample = {pair: [] for pair in traffic.sample_rows(seed, task, tr)}
    for i, rows in outputs:
        if len(rows) != len(ids[i]):
            wrong += len(ids[i])
            continue
        for pos, (rid, feat) in enumerate(rows):
            if rid != ids[i][pos]:
                wrong += 1
            elif pos in holes[i]:
                wrong += feat is not None
            elif feat is None or feat.shape != (cfg["feature_dim"],) or \
                    not np.isfinite(feat).all():
                wrong += 1
            elif (i, pos) in sample:
                sample[(i, pos)].append(np.array(feat, dtype=np.float32))
    from benchmark.harness import forbidden_modules

    return {"task": task, "records": records, "failures": failures,
            "rows_wrong": wrong, "sample": sample, "used_peak": used_peak,
            "graphs_in_window": _graph_count(runner) - graphs_before,
            "events": events, "spans": spans, "forbidden": forbidden_modules()}


def _runner(named_image, cfg, tr, device):
    return named_image._named_model_runner(cfg["model_name"], "random", False,
                                           "features", tr["batch_size"], device)


def _graph_count(runner) -> int:
    """Graphs the runner's chainer holds (the program's own count)."""
    try:
        return len(runner._chainer.graph_keys)
    except AttributeError:
        return 0


def _device_used() -> int:
    """Bytes in use on the card, by every process on it."""
    import torch

    free, total = torch.cuda.mem_get_info()
    return total - free


# -- the parent ---------------------------------------------------------------

class _LocalConn:
    """A task's end of the pipe when the task runs inside the parent (the
    harness's own tests on the CPU): the window opens when asked for."""

    def __init__(self, seconds: float):
        self.seconds, self.window = seconds, None

    def send(self, msg):
        pass

    def recv(self):
        now = time.monotonic()
        self.window = (now, now + self.seconds)
        return ("go", *self.window)

    def close(self):
        pass


def _params(run: harness.Run, task: int, device: str) -> dict:
    tr = run.cell["traffic"]
    return {"config": run.config, "traffic": tr, "task": task, "seed": run.args.seed,
            "device": device, "trace": bool(run.args.trace),
            "tf32": run.args.precision == "tf32", "fault": run.args.fault,
            "threads": tr["threads_per_task"]}


def _receive(conn, proc, deadline: float):
    """The next message from a task, or an error once it died or the
    deadline passed."""
    while not conn.poll(1.0):
        if not proc.is_alive():
            raise RuntimeError(f"task process exited with code {proc.exitcode}")
        if time.monotonic() > deadline:
            raise RuntimeError("task process did not answer in time")
    try:
        kind, *body = conn.recv()
    except EOFError:
        raise RuntimeError(f"task process exited with code {proc.exitcode}") from None
    if kind == "error":
        raise RuntimeError(f"task process failed:\n{body[0]}")
    return body


def run(run: harness.Run, *, device: str = "cuda", inline: bool = False) -> harness.Outcome:
    tr = run.cell["traffic"]
    if device == "cuda":
        _build_program(run)
    if inline:
        if tr["tasks"] != 1:
            raise ValueError("a task inside the parent runs alone: give the cell 1 task")
        conn = _LocalConn(run.args.seconds)
        results = [_task(conn, _params(run, 0, device))]
        (t_start, t_end), ready, smi = conn.window, [{"device": device}], None
    else:
        results, ready, t_start, t_end, smi = _spawned(run, device)
    return _outcome(run, results, ready, t_start, t_end, smi, device)


def _build_program(run: harness.Run) -> None:
    """The kernels (nvcc) and the staging ring's host library (g++), built
    once into the program's build directory before any task starts."""
    from sparkdl_torch.native import _lib
    from sparkdl_torch.ops import _dispatch

    t0 = time.monotonic()
    built = _dispatch.build_all()
    ring = _lib.BRIDGE.lib() is not None
    run.log(f"[build] {len(built)} kernel libraries built, ring library "
            f"{'loaded' if ring else 'NOT built: ' + str(_lib.BRIDGE.build_error)[:200]}, "
            f"{time.monotonic() - t0:.1f} s")


def _spawned(run: harness.Run, device: str):
    import multiprocessing as mp

    tr = run.cell["traffic"]
    os.environ["OMP_NUM_THREADS"] = str(tr["threads_per_task"])
    ctx = mp.get_context("spawn")
    tasks = []
    try:
        for task in range(tr["tasks"]):
            parent, child = ctx.Pipe()
            proc = ctx.Process(target=task_main, args=(child, _params(run, task, device)),
                               name=f"bench-task-{task}")
            proc.start()
            child.close()
            tasks.append((parent, proc))
        deadline = time.monotonic() + tr["setup_timeout_s"]
        ready = [_receive(c, p, deadline)[0] for c, p in tasks]
        smi = trace.SmiSampler() if run.args.trace else None
        t_start = time.monotonic() + 0.05
        t_end = t_start + run.args.seconds
        for conn, _ in tasks:
            conn.send(("go", t_start, t_end))
        deadline = t_end + tr["drain_timeout_s"]
        results = [_receive(c, p, deadline)[0] for c, p in tasks]
        for _, proc in tasks:
            proc.join(timeout=60)
    finally:
        for conn, proc in tasks:
            if proc.is_alive():
                proc.kill()
                proc.join(timeout=30)
            conn.close()
    return results, ready, t_start, t_end, smi


def _outcome(run, results, ready, t_start, t_end, smi, device) -> harness.Outcome:
    tr, cfg = run.cell["traffic"], run.config
    records = [r for res in results for r in res["records"]]
    rate, seconds, images, attempted = stats.window_rate(records, t_start, t_end)
    failed = sum(len(res["failures"]) for res in results)
    for res in results:
        for f in res["failures"][:1]:
            run.log(f"[task {res['task']}] partition failed:\n{f}")
    e2e = {"setup_s": t_start - run.t_process}
    if rate is not None:
        e2e["images_per_s"] = rate
    per_task = [sum(t_start <= r[0] < t_end for r in res["records"]) for res in results]
    p90 = stats.window_tail(records, t_start, t_end, 90) if rate is not None else 0.0
    run.log(f"[window] {attempted} partitions ({per_task} by task) started in "
            f"{run.args.seconds} s, {images} images over {seconds:.3f} s, partition p90 "
            f"{p90 * 1e3:.1f} ms; graphs captured inside the window "
            f"{[r['graphs_in_window'] for r in results]}")
    device_info = {"platform": "gpu" if device == "cuda" else device,
                   "kind": ready[0]["device"], "count": run.cell["chips"],
                   "memory_peak_bytes": max(r["used_peak"] for r in results)}
    forbidden = sorted({m for r in results for m in r["forbidden"]})
    faults = [f"task processes loaded {forbidden}"] if forbidden else []

    rec = breakdown = None
    if run.args.trace and rate is not None:
        lo, hi = t_start, t_start + seconds
        events = [e for res in results for e in res["events"]]
        busy = trace.busy_intervals(events, lo, hi)
        busy_s = sum(e - s for s, e in busy)
        device_info["busy_s"] = busy_s
        device_info["window_s"] = seconds
        spans = [s for res in results for s in res["spans"]]
        rec = {"mode": "featurize", "cell": run.cell, "config": cfg,
               "window": (lo, hi), "window_s": seconds, "busy_s": busy_s,
               "images": images, "rate": rate, "events": events,
               "partitions": [r[:2] for r in records if t_start <= r[0] < t_end],
               "spans": [s for s in spans if lo <= s[1] < hi]}
        run.log(f"[trace] durations: {trace.durations(events, lo, hi)}")
        breakdown = {"device_ops": trace.device_ops(events, lo, hi),
                     "idle_gaps": trace.idle_gaps(
                         busy, {res["task"]: res["spans"] for res in results}, lo, hi)}
        sampled = smi.stop() if smi else None
        run.log(f"[trace] device busy {busy_s:.3f} of {seconds:.3f} s "
                f"({busy_s / seconds:.1%}) by the profiler; nvidia-smi over the window: "
                f"{sampled}; {trace.card_limits()}")
    elif smi:
        smi.stop()

    checks = _judge(run, results, device)
    if attempted == 0:
        faults.append("no partition started in the window")
    return harness.Outcome(attempted=attempted, failed=failed, end_to_end=e2e,
                           checks=checks, device=device_info, records=rec,
                           breakdown=breakdown, faults=faults)


def _judge(run: harness.Run, results, device: str) -> list[harness.Check]:
    """The checks, worked out once every task has exited: rows wrong in the
    exact checks, and the widest gap between a sampled row's features (at
    every pass of the window) and the reference's, relative to the
    reference's largest feature."""
    import torch

    cfg, tr, seed = run.config, run.cell["traffic"], run.args.seed
    size = _size(cfg)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref = _reference(cfg)
    with torch.device(device):
        module = ref.build()
    module.load_state_dict(weights.make_state(module, seed, device))
    pairs = [(res["task"], part, pos, got) for res in results
             for (part, pos), got in res["sample"].items() if got]
    worst, compared = 0.0, 0
    block = tr["batch_size"]
    for i in range(0, len(pairs), block):
        chunk = pairs[i:i + block]
        rgb = np.stack([traffic.bgr_bytes_to_rgb(
            traffic.image_bytes(seed, task, part, pos, size), size)
            for task, part, pos, _ in chunk])
        want = ref.features(module, torch.from_numpy(rgb).to(device)).cpu().numpy()
        for (_, _, _, got), w in zip(chunk, want):
            scale = float(np.abs(w).max())
            for g in got:
                worst = max(worst, float(np.abs(g - w).max()) / scale)
                compared += 1
    run.log(f"[check] {compared} sampled answers of {len(pairs)} rows compared with the "
            f"reference ({cfg['reference']}, float32, TF32 off)")
    return [
        harness.Check("feature_err", worst if compared else float("nan"),
                      run.limit("feature_err")),
        harness.Check("rows_wrong", sum(r["rows_wrong"] for r in results),
                      run.limit("rows_wrong")),
    ]
