"""Training as a user's loop drives the program's fused ResNet50 step.

Set-up builds one object, the step ``make_resnet50_fused_train_step``
returns over the program's ``ResNet50`` and a ``torch.optim.SGD``, loads the
seed's weights into it, and calls it once on the pool's last batch: that
call runs the step eagerly and captures its CUDA graph. The seed's
parameters and running statistics are then copied back in place (the
graph reads the same storage) and the momentum buffers zeroed (0.9 x 0 +
g is SGD's first step), so the three compared steps, on the pool's first
three batches, are replays of the graph the window times. It keeps what
the checks need: the loss of each of those steps, each leaf's first
gradient as the optimizer holds it (SGD's first momentum buffer is the
gradient), and the parameters and running statistics after step 3. The
same object then runs the window, cycling
through the pool, with at most ``inflight_steps`` steps queued ahead of
the card as a loop that reads its losses keeps them. Once the window has
closed and the program's state is freed, the plain reference takes the
same three steps from the same weights and batches, and the gaps are
compared.
"""

from __future__ import annotations

import gc
import importlib
import statistics
import time

from benchmark import harness, trace, traffic, weights

#: the faults a ``--fault`` run plants in the call of the step (for the
#: readings of the checks' limits; the benchmark's own runs plant none):
#: half the batch left out, the mean taken over the rest; or a step whose
#: state comes back unchanged
FAULTS = ("half_batch", "frozen")
#: leaves whose reference gradient is under this share of the median
#: leaf's move by round-off alone (a conv bias under a training-mode
#: BatchNorm): they are left out of the change's comparison
ROUNDING_GRAD = 1e-3


def _set_tf32(torch, on: bool) -> None:
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def _state(module):
    """(parameters, running statistics) by name, as detached copies."""
    params = {n: p.detach().clone() for n, p in module.named_parameters()}
    stats_ = {n: b.detach().clone() for n, b in module.named_buffers()
              if n.endswith(("running_mean", "running_var"))}
    return params, stats_


def _norms(tensors: dict) -> dict:
    return {n: float(t.double().norm()) for n, t in tensors.items()}


def _diff_norms(after: dict, before: dict) -> dict:
    return {n: float((after[n].double() - before[n].double()).norm()) for n in after}


def _first_steps(call, module, optimizer, xs, ys, steps: int = 3) -> dict:
    """Drive ``call`` through the first ``steps`` batches; the losses, the
    first gradient's norms, the running statistics' change after step 1
    and the change of both after the last step."""
    p0, s0 = _state(module)
    losses, grad, stats1 = [], None, None
    for k in range(steps):
        losses.append(call(xs[k], ys[k]))
        if k == 0:
            grad = _norms({n: optimizer.state[p]["momentum_buffer"]
                           for n, p in module.named_parameters()})
            stats1 = _diff_norms(_state(module)[1], s0)
    p3, s3 = _state(module)
    return {"losses": [float(v) for v in losses], "grad": grad, "stats1": stats1,
            "change": _diff_norms(p3, p0), "stats": _diff_norms(s3, s0)}


def _worst_gap(got: dict, want: dict, names) -> float:
    """The widest gap between the program's norm and the reference's over
    ``names``, against the reference's norm of that leaf or of the median
    leaf, whichever is larger."""
    names = list(names)
    median = statistics.median(want[n] for n in names)
    return max(abs(got[n] - want[n]) / max(want[n], median) for n in names)


def _faulty(call, fault, module, batch: int):
    if fault == "half_batch":
        half = batch // 2
        return lambda x, y: call(x[:half], y[:half])
    if fault == "frozen":
        def frozen(x, y):
            p, s = _state(module)
            loss = call(x, y)
            with_names = dict(module.named_parameters()) | dict(module.named_buffers())
            for n, t in (p | s).items():
                with_names[n].data.copy_(t)
            return loss
        return frozen
    return call


def _capture_then_restore(call, module, optimizer, state, x, y) -> None:
    """Call the step once on (x, y), which on the card captures its graph,
    then put back the seed's state in place and zero the momentum."""
    import torch

    call(x, y)
    module.load_state_dict(state)
    with torch.no_grad():
        for p in module.parameters():
            optimizer.state[p]["momentum_buffer"].zero_()


def run(run: harness.Run, *, device: str = "cuda") -> harness.Outcome:
    """One run; the step runs in this process."""
    import torch

    cfg, tr, seed = run.config, run.cell["traffic"], run.args.seed
    size, classes = tuple(cfg["input_size"]), cfg["num_classes"]
    cuda = device == "cuda"
    _set_tf32(torch, run.args.precision == "tf32")
    if cuda:
        from sparkdl_torch.ops import _dispatch

        t0 = time.monotonic()
        built = _dispatch.build_all()
        run.log(f"[build] {len(built)} kernel libraries built, {time.monotonic() - t0:.1f} s")
    from sparkdl_torch.models.resnet import ResNet50
    from sparkdl_torch.ops.fused_gemm_bn import gemm_bn_stats
    from sparkdl_torch.train.vision import make_resnet50_fused_train_step

    ref = importlib.import_module(f"benchmark.reference.{cfg['reference']}")
    with torch.device("meta"):
        shapes = ref.build(include_top=True)
    module = ResNet50(num_classes=classes, device=device)
    state = weights.make_state(shapes, seed, device)
    module.load_state_dict(state)
    opt = torch.optim.SGD(module.parameters(), lr=tr["lr"], momentum=tr["momentum"])
    step = make_resnet50_fused_train_step(module, opt, num_classes=classes,
                                          dtype=torch.float32)
    call = _faulty(step, run.args.fault, module, tr["batch_size"])
    xs, ys = traffic.train_pool(seed, tr, size, classes, device)

    _capture_then_restore(call, module, opt, state, xs[-1], ys[-1])
    del state
    captured = step.graphs.captures
    program = _first_steps(call, module, opt, xs, ys)
    replayed = step.graphs.captures == captured
    run.log(f"[set-up] graphs captured before the compared steps {captured}, "
            f"during them {step.graphs.captures - captured}")
    used_peak = _device_used() if cuda else 0
    if cuda:
        torch.cuda.synchronize()
    prof = trace.start_profiler() if run.args.trace and cuda else None
    launches0 = gemm_bn_stats.launches

    t_start = time.monotonic()
    t_end = t_start + run.args.seconds
    losses, queued, spans = [], [], []
    n = 3
    while True:
        t0 = time.monotonic()
        if t0 >= t_end:
            break
        i = n % len(xs)
        losses.append(call(xs[i], ys[i]))
        spans.append(("bench.step", t0, time.monotonic(), {}))
        if cuda:
            done = torch.cuda.Event()
            done.record()
            queued.append(done)
            if len(queued) > tr["inflight_steps"]:
                queued.pop(0).synchronize()
        n += 1
    if cuda:
        torch.cuda.synchronize()
    t_last = time.monotonic()
    events = trace.stop_profiler(prof) if prof is not None else []
    steps = n - 3
    seconds = t_last - t_start
    if cuda:
        used_peak = max(used_peak, _device_used())
    nonfinite = int((~torch.isfinite(torch.stack(losses))).sum()) if losses else 0
    launches = gemm_bn_stats.launches - launches0
    kind = torch.cuda.get_device_name() if cuda else "cpu"
    run.log(f"[window] {steps} steps of {tr['batch_size']} in {seconds:.3f} s; "
            f"fused GEMM launches {launches} ({launches / max(steps, 1):.1f} a step)")

    device_info = {"platform": "gpu" if cuda else device, "kind": kind,
                   "count": run.cell["chips"], "memory_peak_bytes": used_peak}
    e2e = {"setup_s": t_start - run.t_process}
    if steps:
        e2e["train_samples_per_s"] = steps * tr["batch_size"] / seconds
    rec = breakdown = None
    if run.args.trace and steps:
        lo, hi = t_start, t_last
        busy = trace.busy_intervals(events, lo, hi)
        busy_s = sum(e - s for s, e in busy)
        device_info["busy_s"], device_info["window_s"] = busy_s, seconds
        rec = {"mode": "train", "cell": run.cell, "config": cfg, "window": (lo, hi),
               "window_s": seconds, "busy_s": busy_s, "steps": steps,
               "samples": steps * tr["batch_size"], "rate": e2e["train_samples_per_s"],
               "events": events, "spans": spans, "gemm_bn_launches": launches}
        run.log(f"[trace] durations: {trace.durations(events, lo, hi)}")
        breakdown = {"device_ops": trace.device_ops(events, lo, hi),
                     "idle_gaps": trace.idle_gaps(busy, {0: spans}, lo, hi)}
        run.log(f"[trace] device busy {busy_s:.3f} of {seconds:.3f} s "
                f"({busy_s / seconds:.1%}) by the profiler; {trace.card_limits()}")

    # the program's state goes before the reference runs
    del step, call, opt, module, xs, ys, losses, queued, events
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    checks = _judge(run, program, ref, device, nonfinite)
    faults = [] if steps else ["no step ran in the window"]
    if not replayed:
        faults.append("the compared steps captured a graph: they were not replays")
    return harness.Outcome(attempted=steps, failed=nonfinite, end_to_end=e2e, checks=checks,
                           device=device_info, records=rec, breakdown=breakdown,
                           faults=faults)


def reference_steps(run, ref, device: str) -> dict:
    """The reference's first three steps from the seed's weights and
    batches, in float32 with TF32 off."""
    import torch

    cfg, tr, seed = run.config, run.cell["traffic"], run.args.seed
    _set_tf32(torch, False)
    with torch.device(device):
        module = ref.build(include_top=True)
    module.load_state_dict(weights.make_state(module, seed, device))
    opt = torch.optim.SGD(module.parameters(), lr=tr["lr"], momentum=tr["momentum"])
    xs, ys = traffic.train_pool(seed, tr, tuple(cfg["input_size"]), cfg["num_classes"],
                                device, count=3)

    def call(x, y):
        opt.zero_grad(set_to_none=True)
        loss = ref.loss(module, x, y)
        loss.backward()
        opt.step()
        return loss.detach()

    return _first_steps(call, module, opt, xs, ys)


def moved_leaves(want: dict) -> list[str]:
    """The leaves whose reference gradient is not nought to rounding."""
    median_grad = statistics.median(want["grad"].values())
    return [n for n, g in want["grad"].items() if g >= ROUNDING_GRAD * median_grad]


def readings(got: dict, want: dict, nonfinite: int = 0) -> dict:
    """Every number the checks can compare, of ``got``'s first steps
    against ``want``'s."""
    gaps = [abs(g - w) / abs(w) for g, w in zip(got["losses"], want["losses"])]
    moved = moved_leaves(want)
    median_change = statistics.median(want["change"][n] for n in moved)
    return {
        "loss_gap": max(gaps),
        "loss1_gap": gaps[0],
        "grad_gap": _worst_gap(got["grad"], want["grad"], want["grad"]),
        "change_gap": _worst_gap(got["change"], want["change"], moved),
        "change_median_gap": abs(statistics.median(got["change"][n] for n in moved)
                                 - median_change) / median_change,
        "stats_gap": _worst_gap(got["stats"], want["stats"], want["stats"]),
        "stats1_gap": _worst_gap(got["stats1"], want["stats1"], want["stats1"]),
        "losses_nonfinite": nonfinite,
    }


def _judge(run, program: dict, ref, device: str, nonfinite: int) -> list[harness.Check]:
    """The reference's first three steps and the gaps to the program's."""
    want = reference_steps(run, ref, device)
    values = readings(program, want, nonfinite)
    run.log(f"[check] losses {program['losses']} vs reference {want['losses']}; "
            f"{len(want['change']) - len(moved_leaves(want))} of {len(want['change'])} "
            f"leaves left out of the change (reference gradient under {ROUNDING_GRAD} of "
            f"the median)")
    for name, value in values.items():
        if name not in run.cell["checks"]:
            run.log(f"[reading] {name}: {value!r} (not compared)")
    return [harness.Check(name, values[name], run.limit(name)) for name in run.cell["checks"]]


def _device_used() -> int:
    import torch

    free, total = torch.cuda.mem_get_info()
    return total - free
