"""Reading a traced run: the profiler's device activity, the program's
spans, and the card's own utilization counter.

Device activity comes from ``torch.profiler`` (CUPTI) as
(name, start, end) on the host's monotonic clock; the profiler stamps
events on the wall clock, so each is shifted by the wall-minus-monotonic
offset read when the trace is taken. Spans are the program's tracing
spans (``SPARKDL_TORCH_TRACE=1``) and the harness's own, on the same
clock.
"""

from __future__ import annotations

import collections
import heapq
import subprocess
import time

from benchmark.stats import gaps, union

MEMORY_OPS = ("Memcpy", "Memset")


def start_profiler():
    """A running profiler of the device's activity."""
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.start()
    return prof


def stop_profiler(prof) -> list[tuple[str, float, float]]:
    """Stop ``prof``; its device events as (name, start, end), monotonic
    seconds."""
    from torch.autograd import DeviceType

    prof.stop()
    offset_ns = time.time_ns() - time.monotonic_ns()
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        start = (e.start_ns() - offset_ns) / 1e9
        out.append((e.name(), start, start + e.duration_ns() / 1e9))
    return out


def program_spans() -> list[tuple[str, float, float, dict]]:
    """The program's finished tracing spans as (name, start, end, args),
    monotonic seconds."""
    from sparkdl_torch.observability.tracing import trace_clock_us, trace_events

    epoch = time.monotonic() - trace_clock_us() / 1e6
    return [(e["name"], epoch + e["ts"] / 1e6, epoch + (e["ts"] + e["dur"]) / 1e6,
             {k: v for k, v in e.get("args", {}).items() if k == "rows"})
            for e in trace_events()]


def is_kernel(name: str) -> bool:
    return not name.startswith(MEMORY_OPS)


def busy_intervals(events, lo: float, hi: float):
    """The union of every device operation's interval in [lo, hi]."""
    return union(((s, e) for _, s, e in events), lo, hi)


def device_ops(events, lo: float, hi: float, top: int = 10):
    """[[name, seconds]]: the device operations that took most time in
    [lo, hi], summed by name."""
    by_name: dict[str, float] = collections.defaultdict(float)
    for name, s, e in events:
        s, e = max(s, lo), min(e, hi)
        if e > s:
            by_name[name] += e - s
    return [[n, t] for n, t in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]]


def durations(events, lo: float, hi: float, top: int = 5) -> str:
    """The launches, and the least, median and 90th-percentile duration in
    ms, of the ``top`` device operations by time in [lo, hi]."""
    by_name: dict[str, list] = collections.defaultdict(list)
    for name, s, e in events:
        if lo <= s < hi:
            by_name[name].append(e - s)
    out = []
    for name, ds in sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:top]:
        ds.sort()
        out.append(f"{name[:60]}: {len(ds)} x min {ds[0] * 1e3:.3f} median "
                   f"{ds[len(ds) // 2] * 1e3:.3f} p90 {ds[int(len(ds) * 0.9)] * 1e3:.3f} ms")
    return "; ".join(out)


def idle_gaps(busy, spans_by_task: dict, lo: float, hi: float, top: int = 10):
    """[[label, seconds]]: the device's idle time in [lo, hi] by what the
    host was doing, summed by label. A gap's label is the set of spans
    open at its midpoint in any task, innermost span of each task."""
    idle = gaps(busy, lo, hi)
    mids = [(s + e) / 2 for s, e in idle]
    labels = [set() for _ in idle]
    for spans in spans_by_task.values():
        for i, name in enumerate(_innermost(spans, mids)):
            if name is not None:
                labels[i].add(name)
    by_label: dict[str, float] = collections.defaultdict(float)
    for (s, e), names in zip(idle, labels):
        by_label["+".join(sorted(names)) or "no span"] += e - s
    return [[n, t] for n, t in sorted(by_label.items(), key=lambda kv: -kv[1])[:top]]


def _innermost(spans, times):
    """For each of the sorted ``times``, the name of the latest-starting
    span open at it (None where none is): a sweep with a heap of open
    spans keyed on their start."""
    order = sorted(spans, key=lambda sp: sp[1])
    heap: list = []
    out, j = [], 0
    for t in times:
        while j < len(order) and order[j][1] <= t:
            heapq.heappush(heap, (-order[j][1], order[j][2], order[j][0]))
            j += 1
        while heap and heap[0][1] <= t:
            heapq.heappop(heap)
        out.append(heap[0][2] if heap else None)
    return out


class SmiSampler:
    """``nvidia-smi`` sampling utilization, power and SM clock every 200 ms
    while the window runs; a cross-check of the profiler's busy share."""

    QUERY = "utilization.gpu,power.draw,clocks.sm"

    def __init__(self):
        try:
            self._proc = subprocess.Popen(
                ["nvidia-smi", f"--query-gpu={self.QUERY}", "--format=csv,noheader,nounits",
                 "-lms", "200"], stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        except OSError:
            self._proc = None

    def stop(self) -> "dict | None":
        """Stop sampling; the means of the samples (first card)."""
        if self._proc is None:
            return None
        self._proc.terminate()
        out, _ = self._proc.communicate(timeout=10)
        rows = []
        for line in out.splitlines():
            try:
                rows.append([float(v) for v in line.split(",")])
            except ValueError:
                continue
        if not rows:
            return None
        keys = self.QUERY.split(",")
        return {k: sum(r[i] for r in rows) / len(rows) for i, k in enumerate(keys)} | {
            "samples": len(rows)}


def card_limits() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi failed: {e}"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else out.stderr.strip()
