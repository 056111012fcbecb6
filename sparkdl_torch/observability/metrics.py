"""Step-time / throughput / MFU / infeed meters: the port of
``sparkdl_tpu.observability.metrics``.

MFU, as the reference defines it: achieved FLOP/s over peak FLOP/s, with
achieved = the model FLOPs of a step (:func:`compiled_flops`, or a
caller's analytic count) over the measured step time, and peak = one
card's dense peak for the dtype (:func:`device_peak_flops`) times the
cards. Model FLOPs utilization, not a hardware counter.

:func:`percentile` (numpy's linear interpolation, stdlib only) serves
the whole stack; serving rides :class:`StepMeter` for per-request
latency (``serving/metrics.py``). A host clock around device work
measures only the enqueue unless the work ends in a wait: time a device
step with ``torch.cuda.synchronize()`` (or an event recorded on its
output and ``event.synchronize()``) inside the timed block.
"""

from __future__ import annotations

import collections
import math
import statistics
import time
from typing import Any, Callable

#: Dense peak FLOP/s of one card by dtype, keyed by a fragment of
#: ``torch.cuda.get_device_name``: NVIDIA's H100 SXM data sheet (dense,
#: no sparsity). The reference halves bf16 for float32 on a TPU (its MXU
#: runs float32 as bf16 passes); a GPU's float32 runs on the CUDA cores,
#: TF32 on the tensor cores, each at its own rate.
_PEAK_FLOPS: "dict[str, dict[str, float]]" = {
    "H100": {"bf16": 989.4e12, "fp16": 989.4e12, "tf32": 494.7e12,
             "f32": 67e12},
}
_DTYPE_ALIASES = {"bfloat16": "bf16", "float16": "fp16", "half": "fp16",
                  "fp32": "f32", "float32": "f32", "float": "f32"}


def percentile(values: "list[float] | tuple[float, ...]",
               p: float) -> float | None:
    """Linear-interpolated percentile (numpy's default method), stdlib-only
    so meters never pay an array round-trip for a scalar.

    ``p`` in [0, 100]; returns None on an empty sample.
    """
    return _percentile_sorted(sorted(values), p)


def _percentile_sorted(s: "list[float]", p: float) -> float | None:
    """percentile() on an already-sorted sample (one sort, many ps)."""
    if not 0 <= p <= 100:
        raise ValueError(f"percentile must be in [0, 100], got {p}")
    if not s:
        return None
    if len(s) == 1:
        return float(s[0])
    rank = (p / 100.0) * (len(s) - 1)
    lo = int(rank)
    hi = min(lo + 1, len(s) - 1)
    frac = rank - lo
    return float(s[lo] * (1.0 - frac) + s[hi] * frac)


def device_peak_flops(device: Any = None, dtype: str = "bf16") -> "float | None":
    """Dense peak FLOP/s of one card for ``dtype`` (``bf16``, ``fp16``,
    ``tf32``, ``f32``), from its name; None on the CPU or an unknown
    card."""
    import torch

    if device is None:
        if not torch.cuda.is_available():
            return None
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return None
    name = torch.cuda.get_device_name(device)
    key = _DTYPE_ALIASES.get(str(dtype).lower(), str(dtype).lower())
    for tag, peaks in _PEAK_FLOPS.items():
        if tag in name:
            return peaks.get(key)
    return None


def compiled_flops(fn: Callable, *args: Any, **kwargs: Any) -> "float | None":
    """Model FLOPs of one call of ``fn(*args, **kwargs)``, which runs once:
    the matmul and convolution FLOPs ``torch.utils.flop_counter`` sees,
    plus those each hand-written kernel notes for the work its plain
    version's products do (``ops/_dispatch.note_flops``), so the count is
    the same whichever implements attention. Run it on meta-device
    tensors to count without computing (the plain route). None when
    nothing was counted. Unlike the reference's XLA cost analysis, it
    does not count elementwise work."""
    from torch.utils.flop_counter import FlopCounterMode

    from sparkdl_torch.ops._dispatch import flop_tally

    with flop_tally() as kernels, FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    total = float(counter.get_total_flops()) + kernels[0]
    return total if total > 0 else None


def device_count() -> int:
    """CUDA devices visible to this process, at least 1 (the host)."""
    import torch

    return max(1, torch.cuda.device_count())


class StepMeter:
    """Accumulates per-step timings into throughput / MFU / infeed metrics.

    Usage inside a loop::

        meter = StepMeter(flops_per_step=compiled_flops(step, batch),
                          n_chips=1, peak_flops_per_chip=
                          device_peak_flops(dtype="f32"))
        for batch in data:
            with meter.step(examples=len(batch)):
                out = step_fn(batch)
                torch.cuda.synchronize()
            # optionally: meter.note_infeed_wait(seconds)

    The first ``warmup_steps`` records are dropped (a capture or a first
    kernel build poisons the mean); the window keeps the last ``window``.
    ``peak_flops_per_chip`` defaults to :func:`device_peak_flops` (bf16).
    """

    def __init__(self, *, flops_per_example: float | None = None,
                 flops_per_step: float | None = None,
                 n_chips: int | None = None,
                 peak_flops_per_chip: float | None = None,
                 window: int = 50, warmup_steps: int = 1):
        self.flops_per_example = flops_per_example
        self.flops_per_step = flops_per_step
        self.n_chips = n_chips if n_chips is not None else device_count()
        self.peak_flops_per_chip = (
            peak_flops_per_chip if peak_flops_per_chip is not None
            else device_peak_flops())
        self.warmup_steps = warmup_steps
        self._times = collections.deque(maxlen=window)
        self._examples = collections.deque(maxlen=window)
        self._infeed = collections.deque(maxlen=window)
        self._seen = 0
        self._total_examples = 0

    # -- recording -----------------------------------------------------------
    class _StepCtx:
        def __init__(self, meter: "StepMeter", examples: int):
            self._m, self._ex = meter, examples

        def __enter__(self):
            self._t0 = time.perf_counter()
            return self

        def __exit__(self, exc_type, *exc):
            if exc_type is None:
                self._m.record(time.perf_counter() - self._t0, self._ex)

    def step(self, examples: int = 0) -> "_StepCtx":
        return StepMeter._StepCtx(self, examples)

    def record(self, step_time_s: float, examples: int = 0,
               infeed_wait_s: float = 0.0) -> None:
        self._seen += 1
        if self._seen <= self.warmup_steps:
            return
        self._times.append(step_time_s)
        self._examples.append(examples)
        self._infeed.append(infeed_wait_s)
        self._total_examples += examples

    def note_infeed_wait(self, seconds: float) -> None:
        """Attribute host-input stall time to the most recent step."""
        if self._infeed:
            self._infeed[-1] += seconds

    # -- derived metrics -----------------------------------------------------
    @property
    def steps_recorded(self) -> int:
        return len(self._times)

    def mean_step_time(self) -> float | None:
        return statistics.fmean(self._times) if self._times else None

    def step_time_percentile(self, p: float) -> float | None:
        """Percentile of recorded step times over the window (p in
        [0, 100]); None until a step is recorded."""
        return percentile(list(self._times), p)

    def step_time_percentiles(
        self, ps: "tuple[float, ...]" = (50, 95, 99)
    ) -> dict[str, float | None]:
        """The serving-latency trio (p50/p95/p99 by default) off a single
        sort of the window."""
        s = sorted(self._times)
        return {f"p{p:g}": _percentile_sorted(s, p) for p in ps}

    def examples_per_sec(self) -> float | None:
        t = sum(self._times)
        return sum(self._examples) / t if t > 0 else None

    def examples_per_sec_per_chip(self) -> float | None:
        eps = self.examples_per_sec()
        return eps / self.n_chips if eps is not None else None

    def infeed_starvation_pct(self) -> float | None:
        t = sum(self._times)
        return 100.0 * sum(self._infeed) / t if t > 0 else None

    def achieved_flops_per_sec(self) -> float | None:
        t = sum(self._times)
        if t <= 0:
            return None
        if self.flops_per_step is not None:
            return self.flops_per_step * len(self._times) / t
        if self.flops_per_example is not None:
            return self.flops_per_example * sum(self._examples) / t
        return None

    def mfu(self) -> float | None:
        achieved = self.achieved_flops_per_sec()
        peak = self.peak_flops_per_chip
        if achieved is None or not peak:
            return None
        return achieved / (peak * self.n_chips)

    def summary(self) -> dict[str, float | int | None]:
        return {
            "steps": self.steps_recorded,
            "total_examples": self._total_examples,
            "step_time_mean_s": self.mean_step_time(),
            "examples_per_sec": self.examples_per_sec(),
            "examples_per_sec_per_chip": self.examples_per_sec_per_chip(),
            "infeed_starvation_pct": self.infeed_starvation_pct(),
            "mfu": self.mfu(),
            "n_chips": self.n_chips,
        }


def aggregate_across_hosts(metrics: "dict[str, float | None]") -> dict:
    """All-ranks mean/min/max of each numeric metric, identical on every
    rank: an all-gather over the default process group (every rank must
    call it, like any collective). One process returns
    mean=min=max=value.

    The key set must be identical on every rank or the gather misaligns,
    so every key is kept and a missing value rides as NaN, dropped by
    the reduce."""
    import torch

    keys = sorted(metrics.keys())
    local = torch.tensor(
        [float(metrics[k]) if isinstance(metrics[k], (int, float))
         and not isinstance(metrics[k], bool) else math.nan for k in keys],
        dtype=torch.float64)
    stacked = _all_gather_rows(local)
    out: "dict[str, dict[str, float]]" = {}
    for i, k in enumerate(keys):
        col = stacked[:, i]
        col = col[~torch.isnan(col)]
        if col.numel() == 0:
            continue
        out[k] = {
            "mean": float(col.mean()),
            "min": float(col.min()),
            "max": float(col.max()),
        }
    return out


def _all_gather_rows(local: "Any") -> "Any":
    """``[world, n]``: every rank's ``local`` row (float64 on the CPU),
    over the default process group, or ``local[None]`` without one."""
    import torch
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return local[None]
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend() == "nccl" else torch.device("cpu"))
    row = local.to(dev)
    rows = [torch.empty_like(row) for _ in range(dist.get_world_size())]
    dist.all_gather(rows, row)
    return torch.stack(rows).cpu()
