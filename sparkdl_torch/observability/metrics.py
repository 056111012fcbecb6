"""Step-time and throughput meters: the port of the part of
``sparkdl_tpu.observability.metrics`` the serving layer uses.

:func:`percentile` (numpy's linear interpolation, stdlib only) and
:class:`StepMeter`, a windowed recorder of step times and example
counts. Serving rides it for per-request latency and batch occupancy
(``serving/metrics.py``), so one percentile implementation serves the
whole stack. A host clock around device work measures only the enqueue
unless the work ends in a wait: time a device step with
``torch.cuda.synchronize()`` (or an event recorded on its output and
``event.synchronize()``) inside the timed block. The reference's MFU
helpers (XLA cost analysis, a TPU peak table, the cross-host reduce) are
not ported.
"""

from __future__ import annotations

import collections
import statistics
import time


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


def device_count() -> int:
    """CUDA devices visible to this process, at least 1 (the host)."""
    import torch

    return max(1, torch.cuda.device_count())


class StepMeter:
    """Accumulates per-step timings into throughput metrics.

    Usage inside a loop::

        meter = StepMeter(n_chips=torch.cuda.device_count())
        for batch in data:
            with meter.step(examples=len(batch)):
                out = step_fn(batch)
                torch.cuda.synchronize()

    The first ``warmup_steps`` records are dropped (a capture or a first
    kernel build poisons the mean); the window keeps the last ``window``.
    """

    def __init__(self, *, n_chips: int | None = None,
                 window: int = 50, warmup_steps: int = 1):
        self.n_chips = n_chips if n_chips is not None else device_count()
        self.warmup_steps = warmup_steps
        self._times = collections.deque(maxlen=window)
        self._examples = collections.deque(maxlen=window)
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

    def record(self, step_time_s: float, examples: int = 0) -> None:
        self._seen += 1
        if self._seen <= self.warmup_steps:
            return
        self._times.append(step_time_s)
        self._examples.append(examples)
        self._total_examples += examples

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

    def summary(self) -> dict[str, float | int | None]:
        return {
            "steps": self.steps_recorded,
            "total_examples": self._total_examples,
            "step_time_mean_s": self.mean_step_time(),
            "examples_per_sec": self.examples_per_sec(),
            "examples_per_sec_per_chip": self.examples_per_sec_per_chip(),
            "n_chips": self.n_chips,
        }
