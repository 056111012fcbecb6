"""Composable streaming-ingest pipeline (ROADMAP item 2, tf.data-style).

One declarative chain replaces the ad-hoc hand-wired infeeds::

    Pipeline(jpeg_bytes, name="hostfed")
        .map(decode, parallelism=None)        # ordered parallel host work
        .batch(128)                           # bucketing batching
        .to_device(transfer)                  # native ring / prefetch

Stages:

* :meth:`Pipeline.map` — ordered parallel map on a thread pool; the
  window of in-flight items IS the parallelism and is live-resizable
  (the autotuner's ``map_parallelism`` knob).
* :meth:`Pipeline.interleave` — round-robin over ``cycle`` open
  sub-iterators (tf.data ``interleave``): overlap per-source latency
  (file opens, shard fetches) without reordering within a source.
* :meth:`Pipeline.batch` — bucketed batching via
  :func:`~sparkdl_torch.runtime.batching.rebatch` (dict rows ->
  :class:`~sparkdl_torch.runtime.batching.PaddedBatch`).
* :meth:`Pipeline.prefetch` — background-thread readahead
  (:class:`~sparkdl_torch.runtime.prefetch.PrefetchIterator`), depth
  live-resizable without dropping staged batches.
* :meth:`Pipeline.to_device` — the host->device hand-off: the native
  staging ring (:class:`~sparkdl_torch.native.bridge.DeviceFeeder`) for
  uniform feeds when the .so is built, the Python prefetcher otherwise —
  exactly the selection :class:`~sparkdl_torch.transformers._inference.
  BatchedRunner` has always made, now a reusable stage.

``.autotune(...)`` hands every stage's knobs to an
:class:`~sparkdl_torch.ingest.autotune.AutoTuner`; explicitly configured
stage values register pinned (never moved). A pipeline is one-shot: it
iterates its source once; ``close()`` (also on exhaustion and
context-manager exit) releases threads and unregisters knobs.
"""

from __future__ import annotations

import itertools
import os
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Iterable, Iterator, Sequence

from sparkdl_torch.ingest.autotune import (
    AutoTuner,
    Knob,
    autotune_enabled,
    default_tuner,
)

__all__ = ["Pipeline", "resolve_pin", "unique_name"]

_PIPE_IDS = itertools.count(1)


def unique_name(prefix: str) -> str:
    """A process-unique pipeline name with a readable prefix — use for
    knob-exporting pipelines constructed per stream (e.g. each
    ``BatchedRunner.run``), so concurrent streams never collide in the
    tuner's name-keyed registry."""
    return f"{prefix}{next(_PIPE_IDS)}"


def resolve_pin(
    explicit: "int | None",
    env_var: "str | None",
    default: int,
    *,
    what: str,
) -> "tuple[int, bool, str | None]":
    """Resolve one knob's configured value against its env pin.

    Returns ``(value, pinned, pin_source)``. An explicit argument pins;
    a set env var pins; BOTH set and disagreeing is a conflicting-pin
    misconfiguration and raises rather than silently preferring one.
    """
    env_val: "int | None" = None
    if env_var:
        raw = os.environ.get(env_var)
        if raw:
            env_val = int(raw)
            if env_val < 1:
                raise ValueError(
                    f"{env_var} must be >= 1, got {raw!r}")
    if explicit is not None and explicit < 0:
        raise ValueError(f"{what} must be >= 0, got {explicit}")
    if explicit is not None and env_val is not None and explicit != env_val:
        raise ValueError(
            f"conflicting pins for {what}: explicit {explicit} vs "
            f"{env_var}={env_val} — pin it one way, not both"
        )
    if explicit is not None:
        return explicit, True, what
    if env_val is not None:
        return env_val, True, env_var
    return default, False, None


# ---------------------------------------------------------------------------
# Stage implementations
# ---------------------------------------------------------------------------


class _ParallelMapIter(Iterator[Any]):
    """Ordered parallel map: keep up to ``parallelism`` calls in flight,
    yield results in submission order (bitwise-identical stream to a
    plain ``map``). ``parallelism`` is a live attribute — the autotuner
    resizes the in-flight window between takes; the pool is sized at the
    ``hi`` bound once so resizing never spawns/joins threads mid-stream.
    """

    def __init__(self, src: Iterator[Any], fn: Callable[[Any], Any],
                 parallelism: int, hi: int, name: str):
        self._src = src
        self._fn = fn
        self.parallelism = max(1, parallelism)
        self._hi = hi
        self._pool = ThreadPoolExecutor(
            max_workers=hi, thread_name_prefix=f"sparkdl-ingest-{name}")
        self._pending: deque = deque()
        self._exhausted = False
        self._closed = False

    def _top_up(self) -> None:
        window = max(1, min(int(self.parallelism), self._hi))
        while not self._exhausted and len(self._pending) < window:
            try:
                item = next(self._src)
            except StopIteration:
                self._exhausted = True
                break
            self._pending.append(self._pool.submit(self._fn, item))

    def __iter__(self) -> "_ParallelMapIter":
        return self

    def __next__(self) -> Any:
        if self._closed:
            raise StopIteration
        self._top_up()
        if not self._pending:
            self.close()
            raise StopIteration
        fut = self._pending.popleft()
        # refill BEFORE blocking so the window stays full while this
        # result is still cooking
        self._top_up()
        try:
            return fut.result()
        except BaseException:
            self.close()
            raise

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        for f in self._pending:
            f.cancel()
        self._pending.clear()
        self._pool.shutdown(wait=False)


class _InterleaveIter(Iterator[Any]):
    """Round-robin over ``cycle`` open sub-iterators (tf.data
    ``interleave``): each source item opens one sub-iterator via
    ``make_iter``; takes cycle across the open set, refilling from the
    source as sub-iterators exhaust. Deterministic for deterministic
    inputs."""

    def __init__(self, src: Iterator[Any],
                 make_iter: Callable[[Any], Iterable[Any]], cycle: int):
        self._src = src
        self._make = make_iter
        self.cycle = max(1, cycle)
        self._active: "list[Iterator[Any]]" = []
        self._idx = 0
        self._exhausted = False

    def __iter__(self) -> "_InterleaveIter":
        return self

    def _fill(self) -> None:
        while not self._exhausted and len(self._active) < max(1, self.cycle):
            try:
                item = next(self._src)
            except StopIteration:
                self._exhausted = True
                break
            self._active.append(iter(self._make(item)))

    def __next__(self) -> Any:
        while True:
            self._fill()
            if not self._active:
                raise StopIteration
            i = self._idx % len(self._active)
            try:
                v = next(self._active[i])
            except StopIteration:
                del self._active[i]
                self._idx = i
                continue
            self._idx = i + 1
            return v


# ---------------------------------------------------------------------------
# Stage descriptors
# ---------------------------------------------------------------------------


class _Stage:
    name: str

    def build(self, src: Iterator[Any], pipe: "Pipeline") -> Iterator[Any]:
        raise NotImplementedError

    def knobs(self, prefix: str) -> "list[Knob]":
        return []

    def close(self) -> None:
        pass


class _MapStage(_Stage):
    def __init__(self, fn, parallelism, max_parallelism, env_var, name):
        self.name = name
        self._fn = fn
        value, pinned, source = resolve_pin(
            parallelism, env_var, 1, what=f"{name}.parallelism")
        self._start = max(1, value)
        self._pinned = pinned
        self._pin_source = source
        self._hi = max(max_parallelism, self._start)
        self._live: "_ParallelMapIter | None" = None

    def build(self, src, pipe):
        self._live = _ParallelMapIter(
            src, self._fn, self._start, self._hi, self.name)
        return self._live

    def knobs(self, prefix):
        live = self._live
        if live is None:
            return []

        def set_par(v: int, live=live) -> None:
            live.parallelism = v

        return [Knob(
            name=f"{prefix}.{self.name}_parallelism",
            get=lambda live=live: int(live.parallelism),
            set=set_par, lo=1, hi=self._hi,
            pinned=self._pinned, pin_source=self._pin_source,
        )]

    def close(self):
        if self._live is not None:
            self._live.close()


class _InterleaveStage(_Stage):
    def __init__(self, make_iter, cycle, name):
        self.name = name
        self._make = make_iter
        self._cycle = cycle

    def build(self, src, pipe):
        return _InterleaveIter(src, self._make, self._cycle)


class _BatchStage(_Stage):
    def __init__(self, batch_size, buckets, name):
        self.name = name
        self._batch_size = batch_size
        self._buckets = buckets

    def build(self, src, pipe):
        from sparkdl_torch.runtime.batching import rebatch

        return rebatch(src, self._batch_size, self._buckets)


class _TapStage(_Stage):
    """Zero-cost inline observer (``fn(item)`` per item, item passed
    through) — how a consumer records per-batch metadata (``n_valid``)
    without forking the stream."""

    def __init__(self, fn, name):
        self.name = name
        self._fn = fn

    def build(self, src, pipe):
        fn = self._fn

        def gen():
            for item in src:
                fn(item)
                yield item

        return gen()


class _ApplyStage(_Stage):
    """Synchronous inline transform (no thread pool, no readahead):
    for stages that must stay strictly consumer-pulled, e.g. unwrapping
    a ``PaddedBatch`` into its arrays between batch and to_device."""

    def __init__(self, fn, name):
        self.name = name
        self._fn = fn

    def build(self, src, pipe):
        return map(self._fn, src)


class _PrefetchStage(_Stage):
    def __init__(self, depth, transfer, env_var, name, pinned=None):
        self.name = name
        value, auto_pinned, source = resolve_pin(
            depth, env_var, 2, what=f"{name}.depth")
        #: 0 = readahead disabled: the stage passes through (strictly
        #: consumer-pulled, no producer thread) — same contract as
        #: finetune's input_prefetch=0
        self._depth = max(0, value)
        self._pinned = auto_pinned if pinned is None else pinned
        self._pin_source = source
        self._transfer = transfer
        self._live = None

    def build(self, src, pipe):
        if self._depth == 0:
            if self._transfer is None:
                return src
            return map(self._transfer, src)
        from sparkdl_torch.runtime.prefetch import PrefetchIterator

        self._live = PrefetchIterator(
            src, size=self._depth, transfer=self._transfer)
        return self._live

    def knobs(self, prefix):
        live = self._live
        if live is None:
            return []
        return [Knob(
            name=f"{prefix}.{self.name}_depth",
            get=lambda live=live: int(live.depth),
            set=lambda v, live=live: live.set_depth(v),
            lo=1, hi=64,
            pinned=self._pinned, pin_source=self._pin_source,
        )]

    def close(self):
        if self._live is not None:
            self._live.close()


class _ToDeviceStage(_Stage):
    """Host->device staging with transfer/compute overlap: the native
    struct-of-tensors staging ring for uniform feeds, the Python
    prefetcher for ragged feeds or hosts without the .so — the
    BatchedRunner feed policy as a composable stage.

    ``depth``: batches in flight ahead of the consumer (the ring runs
    ``depth + 1`` slots: one being consumed plus ``depth`` staged).
    ``max_bucket``: rows to size ring slot segments for (the largest
    bucket a batch can pad to); None sizes from the first batch.
    On the Python path the depth knob resizes live; the ring's slot
    count is fixed per stream, so there the knob updates the
    process-level suggestion the NEXT stream is built with
    (:func:`sparkdl_torch.native.bridge.set_tuned_ring_slots`).
    """

    def __init__(self, transfer, depth, ragged, max_bucket, env_var, name,
                 pinned=None, lo=1):
        self.name = name
        value, auto_pinned, source = resolve_pin(
            depth, env_var, 2, what=f"{name}.depth")
        self._depth = max(1, value)
        self._pinned = auto_pinned if pinned is None else pinned
        self._pin_source = source
        #: depth floor under tuning (a consumer's chain ceiling: depth
        #: below it makes chain assembly the serialization point)
        self._lo = max(1, lo)
        self._transfer = transfer
        self._ragged = ragged
        self._max_bucket = max_bucket
        self._live_prefetch = None
        self._on_ring = False
        self._gen = None

    def build(self, src, pipe):
        # The ring-vs-prefetch decision happens EAGERLY (it needs the
        # first batch's dtypes/shapes anyway) so knob registration —
        # which runs right after build — sees which path is live.
        from sparkdl_torch.native.bridge import native_available
        from sparkdl_torch.runtime.prefetch import PrefetchIterator

        it = iter(src)
        try:
            first = next(it)
        except StopIteration:
            self._gen = iter(())
            return self._gen
        if (native_available() and not self._ragged
                and isinstance(first, dict)):
            self._on_ring = True
            self._gen = self._ring_feed(first, it)
        else:
            def stream():
                yield first
                yield from it

            self._live_prefetch = PrefetchIterator(
                stream(), size=self._depth, transfer=self._transfer)
            self._gen = self._live_prefetch
        return self._gen

    def _ring_feed(self, first, it):
        from sparkdl_torch.native.bridge import DeviceFeeder, tuned_ring_slots

        def stream():
            yield first
            yield from it

        # segments sized for the LARGEST bucket; the first batch may
        # be a smaller tail bucket
        rows = max(next(iter(first.values())).shape[0], 1)
        bucket = self._max_bucket or rows
        seg = {
            k: (first[k].nbytes // max(first[k].shape[0], 1)) * bucket
            for k in first
        }
        n_slots = tuned_ring_slots(self._depth + 1)
        yield from DeviceFeeder(
            stream(), n_slots=n_slots, max_batch_bytes=seg,
            transfer=self._transfer,
        )

    def knobs(self, prefix):
        if self._live_prefetch is not None:
            live = self._live_prefetch
            return [Knob(
                name=f"{prefix}.{self.name}_depth",
                get=lambda live=live: int(live.depth),
                set=lambda v, live=live: live.set_depth(v),
                lo=self._lo, hi=max(64, self._lo),
                pinned=self._pinned, pin_source=self._pin_source,
            )]
        if self._on_ring:
            from sparkdl_torch.native import bridge

            return [Knob(
                name=f"{prefix}.{self.name}_ring_slots",
                get=lambda d=self._depth: int(
                    bridge.tuned_ring_slots(d + 1)),
                set=bridge.set_tuned_ring_slots,
                # slots = depth + 1 (one consuming + depth staged), so
                # the floor rides one above the depth floor
                lo=max(2, self._lo + 1), hi=max(16, self._lo + 1),
                pinned=self._pinned, pin_source=self._pin_source,
            )]
        return []

    def close(self):
        if self._live_prefetch is not None:
            self._live_prefetch.close()
        elif self._gen is not None and hasattr(self._gen, "close"):
            self._gen.close()


# ---------------------------------------------------------------------------
# The pipeline
# ---------------------------------------------------------------------------


class Pipeline(Iterable[Any]):
    """Declarative stage chain over one source; see module docstring.

    ``source`` is any iterable (consumed once). ``name`` prefixes the
    knob names this pipeline exports (``<name>.<stage>_<knob>``) so
    multiple pipelines tune independently in one registry.
    """

    def __init__(self, source: Iterable[Any], *, name: "str | None" = None):
        self._source = source
        self.name = name or f"pipe{next(_PIPE_IDS)}"
        self._stages: "list[_Stage]" = []
        self._tuner: "AutoTuner | None" = None
        self._tuner_started_here = False
        self._registered: "list[Knob]" = []
        self._extra_knobs: "list[Knob]" = []
        self._live = False
        self._closed = False
        self._lock = threading.Lock()

    # -- stage builders ------------------------------------------------------
    def map(self, fn: Callable[[Any], Any], *,
            parallelism: "int | None" = None, max_parallelism: int = 8,
            env_var: "str | None" = None, name: str = "map") -> "Pipeline":
        """Ordered parallel map. ``parallelism=None`` starts at 1 and is
        autotunable up to ``max_parallelism``; an explicit value (or a
        set ``env_var``) pins it."""
        self._stages.append(
            _MapStage(fn, parallelism, max_parallelism, env_var, name))
        return self

    def interleave(self, make_iter: Callable[[Any], Iterable[Any]], *,
                   cycle: int = 2, name: str = "interleave") -> "Pipeline":
        """Round-robin interleave of ``cycle`` sub-iterators opened by
        ``make_iter`` over consecutive source items."""
        self._stages.append(_InterleaveStage(make_iter, cycle, name))
        return self

    def batch(self, batch_size: int,
              buckets: "Sequence[int] | None" = None, *,
              name: str = "batch") -> "Pipeline":
        """Bucketed batching: dict rows -> ``PaddedBatch`` (static
        shapes: one graph per bucket)."""
        self._stages.append(_BatchStage(batch_size, buckets, name))
        return self

    def tap(self, fn: Callable[[Any], None], *,
            name: str = "tap") -> "Pipeline":
        self._stages.append(_TapStage(fn, name))
        return self

    def apply(self, fn: Callable[[Any], Any], *,
              name: str = "apply") -> "Pipeline":
        """Synchronous inline transform (use :meth:`map` for host work
        worth parallelizing; this one adds zero threads or readahead)."""
        self._stages.append(_ApplyStage(fn, name))
        return self

    def prefetch(self, depth: "int | None" = None, *,
                 transfer: "Callable | None" = None,
                 env_var: "str | None" = None,
                 pinned: "bool | None" = None,
                 name: str = "prefetch") -> "Pipeline":
        """Background-thread readahead ``depth`` deep (default 2,
        autotunable; explicit/env pins — override with ``pinned`` when
        the caller resolved pin-ness itself; ``0`` disables readahead:
        the stage passes through strictly consumer-pulled, applying
        ``transfer`` inline). ``transfer`` runs on the producer thread
        (default :class:`~sparkdl_torch.runtime.prefetch.DevicePut` onto
        the card; pass ``lambda x: x`` for pure host readahead)."""
        self._stages.append(
            _PrefetchStage(depth, transfer, env_var, name, pinned))
        return self

    def to_device(self, transfer: "Callable | None" = None, *,
                  depth: "int | None" = None, ragged: bool = False,
                  max_bucket: "int | None" = None,
                  env_var: "str | None" = None,
                  pinned: "bool | None" = None,
                  lo: int = 1,
                  name: str = "device") -> "Pipeline":
        """Stage batches onto the device: native ring when it applies,
        Python prefetch otherwise (see :class:`_ToDeviceStage`). ``lo``
        floors the tuned depth (pass a consumer's chain ceiling so the
        tuner can never shrink staging below one chain's worth)."""
        self._stages.append(
            _ToDeviceStage(transfer, depth, ragged, max_bucket, env_var,
                           name, pinned, lo))
        return self

    # -- tuning --------------------------------------------------------------
    def autotune(self, enabled: "bool | AutoTuner | None" = True,
                 extra_knobs: "Iterable[Knob] | None" = None) -> "Pipeline":
        """Attach this pipeline's knobs to a tuner when iteration
        starts. ``True`` (or ``None`` with ``SPARKDL_TORCH_AUTOTUNE`` set)
        uses (and starts) the process :func:`default_tuner`; ``False``
        detaches unconditionally — an explicit opt-out beats the env
        var. Pass an :class:`AutoTuner` to supply your own (it is NOT
        auto-started — drive ``tick()`` or ``start()`` yourself).
        ``extra_knobs`` ride along (e.g. a consumer's dispatch chain-K)
        and unregister with the pipeline's own."""
        if isinstance(enabled, AutoTuner):
            self._tuner = enabled
        elif enabled is False:
            self._tuner = None
            self._tuner_started_here = False
        elif autotune_enabled(enabled):
            self._tuner = default_tuner()
            self._tuner_started_here = True
        if extra_knobs is not None:
            self._extra_knobs.extend(extra_knobs)
        return self

    @property
    def tuner(self) -> "AutoTuner | None":
        return self._tuner

    # -- execution -----------------------------------------------------------
    def __iter__(self) -> Iterator[Any]:
        with self._lock:
            if self._live or self._closed:
                raise RuntimeError(
                    f"pipeline {self.name!r} is one-shot: it already "
                    "iterated (build a new Pipeline per pass)"
                )
            self._live = True
        it: Iterator[Any] = iter(self._source)
        for stage in self._stages:
            it = iter(stage.build(it, self))
        if self._tuner is not None:
            for stage in self._stages:
                for knob in stage.knobs(self.name):
                    self._tuner.register(knob)
                    self._registered.append(knob)
            for knob in self._extra_knobs:
                self._tuner.register(knob)
                self._registered.append(knob)
            if self._tuner_started_here:
                self._tuner.start()

        def run():
            try:
                yield from it
            finally:
                self.close()

        return run()

    def close(self) -> None:
        """Release stage threads/buffers and unregister knobs.
        Idempotent; also runs on exhaustion and ``with`` exit."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        if self._tuner is not None:
            for knob in self._registered:
                # identity-checked: a successor stream that re-used the
                # name keeps its live knob
                self._tuner.unregister(knob.name, knob)
            self._registered = []
        for stage in reversed(self._stages):
            try:
                stage.close()
            except Exception:
                pass

    def __enter__(self) -> "Pipeline":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
