"""Shared batched-inference engine for the transformers.

A map of ``apply_fn`` over bucketed, padded batches (runtime/batching.py)
through the host feed: batches are staged onto the card ahead of the
device (the native staging ring, native/bridge.py), same-bucket batches
run as CUDA-graph replays, K per dispatch where that pays
(runtime/dispatch.py), and each result's device->host copy runs while the
next dispatch computes (runtime/completion.py). One graph per bucket
that occurs, captured on its first use.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
import weakref
from concurrent.futures import TimeoutError as FuturesTimeoutError
from typing import Any, Callable, Iterator

import numpy as np
import torch

from sparkdl_torch.observability.tracing import span
from sparkdl_torch.ops._dispatch import resolve_device
from sparkdl_torch.reliability.faults import fault_point
from sparkdl_torch.runtime.batching import default_buckets, pad_to_bucket
from sparkdl_torch.runtime.completion import (
    AsyncFetcher,
    FetchTicket,
    start_fetch,
)
from sparkdl_torch.runtime.dispatch import (
    ChainPolicy,
    ScanChainer,
    record_dispatch,
)
from sparkdl_torch.runtime.prefetch import DevicePut
from sparkdl_torch.runtime.tree import tree_map

_NOT_PORTED = "not ported to sparkdl_torch yet (ROADMAP {item})"


@dataclasses.dataclass
class BatchedRunner:
    """Maps ``apply_fn(batch_dict) -> tensor (or tuple of tensors)`` over
    row streams. Inputs are dicts of numpy arrays with a leading batch
    dim; ``apply_fn`` gets the same keys as tensors on ``device``, under
    ``torch.inference_mode``. Outputs follow the batch's leading dim and
    come back as numpy arrays that own their memory.

    Host->device staging: every uniform-row feed rides the native C++
    staging ring (:class:`~sparkdl_torch.native.bridge.DeviceFeeder`):
    packer thread -> page-locked slot -> transfer thread -> card,
    double-buffered so the card computes batch i while batch i+1 is on
    the wire and i+2 is packing. Multi-tensor feeds pack as a
    struct-of-tensors slot with a fixed byte segment per key. Ragged
    feeds and hosts without the library use the pure-Python prefetcher
    with the same overlap semantics.

    ``ragged_rows=True`` declares that row shapes vary across batches:
    ring slots are fixed-size, so such feeds must keep to the Python path.

    ``data_parallel`` and ``partitioner`` keep the reference's names. A
    :class:`~sparkdl_torch.partition.SingleDevicePartitioner` pins the
    runner to its device (how a ReplicaPool builds its executors);
    placement across cards is not ported yet, so ``data_parallel=True``
    or any other partitioner raises.
    """

    apply_fn: Callable[[dict[str, torch.Tensor]], Any]
    batch_size: int = 64
    #: Staging-pipeline depth (batches in flight ahead of the device).
    #: None = auto: ``SPARKDL_TORCH_PREFETCH`` env pin if set, else 2 —
    #: and the depth is a live autotuner knob when :attr:`autotune` is
    #: on. An explicit int (or the env var) PINS the depth and excludes
    #: it from tuning; both set and disagreeing fails loud. 0 (with
    #: ``chain_k=1``) stages nothing ahead: each batch is put on the card
    #: inline, on the consumer's thread — the strictly serial feed.
    prefetch: "int | None" = None
    ragged_rows: bool = False
    #: Not ported (placement over cards, ROADMAP A8): None or False.
    data_parallel: "bool | None" = None
    #: Fused multi-step dispatch (runtime/dispatch.py): chain this many
    #: same-bucket batches per CUDA-graph replay in :meth:`run`. None =
    #: auto (``SPARKDL_TORCH_CHAIN_K`` env, else the ChainPolicy picks K
    #: from measured program time vs the calibrated dispatch gap); 1
    #: pinned runs every batch eagerly, without graphs. Outputs are
    #: bitwise-identical either way — chaining is a dispatch decision,
    #: never a numeric one. Memory: chaining holds up to K staged batches
    #: (auto caps K at 8) and each captured (bucket, K) keeps its graph's
    #: memory.
    chain_k: "int | None" = None
    #: Async completion (runtime/completion.py): start each result's
    #: device->host copy as soon as its dispatch is enqueued and collect
    #: it while the NEXT dispatch runs. True (default) pipelines
    #: :meth:`run` readback ``fetch_window`` deep; False restores the
    #: strictly blocking readback (the parity reference — outputs are
    #: bitwise identical either way).
    async_fetch: bool = True
    #: Results in flight for the async readback window. None = auto:
    #: prefetch depth x resolved chain length, so device memory holds at
    #: most that many result buffers.
    fetch_window: "int | None" = None
    #: ``cuda`` (default) or ``cpu``; ``cuda`` raises where CUDA is absent.
    device: Any = "cuda"
    #: None, or a SingleDevicePartitioner whose device the runner takes
    #: (other layouts are ROADMAP A8).
    partitioner: Any = None
    #: Online autotuning of the ingest knobs (sparkdl_torch/ingest): the
    #: staging depth, the dispatch chain K, and the native packer
    #: parallelism become live knobs on the process
    #: :func:`~sparkdl_torch.ingest.default_tuner`, resized from the
    #: measured starvation / producer-blocked shares. None = defer to
    #: ``SPARKDL_TORCH_AUTOTUNE`` (default off). Explicitly pinned knobs
    #: (``prefetch=``, ``chain_k=``, their env pins) are registered for
    #: visibility but never moved.
    autotune: "bool | None" = None

    def __post_init__(self):
        from sparkdl_torch.ingest.pipeline import resolve_pin, unique_name

        from sparkdl_torch.partition import SingleDevicePartitioner

        if self.data_parallel or not (
                self.partitioner is None
                or isinstance(self.partitioner, SingleDevicePartitioner)):
            raise NotImplementedError(
                "data_parallel=True / partitioner= (batches placed over "
                "several cards) is " + _NOT_PORTED.format(item="A8 partition")
                + "; a runner drives one card")
        if self.partitioner is not None:
            if (self.device != "cuda"
                    and resolve_device(self.device) != self.partitioner.device):
                raise ValueError(
                    "device= is sugar for partitioner=SingleDevicePartitioner"
                    "(device); pass one or the other, not both")
            self.device = self.partitioner.device
        self.device = resolve_device(self.device)
        self._prefetch_depth, self._prefetch_pinned, _ = resolve_pin(
            self.prefetch, "SPARKDL_TORCH_PREFETCH", 2, what="prefetch")
        # knob prefix: unique per RUNNER so concurrent autotuned runners
        # never collide in the tuner's name-keyed registry, while one
        # runner's successive streams keep one stable set of names
        self._pipe_name = unique_name("batch")
        self._chainer = ScanChainer(
            self._apply, path="batch", chain_k=self.chain_k,
            # auto mode holds K staged batches for the chain on top of
            # the prefetch queue: cap auto-K at 8 so peak input memory
            # stays bounded on unchanged caller code
            policy=ChainPolicy(max_chain=8), device=self.device,
        )
        self._chunk = self.batch_size
        self._buckets = default_buckets(self.batch_size)
        if self.fetch_window is not None and self.fetch_window < 1:
            raise ValueError(
                f"fetch_window must be >= 1, got {self.fetch_window}"
            )

    def _apply(self, batch: dict[str, torch.Tensor]) -> Any:
        with torch.inference_mode():
            return self.apply_fn(batch)

    @property
    def chunk_size(self) -> int:
        """Rows per device dispatch (``batch_size``: one card)."""
        return self._chunk

    @property
    def max_inflight_batches(self) -> int:
        """How many ``run_batch_async`` dispatches a caller (a
        micro-batcher) should keep in flight against this runner: one
        resolving while one runs."""
        return 2 if self.async_fetch else 1

    def _fetch_window(self) -> int:
        """Async readback window: prefetch depth x resolved chain length
        (a K-chain hands back K results per dispatch, so the window must
        cover ``prefetch`` dispatches' worth of outputs to keep the
        pipeline full). This holds up to that many RESULT buffers on the
        device — workloads with outputs as large as their inputs should
        pin ``fetch_window`` lower."""
        if self.fetch_window is not None:
            return self.fetch_window
        chain = self._chainer.chain_k or self._chainer.policy.max_chain
        return max(2, self._prefetch_depth) * max(1, chain)

    def run(self, rows: Iterator[dict[str, np.ndarray]]) -> Iterator[Any]:
        """Yield one output per input row, in order.

        Single-array apply_fns yield arrays; tuple-valued apply_fns yield
        per-row tuples.

        The feed is one composable ingest pipeline (sparkdl_torch/ingest):
        ``rows -> batch(bucketing) -> to_device(ring | prefetch)``; with
        :attr:`autotune` on it exports its depth plus this runner's
        chain-K and the native packer parallelism as live tuner knobs.
        Outputs are bitwise-identical under every setting.
        """
        from sparkdl_torch import ingest

        # keep (n_valid) alongside the device computation
        metas: list[int] = []
        tuning = ingest.autotune_enabled(self.autotune)
        pname = self._pipe_name
        # built here, on the consumer's thread: its copies are ordered
        # for the stream this thread dispatches on
        transfer = DevicePut(self.device)
        pipe = (
            ingest.Pipeline(rows, name=pname)
            .batch(self._chunk, self._buckets)
            .tap(lambda b: metas.append(b.n_valid))
            .apply(lambda b: b.arrays)
        )
        depth = self._feed_depth()
        if depth == 0:
            pipe = pipe.apply(transfer, name="device")
        else:
            pipe = pipe.to_device(
                transfer=transfer,
                depth=depth,
                ragged=self.ragged_rows,
                max_bucket=max(self._buckets),
                pinned=self._prefetch_pinned,
                # the staging depth may never shrink below the chain
                # ceiling: a K-chain consumes K staged batches per
                # dispatch, so depth < K turns chain assembly into the
                # serialization point (_feed_depth's invariant, kept
                # under tuning by the knob floor)
                lo=self._chain_floor(),
            )
        if tuning:
            pipe.autotune(True, extra_knobs=self._tuning_knobs(pname))
        results = iter(pipe)
        # Fused dispatch: runs of same-bucket staged batches are chained
        # K-per-replay behind the staging buffer; ragged tail buckets
        # flush unchained. Output order and values are identical to the
        # one-dispatch-per-batch loop.
        outputs = self._chainer.map_stream(results)
        if self.async_fetch:
            # each output's D2H copy starts the moment its dispatch is
            # enqueued and is collected while the following dispatches
            # run; an error still surfaces on ITS batch
            outputs = AsyncFetcher(
                window=self._fetch_window(), path="batch"
            ).stream(outputs)
        else:
            outputs = map(_blocking_readback, outputs)
        for i, arrays in enumerate(outputs):
            n = metas[i]
            with span("batch.unpad", rows=n):
                if isinstance(arrays, (tuple, list)):
                    out_rows = [tuple(a[j] for a in arrays) for j in range(n)]
                else:
                    out_rows = list(arrays[:n])
            yield from out_rows

    def _chain_floor(self) -> int:
        """The chain ceiling the staging depth must cover: the RESOLVED
        chain_k (env override included), or the policy ceiling in auto
        mode since K can ramp there after the first measured dispatch."""
        return self._chainer.chain_k or self._chainer.policy.max_chain

    def _feed_depth(self) -> int:
        """Staging depth: a K-chain consumes K staged batches per
        dispatch, so the pipeline must run at least that far ahead or
        the chain assembly itself becomes the serialization point. 0 only
        for ``prefetch=0`` with ``chain_k=1``: the serial feed."""
        floor = self._chain_floor()
        return max(self._prefetch_depth, floor if floor > 1 else 0)

    def _tuning_knobs(self, prefix: str) -> "list[Any]":
        """This runner's non-stage knobs for the autotuner: the dispatch
        chain K (inverted — it grows when the CONSUMER side lags, i.e.
        producer-blocked, to amortize per-dispatch overhead) and the
        native packer parallelism. Pinned chain lengths (explicit
        ``chain_k=`` or ``SPARKDL_TORCH_CHAIN_K``) register pinned so the
        gauge still exports them but the tuner never moves them."""
        from sparkdl_torch.ingest.autotune import Knob
        from sparkdl_torch.native import bridge

        ch = self._chainer

        def get_k(ch=ch) -> int:
            return int(ch.chain_k if ch.chain_k is not None
                       else ch.policy.chain_len())

        def set_k(v: int, ch=ch) -> None:
            # map_stream consults target_chain_len() per item, so a live
            # chain_k write takes effect at the next group boundary.
            # Growth is clamped to the ChainPolicy's overhead-aware
            # recommendation: chaining past the K that already holds the
            # dispatch-gap share under target buys nothing and only
            # delays host visibility.
            ch.chain_k = max(1, min(int(v), ch.policy.chain_len()))

        knobs = [Knob(
            name=f"{prefix}.chain_k", get=get_k, set=set_k,
            lo=1, hi=ch.policy.max_chain, inverted=True,
            pinned=ch.pinned, pin_source=ch.pin_source,
        )]
        # the pack-thread knob deliberately keeps its process-global
        # name: it closes over module-global state shared by every
        # stream, so all registrations ARE the same knob
        knobs.extend(bridge.pack_knobs())
        return knobs

    def run_batch(self, arrays: dict[str, np.ndarray]):
        """One-shot dispatch for the online serving path: pad the stacked
        batch to its bucket, stage it, run the SAME step (graph) the batch
        path runs, and unpad.

        Returns the output array [n, ...] (or a tuple of arrays for
        multi-output apply_fns). An empty input (a serving flush tick)
        still runs the smallest bucket — pad_to_bucket zero-fills it — so
        the outputs keep their real dtypes and feature shapes, just with
        0 rows.
        """
        return self.run_batch_async(arrays).result()

    def run_batch_async(self, arrays: dict[str, np.ndarray]) -> "BatchResult":
        """The future-returning :meth:`run_batch`: dispatch now, start
        the async D2H copy, and hand back a :class:`BatchResult` whose
        ``result()`` blocks only for whatever copy time is left. A
        micro-batcher pipelines on this — it assembles and dispatches the
        NEXT micro-batch while the previous one's readback lands. One
        request group = one dispatch, never chained: chaining would
        couple unrelated requests' failure domains."""
        fault_point("dispatch")
        padded = pad_to_bucket(arrays, self._buckets)
        t0 = time.perf_counter()
        with span("serving.device_step", rows=padded.n_valid,
                  bucket=padded.bucket):
            staged = DevicePut(self.device)(padded.arrays)
            out = self._chainer.run([staged])[0]
            ticket = start_fetch(out, path="serving")
        return BatchResult(ticket, padded.n_valid, t0)


def _blocking_readback(out: Any) -> Any:
    """The strictly blocking device->host read (``async_fetch=False``)."""
    with span("batch.d2h"):
        return tree_map(lambda t: t.detach().cpu().numpy()
                        if isinstance(t, torch.Tensor) else np.asarray(t), out)


class BatchResult:
    """In-flight :meth:`BatchedRunner.run_batch_async` result.

    ``result()`` collects the host output (unpadded to the live rows),
    records the dispatch into the spine exactly once, and re-raises this
    batch's error if its readback failed. Thread-safe and idempotent, so
    a micro-batcher may resolve from any thread; a timeout is not
    terminal (the result stays collectable).

    The recorded ``sparkdl_dispatch_seconds{path="serving"}`` spans
    dispatch to COLLECTION: when resolution is pipelined it includes the
    bounded residency behind the predecessors, so it reads as pipeline
    latency, not pure device time."""

    __slots__ = ("_ticket", "_n_valid", "_t0", "_done", "_value", "_exc",
                 "_lock")

    def __init__(self, ticket: FetchTicket, n_valid: int, t0: float):
        self._ticket = ticket
        self._n_valid = n_valid
        self._t0 = t0
        self._done = False
        self._value: Any = None
        self._exc: "BaseException | None" = None
        self._lock = threading.Lock()

    def result(self, timeout: "float | None" = None):
        with self._lock:
            if not self._done:
                try:
                    out = self._ticket.result(timeout)
                except FuturesTimeoutError:
                    raise  # not terminal: collect again later
                except BaseException as e:
                    self._exc = e
                else:
                    if isinstance(out, (tuple, list)):
                        self._value = tuple(
                            np.asarray(o)[: self._n_valid] for o in out
                        )
                    else:
                        self._value = np.asarray(out)[: self._n_valid]
                self._done = True
                record_dispatch(
                    "serving", 1, time.perf_counter() - self._t0
                )
            if self._exc is not None:
                raise self._exc
            return self._value


#: graph object -> {cache key: BatchedRunner}; weak so graphs can be GC'd.
_GRAPH_RUNNERS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def cached_graph_runner(graph, key, make_runner: Callable[[], BatchedRunner]) -> BatchedRunner:
    """Process-wide runner cache keyed by (graph identity, key).

    One translation (and one set of CUDA graphs) per (ingested graph,
    shape/batch/device config) no matter how many partitions, transformer
    copies, or transformer classes touch it: ``make_runner`` runs on a
    miss only, and ``key`` must cover every setting it bakes in."""
    per_graph = _GRAPH_RUNNERS.setdefault(graph, {})
    if key not in per_graph:
        per_graph[key] = make_runner()
    return per_graph[key]


def try_extract(extract: Callable[[Any], dict[str, np.ndarray]],
                row: Any) -> "tuple[dict[str, np.ndarray] | None, Exception | None]":
    """Run ``extract`` on one row, capturing the error instead of raising:
    a row that cannot be featurized degrades to a per-row error and never
    poisons its batch."""
    try:
        return extract(row), None
    except Exception as e:  # per-row data errors become None outputs
        return None, e


def run_partition_with_passthrough(
    rows: "list[dict]",
    extract: Callable[[dict], dict[str, np.ndarray]],
    runner: BatchedRunner,
    output_col: str,
    postprocess: Callable[[np.ndarray], Any] | None = None,
    input_cols: "tuple[str, ...] | None" = None,
) -> Iterator[dict]:
    """Run inference for a partition, appending ``output_col`` to each row.

    ``extract`` turns a row into the numeric feature dict the model eats;
    rows it raises on are yielded unchanged with output None (undecodable
    rows are tolerated). Misconfiguration stays loud rather than masked as
    bad data: missing ``input_cols`` raise immediately, and an
    all-rows-failed partition logs a warning with the first error.
    """
    if rows and input_cols:
        missing = [c for c in input_cols if c not in rows[0]]
        if missing:
            raise KeyError(
                f"input column(s) {missing} not in DataFrame columns "
                f"{sorted(rows[0].keys())}"
            )
    feeds: list[dict[str, np.ndarray] | None] = []
    first_error: Exception | None = None
    with span("partition.extract", rows=len(rows)):
        for r in rows:
            feed, err = try_extract(extract, r)
            first_error = first_error or err
            feeds.append(feed)
    valid = [f for f in feeds if f is not None]
    if rows and not valid and first_error is not None:
        logging.getLogger(__name__).warning(
            "all %d rows in partition failed extraction (output=None); "
            "first error: %r", len(rows), first_error,
        )
    outputs = runner.run(iter(valid)) if valid else iter(())
    for r, f in zip(rows, feeds):
        out_row = dict(r)
        if f is None:
            out_row[output_col] = None
        else:
            o = next(outputs)
            out_row[output_col] = postprocess(o) if postprocess else o
        yield out_row
