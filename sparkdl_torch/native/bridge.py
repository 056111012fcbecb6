"""Python surface over the native staging library.

- :class:`StagingRing` — fixed-slot producer/consumer ring whose slots are
  stable aligned C allocations (numpy views, zero-copy on the host side).
- :func:`pack_rows` — threaded scatter of N rows into one padded
  [bucket, row_stride] matrix (native memcpy fan-out; numpy fallback).
- :class:`DeviceFeeder` — the double-buffered feed: a packer thread fills
  ring slots, a transfer thread copies each slot to the card and recycles
  it only after the copy lands, the consumer iterates device tensors while
  the next batch is already in flight.

On the card the ring's slots are page-locked (``cudaHostRegister``) the
first time a batch goes through each, so every host->device copy is a DMA
straight from the slot. Page-locking costs more than a batch's copy, so a
ring that ended its stream cleanly goes back to a small process-wide pool
and the next stream of the same slot geometry takes it as it is: the
featurizer runs one stream per partition. Everything degrades to pure
Python/numpy when the library cannot be built
(:func:`native_available` tells you which path is live).
"""

from __future__ import annotations

import ctypes
import queue
import threading
import time
from typing import Any, Callable, Iterable, Iterator, Sequence

import numpy as np

import torch

from sparkdl_torch.native import _lib
from sparkdl_torch.observability import tracing
from sparkdl_torch.runtime.prefetch import DevicePut
from sparkdl_torch.runtime.tree import tree_leaves


def native_available() -> bool:
    return _lib.available()


#: process-wide feeder telemetry: how many streams rode the native ring vs
#: the python fallback, and batches/bytes through the ring. Read by tests
#: (the "does the hot path actually traverse the ring" proof); the
#: observability registry mirrors (below) are the operator surface —
#: `/metrics` sees DeviceFeeder starvation the same way it already sees
#: prefetch starvation.
FEED_STATS = {
    "ring_streams": 0,
    "fallback_streams": 0,
    "ring_batches": 0,
    "ring_bytes": 0,
    #: streams that took a ring from the pool instead of a new one
    "ring_reused": 0,
    #: ring slots page-locked on the card (each once in its ring's life)
    "pinned_slots": 0,
}

#: Autotuned suggestions (sparkdl_torch/ingest): the ring's slot count is
#: fixed per stream (native allocations), so its knob lands here and the
#: NEXT DeviceFeeder stream is built with it; pack threads apply live —
#: every pack_rows call without an explicit n_threads reads the current
#: value. None = untuned defaults.
_TUNED: "dict[str, int | None]" = {"ring_slots": None, "pack_threads": None}

_DEFAULT_PACK_THREADS = 4


def tuned_ring_slots(default: int) -> int:
    """Ring slot count for the next staged stream: the autotuned
    suggestion when one is set, else ``default``."""
    v = _TUNED["ring_slots"]
    return int(v) if v else default


def set_tuned_ring_slots(n: "int | None") -> None:
    _TUNED["ring_slots"] = int(n) if n else None


def tuned_pack_threads() -> int:
    """Threads for the native row-pack memcpy fan-out (live-tunable)."""
    v = _TUNED["pack_threads"]
    return int(v) if v else _DEFAULT_PACK_THREADS


def set_tuned_pack_threads(n: "int | None") -> None:
    _TUNED["pack_threads"] = int(n) if n else None


def pack_knobs():
    """The bridge's process-level autotuner knobs (packer parallelism;
    producer-side: grows when the feed starves the consumer). Ring-slot
    knobs are per-stream and exported by the ingest ``to_device`` stage
    instead."""
    from sparkdl_torch.ingest.autotune import Knob

    return [Knob(
        name="native.pack_threads",
        get=tuned_pack_threads,
        set=set_tuned_pack_threads,
        lo=1, hi=8,
    )]

_METRICS = None


def _ring_metrics():
    """Lazy registry handles for the staging-ring spine (kept off the
    import path — this module must import without the observability
    package warmed up): (batches counter, bytes counter, slot-wait
    counter [packer blocked on a free slot = the transfer/compute side
    is the bottleneck], consumer-wait histogram [consumer blocked on the
    ring output = infeed starvation, same meaning as
    ``sparkdl_prefetch_consumer_wait_seconds`` on the Python path])."""
    global _METRICS
    if _METRICS is None:
        from sparkdl_torch.observability.registry import registry

        _METRICS = (
            registry().counter(
                "sparkdl_ring_batches_total",
                "batches staged through the native ring"),
            registry().counter(
                "sparkdl_ring_bytes_total",
                "bytes staged through the native ring"),
            registry().counter(
                "sparkdl_ring_slot_wait_seconds_total",
                "packer time blocked waiting for a free ring slot "
                "(device/transfer side is the bottleneck)"),
            registry().histogram(
                "sparkdl_ring_consumer_wait_seconds",
                "consumer time blocked on the ring output queue "
                "(infeed starvation)"),
        )
    return _METRICS


# ---------------------------------------------------------------------------
# Staging ring
# ---------------------------------------------------------------------------

class StagingRing:
    """FIFO ring of fixed-size staging slots backed by native memory.

    Producer: ``idx = acquire_write(); slot_view(idx)[...] = ...;
    commit_write(idx, n_rows)``. Consumer: ``idx = acquire_read();
    use slot_view(idx); release_read(idx)``. ``close()`` ends the stream;
    readers then drain and get ``None``.
    """

    def __init__(self, slot_bytes: int, n_slots: int = 3):
        l = _lib.lib()
        if l is None:
            raise RuntimeError(
                "native bridge unavailable (build failed or disabled); "
                "use the pure-Python prefetcher instead"
            )
        self._l = l
        self._h = l.sdl_ring_create(slot_bytes, n_slots)
        if not self._h:
            raise MemoryError(f"could not allocate {n_slots}x{slot_bytes} ring")
        self.slot_bytes = slot_bytes
        self.n_slots = n_slots

    def slot_view(self, idx: int) -> np.ndarray:
        ptr = self._l.sdl_ring_slot_ptr(self._h, idx)
        return np.ctypeslib.as_array(ptr, shape=(self.slot_bytes,))

    def acquire_write(self, timeout_s: float = -1.0) -> int | None:
        r = self._l.sdl_ring_acquire_write(self._h, timeout_s)
        return None if r < 0 else int(r)

    def commit_write(self, idx: int, n_rows: int, used_bytes: int = 0) -> None:
        self._l.sdl_ring_commit_write(self._h, idx, n_rows, used_bytes)

    def abort_write(self, idx: int) -> None:
        self._l.sdl_ring_abort_write(self._h, idx)

    def acquire_read(self, timeout_s: float = -1.0) -> int | None:
        """Next committed slot index; None on timeout or end-of-stream
        (distinguish via :meth:`closed`)."""
        r = self._l.sdl_ring_acquire_read(self._h, timeout_s)
        return None if r < 0 else int(r)

    def slot_rows(self, idx: int) -> int:
        return int(self._l.sdl_ring_slot_rows(self._h, idx))

    def slot_used(self, idx: int) -> int:
        return int(self._l.sdl_ring_slot_used(self._h, idx))

    def release_read(self, idx: int) -> None:
        self._l.sdl_ring_release_read(self._h, idx)

    def close(self) -> None:
        self._l.sdl_ring_close(self._h)

    @property
    def closed(self) -> bool:
        return bool(self._l.sdl_ring_closed(self._h))

    def destroy(self) -> None:
        if self._h:
            self._l.sdl_ring_destroy(self._h)
            self._h = None

    def __enter__(self) -> "StagingRing":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
        self.destroy()


# ---------------------------------------------------------------------------
# Row packing
# ---------------------------------------------------------------------------

def pack_rows(
    rows: Sequence[np.ndarray],
    *,
    bucket: int | None = None,
    row_stride: int | None = None,
    out: np.ndarray | None = None,
    n_threads: "int | None" = None,
) -> np.ndarray:
    """Pack per-row byte arrays into a padded [bucket, row_stride] uint8
    matrix; rows beyond ``len(rows)`` repeat row 0 (bucketed padding).

    ``out`` may be a preallocated buffer (e.g. a ring ``slot_view`` slice)
    to pack straight into staging memory. ``n_threads`` defaults to the
    live autotuned value (:func:`tuned_pack_threads`).
    """
    if not rows:
        raise ValueError("pack_rows needs at least one row")
    if n_threads is None:
        n_threads = tuned_pack_threads()
    srcs = [np.ascontiguousarray(r).view(np.uint8).reshape(-1) for r in rows]
    n = len(srcs)
    stride = row_stride or max(s.nbytes for s in srcs)
    total = bucket or n
    if total < n:
        raise ValueError(f"bucket {total} < n_rows {n}")
    if out is None:
        out = np.empty(total * stride, np.uint8)
    else:
        out = out.view(np.uint8).reshape(-1)
        if out.nbytes < total * stride:
            raise ValueError("out buffer too small")

    l = _lib.lib()
    if l is None:
        view = out[: total * stride].reshape(total, stride)
        for i in range(total):
            s = srcs[i] if i < n else srcs[0]
            nb = min(s.nbytes, stride)
            view[i, :nb] = s[:nb]
            view[i, nb:] = 0
        return view

    ptrs = (ctypes.POINTER(ctypes.c_uint8) * n)(
        *[s.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)) for s in srcs]
    )
    sizes = (ctypes.c_uint64 * n)(*[s.nbytes for s in srcs])
    l.sdl_pack_rows(
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ptrs, sizes, n, total, 0, stride, n_threads,
    )
    return out[: total * stride].reshape(total, stride)


def u8_to_f32(src: np.ndarray, scale: float = 1.0, bias: float = 0.0,
              n_threads: int = 4) -> np.ndarray:
    """Threaded uint8 -> float32 affine cast (numpy fallback without lib)."""
    src = np.ascontiguousarray(src, np.uint8)
    l = _lib.lib()
    if l is None:
        return src.astype(np.float32) * scale + bias
    dst = np.empty(src.shape, np.float32)
    l.sdl_u8_to_f32(
        dst.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        src.size, scale, bias, n_threads,
    )
    return dst


# ---------------------------------------------------------------------------
# Double-buffered device feeder
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# Page-locked slots and the ring pool
# ---------------------------------------------------------------------------

def _pin_slot(ring: StagingRing, idx: int) -> None:
    """Page-lock one slot of ``ring`` for DMA, once in the ring's life."""
    pinned = ring.__dict__.setdefault("pinned", set())
    if idx in pinned:
        return
    ptr = ctypes.cast(ring._l.sdl_ring_slot_ptr(ring._h, idx), ctypes.c_void_p)
    rc = torch.cuda.cudart().cudaHostRegister(ptr.value, ring.slot_bytes, 0)
    if int(rc) != 0:
        raise RuntimeError(
            f"cudaHostRegister of a {ring.slot_bytes}-byte ring slot failed: "
            f"cudaError {int(rc)}")
    pinned.add(idx)
    FEED_STATS["pinned_slots"] += 1


def _destroy(ring: StagingRing) -> None:
    """Close and free a ring, unlocking its page-locked slots first."""
    ring.close()
    for idx in ring.__dict__.pop("pinned", ()):
        ptr = ctypes.cast(ring._l.sdl_ring_slot_ptr(ring._h, idx),
                          ctypes.c_void_p)
        torch.cuda.cudart().cudaHostUnregister(ptr.value)
    ring.destroy()


#: idle rings that ended their stream cleanly, oldest first; at most
#: _POOL_SIZE are kept (their page-locked slots with them)
_POOL: "list[StagingRing]" = []
_POOL_SIZE = 2
_POOL_LOCK = threading.Lock()


def _take_ring(slot_bytes: int, n_slots: int) -> StagingRing:
    with _POOL_LOCK:
        for i, r in enumerate(_POOL):
            if (r.slot_bytes, r.n_slots) == (slot_bytes, n_slots):
                FEED_STATS["ring_reused"] += 1
                return _POOL.pop(i)
    return StagingRing(slot_bytes, n_slots)


def _give_back(ring: StagingRing) -> None:
    with _POOL_LOCK:
        _POOL.append(ring)
        evicted = _POOL[:-_POOL_SIZE] if len(_POOL) > _POOL_SIZE else []
        del _POOL[:len(evicted)]
    for r in evicted:
        _destroy(r)


def release_pooled_rings() -> None:
    """Free every idle pooled ring (and unlock its slots)."""
    with _POOL_LOCK:
        idle = list(_POOL)
        _POOL.clear()
    for r in idle:
        _destroy(r)


# ---------------------------------------------------------------------------
# Double-buffered device feeder
# ---------------------------------------------------------------------------

class DeviceFeeder:
    """Iterate device tensors from a host batch stream with full overlap.

    Pipeline: packer thread (host assembly into ring slots) -> transfer
    thread (``transfer`` from stable slot memory; slot recycled only after
    the copy has landed) -> consumer (this iterator). With n_slots >= 2
    the host is packing batch i+2 while batch i+1 is on the wire and batch
    i is computing: the double-buffered feed.

    ``batches``: yields either np.ndarray (single-tensor feed) or
    dict[str, np.ndarray] with a FIXED key set (struct-of-tensors feed —
    text's input_ids+attention_mask and multi-input graphs). A dict batch
    occupies one slot with a fixed byte segment per key, so the whole
    struct rides one ring transaction; the iterator then yields dicts of
    device tensors. Shapes may vary in the leading dim only.
    ``transfer`` defaults to :class:`~sparkdl_torch.runtime.prefetch.
    DevicePut` onto the card. With a :class:`DevicePut` onto the card the
    slot is page-locked on first use and the put's own CUDA event, waited
    on by the transfer thread, gates the slot's release; any other
    transfer is followed by a device synchronize before the release, and
    gets a copy of the slot (it may keep the host memory it was given).
    ``max_batch_bytes`` bounds slot segment sizes: an int for array
    feeds, a per-key dict for struct feeds.
    """

    def __init__(
        self,
        batches: "Iterable[np.ndarray | dict[str, np.ndarray]]",
        *,
        n_slots: int = 3,
        transfer: "Callable[[Any], Any] | None" = None,
        max_batch_bytes: "int | dict[str, int] | None" = None,
    ):
        self._batches = batches
        self._n_slots = n_slots
        self._transfer = transfer
        self._max_bytes = max_batch_bytes

    def __iter__(self) -> Iterator[Any]:
        transfer = self._transfer or DevicePut()
        it = iter(self._batches)
        try:
            first = next(it)
        except StopIteration:
            return

        # normalize both feed forms onto the struct layout: an array feed
        # is a one-key struct that unwraps on yield
        is_struct = isinstance(first, dict)
        if self._max_bytes is not None and is_struct != isinstance(
                self._max_bytes, dict):
            raise TypeError(
                "max_batch_bytes must match the feed form: a dict of "
                "per-key byte caps for dict feeds, an int for array "
                f"feeds (got {type(self._max_bytes).__name__} for a "
                f"{'dict' if is_struct else 'array'} feed)"
            )
        if is_struct:
            keys = list(first)
            first = {k: np.ascontiguousarray(first[k]) for k in keys}
            seg = dict(self._max_bytes or {})
            for k in keys:
                seg.setdefault(k, first[k].nbytes)
        else:
            keys = ["__array__"]
            first = {"__array__": np.ascontiguousarray(first)}
            seg = {"__array__": (self._max_bytes
                                 if self._max_bytes is not None
                                 else first["__array__"].nbytes)}
        offsets = {}
        off = 0
        for k in keys:
            offsets[k] = off
            off += seg[k]
        slot_bytes = off

        def as_struct(b):
            if is_struct:
                missing = [k for k in keys if k not in b]
                if missing:
                    raise ValueError(f"feed batch missing key(s) {missing}")
                return {k: np.ascontiguousarray(b[k]) for k in keys}
            return {"__array__": np.ascontiguousarray(b)}

        def unwrap(d):
            return d if is_struct else d["__array__"]

        if not native_available():
            FEED_STATS["fallback_streams"] += 1
            # Pure-Python path: same overlap via the prefetch queue.
            from sparkdl_torch.runtime.prefetch import prefetch_to_device

            def chain():
                yield unwrap(first)
                for b in it:
                    yield b

            # size must stay >=1: Queue(maxsize=0) is UNbounded, the
            # opposite of the tight buffering n_slots=1 asks for.
            yield from prefetch_to_device(chain(),
                                          size=max(1, self._n_slots - 1),
                                          transfer=transfer)
            return

        # a DevicePut onto the card copies out of page-locked slots and
        # waits for its own copy; a CPU put would alias the slot (and so
        # may any other transfer), so those get a copy of it
        to_card = (isinstance(transfer, DevicePut)
                   and transfer.device.type == "cuda")
        ring = _take_ring(slot_bytes, self._n_slots)
        FEED_STATS["ring_streams"] += 1
        meta: dict[int, dict] = {}  # slot idx -> {key: (shape, dtype)}
        out_q: queue.Queue = queue.Queue(maxsize=self._n_slots)
        stop = threading.Event()
        errors: list[BaseException] = []
        clean_end = []
        SENTINEL = object()

        ring_batches_m, ring_bytes_m, slot_wait_m, consumer_wait_m = (
            _ring_metrics())

        def acquire_write():
            idx = ring.acquire_write(timeout_s=0.0)
            if idx is None:
                # no free slot: the transfer/compute side is behind —
                # meter the stall so it shows in /metrics next to
                # prefetch producer blocking
                blocked_from = time.monotonic()
                while idx is None and not stop.is_set():
                    idx = ring.acquire_write(timeout_s=0.1)
                slot_wait_m.inc(time.monotonic() - blocked_from)
            return idx

        def packer():
            exhausted = False  # the source ended (not a stop)
            try:
                for raw in self._chain(first, it):
                    batch = as_struct(raw) if raw is not first else first
                    total = 0
                    for k in keys:
                        if batch[k].nbytes > seg[k]:
                            raise ValueError(
                                f"feed {k!r} of {batch[k].nbytes}B exceeds "
                                f"its slot segment {seg[k]}B. Segments are "
                                "fixed up front (from max_batch_bytes, "
                                "else the FIRST batch's bytes), so no "
                                "later batch may be larger — size "
                                "max_batch_bytes for the largest batch, "
                                "or for variable-sized rows use the "
                                "Python feed path (ragged_rows=True on "
                                "BatchedRunner feeds)."
                            )
                        total += batch[k].nbytes
                    idx = acquire_write()
                    if idx is None:
                        return
                    view = ring.slot_view(idx)
                    with tracing.span("ring.copy", bytes=total):
                        for k in keys:
                            o = offsets[k]
                            view[o:o + batch[k].nbytes] = (
                                batch[k].view(np.uint8).reshape(-1))
                    meta[idx] = {
                        k: (batch[k].shape, batch[k].dtype) for k in keys
                    }
                    ring.commit_write(
                        idx, batch[keys[0]].shape[0],
                        offsets[keys[-1]] + batch[keys[-1]].nbytes,
                    )
                    FEED_STATS["ring_batches"] += 1
                    FEED_STATS["ring_bytes"] += total
                    ring_batches_m.inc()
                    ring_bytes_m.inc(total)
                exhausted = True
            except BaseException as e:
                errors.append(e)
            finally:
                # end of stream: a committed slot without meta, so the
                # ring stays open and may serve the next stream (close()
                # would end it for good); closed when the packer failed
                # or the consumer stopped, also if the stop came while
                # acquire_write was waiting for the end slot (that slot
                # would mark an abandoned stream clean)
                idx = acquire_write() if exhausted else None
                if idx is None or stop.is_set():
                    ring.close()
                else:
                    ring.commit_write(idx, 0, 0)

        def transferrer():
            try:
                while not stop.is_set():
                    idx = ring.acquire_read(timeout_s=0.1)
                    if idx is None:
                        if ring.closed:
                            break
                        continue
                    m = meta.pop(idx, None)
                    if m is None:  # the end-of-stream slot
                        ring.release_read(idx)
                        clean_end.append(True)
                        break
                    if to_card:
                        _pin_slot(ring, idx)
                    view = ring.slot_view(idx)
                    host = {}
                    for k in keys:
                        shape, dtype = m[k]
                        nbytes = int(np.prod(shape)) * dtype.itemsize
                        o = offsets[k]
                        host[k] = view[o:o + nbytes].view(dtype).reshape(shape)
                    if not to_card:
                        host = {k: np.array(v, copy=True)
                                for k, v in host.items()}
                    arr = transfer(unwrap(host))
                    if not to_card and any(
                            isinstance(l, torch.Tensor) and l.is_cuda
                            for l in tree_leaves(arr)):
                        # an opaque transfer onto the card: the slot must
                        # stay stable until its copy is done
                        torch.cuda.synchronize()
                    ring.release_read(idx)
                    while not stop.is_set():
                        try:
                            out_q.put(arr, timeout=0.1)
                            break
                        except queue.Full:
                            continue
            except BaseException as e:
                errors.append(e)
            finally:
                # Blocking put: the consumer is draining the queue, so this
                # succeeds; if the consumer abandoned (stop set), give up —
                # never steal queued results to make room.
                while True:
                    try:
                        out_q.put(SENTINEL, timeout=0.1)
                        break
                    except queue.Full:
                        if stop.is_set():
                            break

        t1 = threading.Thread(target=packer, daemon=True,
                              name="sparkdl-ring-pack")
        t2 = threading.Thread(target=transferrer, daemon=True,
                              name="sparkdl-ring-transfer")
        t1.start()
        t2.start()
        try:
            while True:
                t_wait = time.monotonic()
                item = out_q.get()
                # consumer blocked on the feed = infeed starvation, the
                # ring-path twin of sparkdl_prefetch_consumer_wait_seconds
                consumer_wait_m.observe(time.monotonic() - t_wait)
                if item is SENTINEL:
                    if errors:
                        raise errors[0]
                    return
                yield item
        finally:
            stop.set()
            t1.join(timeout=5)
            t2.join(timeout=5)
            if (clean_end and not errors and not t1.is_alive()
                    and not t2.is_alive()):
                _give_back(ring)
            else:
                ring.close()
                t1.join(timeout=5)
                t2.join(timeout=5)
                _destroy(ring)

    @staticmethod
    def _chain(first, rest):
        yield first
        yield from rest
