"""Block-paged KV allocation for continuous GPT serving.

The dense continuous engine holds one ``[layers, n_slots, max_len, H, D]``
cache, so its memory contract is ``n_slots x max_len`` worst-case columns
whether or not tokens exist. This module is the host-side half of the
paged layout: the device holds one
``[layers, n_blocks, block_size, H, D]`` pool
(:func:`~sparkdl_torch.models.gpt.init_block_pool`), each serving slot maps
its logical columns onto pool blocks through a per-slot block table, and
THIS class owns the free list and refcounts — so

* capacity is bounded by live tokens (``blocks_used x block_size``), not
  by ``n_slots x max_len``;
* a physical block can back many slots at once (refcounted — how
  :mod:`~sparkdl_torch.serving.prefix_cache` shares prompt prefixes);
* admission against an exhausted pool *defers* (the engine re-queues the
  request and retries as slots retire) instead of erroring.

Bookkeeping is plain Python under the engine lock — allocation is a
host-side scheduling decision, never device work. The pool publishes
``sparkdl_kv_blocks_total`` / ``sparkdl_kv_blocks_used`` /
``sparkdl_kv_blocks_spare`` gauges as delta contributions (several
pools may live in one process; each adds its share instead of
clobbering the others — the RequestQueue depth pattern) and carries the
``kv.alloc`` fault site so the chaos harness can simulate exhaustion
deterministically.

Elastic capacity: :meth:`~KVBlockPool.shrink` parks free
blocks as *spare* (non-allocatable) capacity and
:meth:`~KVBlockPool.grow` returns them to service — the autoscaler's
KV actuator, riding the ``kv_pool.resize`` fault site. Spare is pure
host-side admission bookkeeping (the device pool array never moves);
shrink refuses to cut the free list below the worst single-admission
need ever recorded by :meth:`~KVBlockPool.record_deferral`, so parked
capacity can never starve the largest request the pool has seen.

Quantized layouts: the pool's DEVICE storage
(:func:`~sparkdl_torch.models.gpt.init_block_pool`) can hold blocks in
``bf16`` or ``int8`` (one fp32 scale per written column) instead of the
compute dtype — :data:`KV_DTYPES`. This class stays dtype-agnostic
bookkeeping; it records the layout for observability
(``sparkdl_kv_pool_dtype{dtype=...}`` counts live pools per layout) and
:func:`kv_bytes_per_token` / :func:`kv_capacity_ratio` give the sizing
arithmetic benches and admission math share: int8 fits 2-4x the live
tokens of fp32 in the same pool bytes, which is directly more
concurrent users per chip.
"""

from __future__ import annotations

import collections
from typing import Iterable, Optional

from sparkdl_torch.observability.registry import GaugeShare, registry

_M_TOTAL = registry().gauge(
    "sparkdl_kv_blocks_total",
    "KV pool capacity in blocks, all pools")
_M_USED = registry().gauge(
    "sparkdl_kv_blocks_used",
    "allocated KV blocks (live slots + cached prefixes), all pools")
_M_DEFERRED = registry().counter(
    "sparkdl_kv_admission_deferred_total",
    "admissions re-queued because the KV block pool was exhausted")
_M_SPARE = registry().gauge(
    "sparkdl_kv_blocks_spare",
    "KV blocks parked as spare (non-allocatable) capacity by the "
    "autoscaler, all pools")
_M_DTYPE = registry().gauge(
    "sparkdl_kv_pool_dtype",
    "live KV block pools by storage layout", labels=("dtype",))

#: Supported pool storage layouts: "fp32" stores at the model's compute
#: dtype (exact, the default), "bf16"/"int8" compress the resident pool
#: (compute still runs at the model dtype; see models.gpt.quantize_kv).
KV_DTYPES = ("fp32", "bf16", "int8")

_KV_ITEMSIZE = {"bf16": 2, "int8": 1}


def kv_bytes_per_token(config, dtype: str = "fp32") -> int:
    """Resident pool bytes one cached token costs under ``dtype``:
    K + V columns across every layer, plus (int8) the two per-column
    fp32 scales. Pure arithmetic — the number benches assert capacity
    ratios with and operators size pools by. The ``"fp32"`` layout
    stores at the MODEL's compute dtype (``config.dtype``, usually
    float32), so a bf16-compute model honestly reports the native
    layout at 2 bytes/element — and near-zero gain from the "bf16"
    layout."""
    import torch

    if dtype not in KV_DTYPES:
        raise ValueError(
            f"unknown KV dtype {dtype!r} (one of {KV_DTYPES})")
    item = (torch.empty((), dtype=config.dtype).element_size()
            if dtype == "fp32" else _KV_ITEMSIZE[dtype])
    hd = config.hidden_size // config.num_heads
    per_layer = 2 * config.num_heads * hd * item
    if dtype == "int8":
        per_layer += 2 * 4  # k_scale + v_scale, fp32, one per column
    return config.num_layers * per_layer


def kv_capacity_ratio(config, dtype: str) -> float:
    """How many live tokens ``dtype`` fits per NATIVE-layout token in
    the same pool bytes (>= 2.0 for int8 at every real model width
    when compute is float32; ~2x from bf16 compute)."""
    return (kv_bytes_per_token(config, "fp32")
            / kv_bytes_per_token(config, dtype))


class KVBlockPool:
    """Free list + refcounts over ``n_blocks`` physical KV blocks.

    ``allocate`` hands out refcount-1 block ids (or None — the caller
    defers); ``ref``/``deref`` track sharing; a block whose refcount
    hits zero is NOT auto-freed — the caller (the prefix cache) decides
    whether it goes back to the free list (:meth:`release`) or stays
    resident as an evictable cached prefix. ``sentinel`` (== n_blocks,
    one past the last valid id) marks empty block-table entries: the
    device-side gather clips it and the scatter drops it, so an
    unoccupied table entry can never read or corrupt a live block.
    """

    def __init__(self, n_blocks: int, block_size: int,
                 dtype: str = "fp32"):
        if n_blocks < 1:
            raise ValueError(f"n_blocks must be >= 1, got {n_blocks}")
        if block_size < 1:
            raise ValueError(
                f"block_size must be >= 1, got {block_size}")
        if dtype not in KV_DTYPES:
            raise ValueError(
                f"unknown KV dtype {dtype!r} (one of {KV_DTYPES})")
        self.n_blocks = n_blocks
        self.block_size = block_size
        self.dtype = dtype
        self._free: "collections.deque[int]" = collections.deque(
            range(n_blocks))
        self._is_free = [True] * n_blocks
        self._ref = [0] * n_blocks
        #: high-water mark of :attr:`used_count` — the number that sizes
        #: a pool (end-of-run used_count has already fallen back to the
        #: cached-prefix residual)
        self.used_peak = 0
        #: consecutive deferrals (:meth:`record_deferral`) with no
        #: intervening recovery — the signal /healthz reads as degraded.
        #: A :meth:`release` that frees ENOUGH blocks to cover the
        #: deferred need clears it (the pressure is over the moment
        #: capacity exists, not only at the next successful admission),
        #: as does the engine on admission.
        self.deferral_streak = 0
        #: worst-case blocks the most recent deferral was short — the
        #: bar a release must clear to end the episode (1 when the
        #: caller never said: any free block counts)
        self._deferred_need = 1
        #: worst-case single-admission need EVER recorded — the floor
        #: :meth:`shrink` must keep free (spare capacity can
        #: never starve the largest request this pool has seen defer)
        self.need_peak = 1
        #: blocks parked as spare capacity by the autoscaler: off the
        #: free list, never allocatable, not "used" either — grow()
        #: returns them to service (the device pool array is untouched;
        #: spare is host-side admission bookkeeping)
        self._spare: "list[int]" = []
        #: free blocks the host tier expects to claim for unparks
        #:: parked sessions resume with one block
        #: allocation per parked block, so :meth:`shrink` must leave
        #: this many free on top of :attr:`need_peak` or scale-down
        #: strands resumes behind re-prefills. Maintained by the
        #: engine under its lock (0 when tiering is off).
        self.unpark_reserved = 0
        self._closed = False
        self._g_total = GaugeShare(_M_TOTAL)
        self._g_used = GaugeShare(_M_USED)
        self._g_spare = GaugeShare(_M_SPARE)
        self._g_dtype = GaugeShare(_M_DTYPE.labels(dtype=dtype))
        self._g_total.set(n_blocks)
        self._g_used.set(0)
        self._g_spare.set(0)
        self._g_dtype.set(1)

    # -- introspection -------------------------------------------------------
    @property
    def sentinel(self) -> int:
        """Block-table id meaning "no block": gather clips, scatter drops."""
        return self.n_blocks

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def spare_count(self) -> int:
        """Blocks parked out of service by the autoscaler."""
        return len(self._spare)

    @property
    def serving_count(self) -> int:
        """Blocks in service (allocatable or allocated): physical
        capacity minus spare."""
        return self.n_blocks - len(self._spare)

    @property
    def used_count(self) -> int:
        """Blocks holding data: live slots + cached prefixes (spare
        blocks are neither free nor used)."""
        return self.n_blocks - self.free_count - len(self._spare)

    def refcount(self, block_id: int) -> int:
        return self._ref[block_id]

    # -- allocation ----------------------------------------------------------
    def allocate(self, n: int) -> "Optional[list[int]]":
        """Pop ``n`` blocks at refcount 1, or None when the free list is
        short (the caller defers — pool exhaustion is backpressure, not
        an error). ``kv.alloc`` is a fault site: an armed plan makes
        exhaustion injectable for the chaos harness."""
        from sparkdl_torch.reliability.faults import fault_point

        fault_point("kv.alloc")
        if n < 0:
            raise ValueError(f"cannot allocate {n} blocks")
        if n > self.free_count:
            return None
        out = [self._pop_block() for _ in range(n)]
        for bid in out:
            self._ref[bid] = 1
            self._is_free[bid] = False
        self._update_gauges()
        return out

    def _pop_block(self) -> int:
        """Take one free block (subclass hook, the mirror of
        :meth:`_free_block` — the sharded pool pops round-robin across
        its shard stripes). Only called with ``free_count`` cover."""
        return self._free.popleft()

    def ref(self, block_ids: Iterable[int]) -> None:
        """Add one reference per id. Refcount 0 is legal here — that is
        a CACHED block (off the free list, trie-registered) being
        resurrected by a prefix match; only free-list blocks reject."""
        for bid in block_ids:
            if self._is_free[bid]:
                raise RuntimeError(
                    f"ref of free block {bid}: allocator bookkeeping "
                    "corrupt"
                )
            self._ref[bid] += 1

    def deref(self, block_ids: Iterable[int]) -> "list[int]":
        """Drop one reference per id; returns the ids that hit zero (the
        caller frees or keeps them as cached prefixes)."""
        zeroed = []
        for bid in block_ids:
            if self._ref[bid] < 1:
                raise RuntimeError(
                    f"deref of free block {bid}: double release"
                )
            self._ref[bid] -= 1
            if self._ref[bid] == 0:
                zeroed.append(bid)
        return zeroed

    def release(self, block_ids: Iterable[int]) -> None:
        """Return refcount-0 blocks to the free list. Freeing enough
        capacity to cover the deferred need ends the exhaustion
        episode: the deferral streak resets HERE, so /healthz degraded
        state self-clears the moment a retiring slot makes the pool
        healthy again — not only when the next admission succeeds (an
        idle engine with no queued work would otherwise read degraded
        forever). A free that does NOT cover the need keeps the streak:
        a large request starving behind small-block churn must still
        read degraded and still reach its postmortem trigger."""
        freed = 0
        for bid in block_ids:
            if self._ref[bid] != 0:
                raise RuntimeError(
                    f"release of block {bid} at refcount "
                    f"{self._ref[bid]}: still referenced"
                )
            if self._is_free[bid]:
                raise RuntimeError(f"double free of block {bid}")
            self._free_block(bid)
            self._is_free[bid] = True
            freed += 1
        if freed and self.free_count >= self._deferred_need:
            self.deferral_streak = 0
        self._update_gauges()

    def _free_block(self, bid: int) -> None:
        """Return one block to the free structure (subclass hook —
        the sharded pool files it under its shard's stripe)."""
        self._free.append(bid)

    def record_deferral(self, need: "int | None" = None) -> None:
        """Count one deferral; ``need`` is the worst-case block count
        the deferred admission was asking for (sets the recovery bar
        :meth:`release` must clear)."""
        _M_DEFERRED.inc()
        self.deferral_streak += 1
        if need is not None:
            self._deferred_need = max(1, need)
            self.need_peak = max(self.need_peak, self._deferred_need)

    def reset_deferral_streak(self) -> None:
        """An admission succeeded (or the queue drained past the
        pressure): the exhaustion episode is over."""
        self.deferral_streak = 0

    # -- serving <-> spare resize (the autoscaler's actuator) ------
    def grow(self, n: int) -> int:
        """Return up to ``n`` spare blocks to the serving free list
        (scale-up on deferral streaks). Returns the blocks actually
        moved. The caller holds whatever lock guards allocation (the
        engine lock) — same single-owner contract as every other
        method here. ``kv_pool.resize`` is a fault site: an injected
        fault aborts the move before any bookkeeping changes, so the
        autoscaler defers the decision."""
        from sparkdl_torch.reliability.faults import fault_point

        fault_point("kv_pool.resize")
        if n < 0:
            raise ValueError(f"cannot grow by {n} blocks")
        moved = min(n, len(self._spare))
        for _ in range(moved):
            self._return_spare_block(self._spare.pop())
        if moved and self.free_count >= self._deferred_need:
            # capacity now covers the deferred need: the exhaustion
            # episode ends exactly as a covering release() would end it
            self.deferral_streak = 0
        self._update_gauges()
        return moved

    def shrink(self, n: int) -> int:
        """Park up to ``n`` FREE blocks as spare capacity (scale-down).
        Guard: the free list is never shrunk below the worst
        single-admission need this pool ever recorded
        (:attr:`need_peak`, fed by :meth:`record_deferral`) *plus* the
        host tier's :attr:`unpark_reserved` — spare capacity must not
        manufacture the exhaustion it exists to absorb, nor strand a
        parked session's resume behind a re-prefill. Returns the
        blocks actually moved (possibly 0)."""
        from sparkdl_torch.reliability.faults import fault_point

        fault_point("kv_pool.resize")
        if n < 0:
            raise ValueError(f"cannot shrink by {n} blocks")
        allowance = (self.free_count
                     - max(self._deferred_need, self.need_peak)
                     - self.unpark_reserved)
        moved = max(0, min(n, allowance))
        for _ in range(moved):
            self._spare.append(self._take_free_block())
        self._update_gauges()
        return moved

    def _take_free_block(self) -> int:
        """Remove one block from the free structure for parking
        (subclass hook, mirror of :meth:`_return_spare_block`). Only
        called with ``free_count`` cover."""
        return self._free.pop()

    def _return_spare_block(self, bid: int) -> None:
        """Put one parked block back on the free structure (subclass
        hook). Unlike :meth:`_free_block` this must NOT touch used
        accounting — a spare block was never used."""
        self._free.append(bid)

    def _update_gauges(self) -> None:
        used = self.used_count
        if used > self.used_peak:
            self.used_peak = used
        self._g_used.set(used)
        # re-assert capacity + dtype too: a registry().reset() mid-life
        # (test isolation) zeroes the gauges, and values only pushed at
        # construction would stay 0 while used recovers
        self._g_total.set(0 if self._closed else self.n_blocks)
        self._g_spare.set(0 if self._closed else len(self._spare))
        self._g_dtype.set(0 if self._closed else 1)

    def close(self) -> None:
        """Retract this pool's gauge contributions (idempotent)."""
        if self._closed:
            return
        self._closed = True
        self._g_total.set(0)
        self._g_used.set(0)
        self._g_spare.set(0)
        self._g_dtype.set(0)

