"""Continuous batching for GPT decode: rows join and leave mid-stream.

The port of ``sparkdl_tpu.serving.continuous``. The lockstep ``generate``
path (models/gpt.py) starts a batch together and ends it together, so one
long row holds every slot hostage. This engine keeps ONE persistent
decode batch of ``n_slots`` rows over a per-slot KV cache (``idx`` per
row, a device tensor):

- a finished row frees its slot immediately;
- a newly admitted prompt is prefilled alone and its K/V land in the
  free slot — the in-flight neighbours never notice;
- every engine tick advances all live rows in one device program whose
  per-row causal mask lets each row decode at its own depth.

Token identity: greedy tokens of every request equal its unbatched
``generate`` decode (tests/test_torch_continuous.py against the JAX
engine; ``chip_smoke.py`` ``[serve]`` against ``generate`` on the card).
Decode is greedy (temperature 0), the deterministic serving default.

KV layouts (``kv_layout=``):

- ``"paged"`` (default) — a block-paged KV pool
  (:func:`~sparkdl_torch.models.gpt.init_block_pool`, bookkeeping in
  :mod:`~sparkdl_torch.serving.kv_blocks`): each slot maps its columns
  onto refcounted ``block_size``-token blocks through a block table; a
  decode step gathers a virtual dense cache from the table, runs the
  per-slot step on it and scatters the written column back. Admission
  against an exhausted pool DEFERS instead of erroring. Prompts are
  prefilled right-aligned in bounded chunks (``prefill_chunk`` tokens a
  tick), and a radix prefix cache (:mod:`~sparkdl_torch.serving.
  prefix_cache`) lets a request reuse the K/V of its longest cached
  prompt prefix (a partial tail block shared copy-on-write).
- ``"dense"`` — one dense buffer per slot, the parity oracle.

Speculative decoding (``spec_k=``): a draft source
(:mod:`~sparkdl_torch.serving.spec_decode`) proposes up to ``k-1``
tokens per live slot and ONE verify program scores the whole span (the
L=k per-slot step); greedy acceptance keeps tokens identical to plain
decode. Quantized KV blocks (``kv_dtype=``): the pool may store
``"bf16"`` or ``"int8"`` (one fp32 scale per written column), quantized
on scatter and dequantized on gather; compute stays at the model dtype.

Device programs. The reference's jitted programs, which donate the pool,
are torch functions here that write the pool IN PLACE: ``_q_write`` /
``_dq_gather`` (the dtype boundary), ``_paged_step`` (k chained decode
steps), ``_paged_verify``, the four chunk programs ``_chunk_one`` /
``_chunk_first`` / ``_chunk_mid`` / ``_chunk_final``, and the dense
``_prefill`` (its scatter into the slot fused) / ``_step`` /
``_step_chain``. On the card each is one CUDA graph per static key
(``k``, ``nb``, chunk width, ``cols``, prompt bucket) through
:class:`~sparkdl_torch.runtime.dispatch.GraphCache`: every value that
changes from tick to tick (block tables, ``idx``, chunk starts, last
tokens, drafts, gather and install ids) is a graph INPUT, copied into
the graph's static buffers before each replay, never a captured
constant. The pool, the per-slot cache and the weights are the state
the graphs read and write at fixed addresses. A failed capture or step
raises; nothing falls back to eager execution.

Sentinels. JAX clips an out-of-range gather index and drops an
out-of-range scatter; a torch index out of range is a device-side assert.
So the device pool holds one SCRATCH block past the last real one, at
the sentinel id ``kv_blocks``: empty table entries gather it (garbage
the causal mask hides) and sentinel writes land in it, never in a real
block. Per-slot writes past a dense buffer are dropped by
:func:`~sparkdl_torch.models.gpt.write_columns`.

Tiered KV (``host_kv_blocks``, ``disk_kv_blocks``, ``kv_spill_dir``):
cold cached blocks page out to host DRAM and on to disk
(:mod:`~sparkdl_torch.serving.kv_tiers`) instead of being evicted, and a
returning session's next turn pages them back in before its prefix
match. A park reads a block's RAW storage bytes (int8 codes and their
scales, bf16 bit patterns; never a dequantized copy) with an async
device-to-host copy on the engine's stream, behind the program that last
wrote it; an unpark writes those bytes back into a freshly allocated
block in place — the pool tensors the graphs read never move — so a
resumed turn is bitwise the turn that never parked. Parked sessions
migrate between engines through :meth:`export_parked_sessions` /
:meth:`import_parked_sessions` (the raw codec of
:mod:`~sparkdl_torch.serving.kv_codec`). A torn park (``kv.park``
fault) evicts instead, a corrupt unpark (``kv.unpark``) prunes and
re-prefills: both counted (``_park_fallbacks``,
``sparkdl_kv_park_fallbacks_total``), and no request is lost. The
scratch block at the sentinel id is never registered, so it never parks.

Not ported yet, and raising where asked for: sequence-parallel prefill
(``sp`` > 1, ROADMAP A8).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from concurrent.futures import Future
from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F

from sparkdl_torch.observability import flight as flight_mod
from sparkdl_torch.observability import slo as slo_mod
from sparkdl_torch.observability import tracing
from sparkdl_torch.observability.registry import registry
from sparkdl_torch.observability.tracing import span
from sparkdl_torch.reliability.faults import fault_point
from sparkdl_torch.runtime.completion import start_fetch
from sparkdl_torch.runtime.dispatch import (
    ChainPolicy,
    GraphCache,
    SpecPolicy,
    record_dispatch,
    storage_key,
)
from sparkdl_torch.serving import tenancy
from sparkdl_torch.serving.metrics import ServingMetrics
from sparkdl_torch.serving.queue import (
    DeadlineExceededError,
    EngineClosedError,
    Request,
    RequestQueue,
    record_request_failure,
)

_M_PREFILL_CHUNKS = registry().counter(
    "sparkdl_prefill_chunks_total",
    "bounded prefill chunks dispatched by continuous GPT engines")

_M_SPEC_PROPOSED = registry().counter(
    "sparkdl_spec_proposed_total",
    "draft tokens proposed to speculative verify dispatches")
_M_SPEC_ACCEPTED = registry().counter(
    "sparkdl_spec_accepted_total",
    "proposed draft tokens accepted by greedy verify (each one a "
    "decode dispatch never issued)")
_M_SPEC_RATE = registry().gauge(
    "sparkdl_spec_acceptance_rate",
    "cumulative accepted/proposed draft share across this process's "
    "speculative engines")
_M_SPEC_FALLBACKS = registry().counter(
    "sparkdl_spec_fallbacks_total",
    "speculative verify dispatches abandoned to plain decode "
    "(spec.verify fault site)")

#: Process-wide propose/accept totals behind the acceptance-rate gauge.
#: Several engines contribute from their own loop threads — their
#: engine locks are DIFFERENT locks, so this shared state needs its own.
_SPEC_TOTALS = {"proposed": 0, "accepted": 0}
_SPEC_TOTALS_LOCK = threading.Lock()

#: Consecutive pool-exhaustion deferrals before the flight recorder
#: writes a postmortem (one defer is normal backpressure; a streak is
#: the incident an operator will ask about).
_EXHAUST_DUMP_STREAK = 3

#: Seconds between brownout-controller evaluations fed by the engine
#: tick: the ladder's hysteresis counts these evaluations, so the
#: stride — not the tick rate — sets its reaction time.
_OVERLOAD_STRIDE_S = 0.25

#: CUDA graphs an engine keeps: (k, nb) decode and verify programs,
#: (width, cols) chunk programs and dense prompt buckets.
_MAX_GRAPHS = 96

_NOT_PORTED = "is not ported to sparkdl_torch yet (ROADMAP {item})"


@dataclasses.dataclass
class GenRequest:
    """One generation request: prompt token ids + token budget."""

    prompt: np.ndarray
    max_new_tokens: int


@dataclasses.dataclass
class _InFlight:
    """Host-side state of one occupied slot (the left-pad count lives in
    the engine's ``_start`` array the dense decode step consumes;
    ``blocks`` are the paged layout's refcounted KV blocks, released on
    retire)."""

    req: Request
    produced: list[int]
    max_new: int
    blocks: "list[int] | None" = None
    #: prompt ids (paged layout): the draft proposer's context is
    #: prompt + produced — ids only, never device state
    prompt: "np.ndarray | None" = None


@dataclasses.dataclass
class _Prefill:
    """One slot mid-chunked-prefill (paged layout): the prompt's K/V
    accumulate in a private batch-1 dense cache (``ck``/``cv``),
    ``prefill_chunk`` tokens per engine tick, until installation into
    the slot's pool blocks. ``pos`` counts prompt tokens already in the
    cache, including the ``hit`` tokens gathered from the prefix cache
    (whose prefill was skipped)."""

    req: Request
    prompt: np.ndarray
    max_new: int
    pos: int
    hit: int
    shared: "list[int]"
    owned: "list[int]"
    gather_ids: np.ndarray  # block ids backing the cached prefix
    install_ids: np.ndarray  # owned-block targets for the final chunk
    #: COW source (a shared partial tail block): holds an extra pool
    #: reference until the first chunk's gather has been enqueued
    cow_block: "int | None" = None
    ck: Any = None  # None until the first (gather-fused) chunk ran
    cv: Any = None
    chunks: int = 0

    def all_blocks(self) -> "list[int]":
        """Every pool reference this prefill holds (release on abort)."""
        return (self.shared + self.owned
                + ([self.cow_block] if self.cow_block is not None
                   else []))


def _engine_model(config, model, device):
    """The module the engine runs: ``model`` itself (a
    ``GPTLMHeadModel``: the engine runs on its device), or one built on
    ``device`` from a state dict."""
    from sparkdl_torch.models.gpt import GPTLMHeadModel
    from sparkdl_torch.ops._dispatch import resolve_device

    if isinstance(model, torch.nn.Module):
        if model.config != config:
            raise ValueError("the model's config differs from config")
        dev = next(model.parameters()).device
        if device is not None and resolve_device(device) != dev:
            raise ValueError(
                f"device={device!r} but the model lives on {dev}")
        return model.eval()
    module = GPTLMHeadModel(config, device=device if device is not None
                            else "cuda")
    module.load_state_dict(model)
    return module.eval()


class ContinuousGPTEngine:
    """Async continuous-batching GPT server.

    ``model``: the port's ``GPTLMHeadModel`` (the engine runs on its
    device) or its state dict (built on ``device``, default ``"cuda"``,
    which raises without CUDA). ``submit(prompt_ids, max_new_tokens)``
    returns a Future of the generated ids (prompt not included).
    Admission control is two-layer: queue depth (QueueFullError) and
    cache capacity. Under ``kv_layout="dense"`` a request whose BUCKETED
    prompt + budget cannot fit ``max_len`` columns is rejected at submit.
    Under the default ``"paged"`` layout only what can NEVER fit rejects
    (raw prompt + budget vs ``max_len``, worst-case blocks vs the whole
    pool); a request that merely cannot fit right now is admitted and
    DEFERRED at tick time — re-queued at the head, retried as slots
    retire. ``kv_block_size``/``kv_blocks`` size the paged pool
    (default: the dense worst case, so the default engine never defers
    where dense admitted); ``prefill_chunk`` bounds the prompt tokens
    prefilled per tick (pin via arg or ``SPARKDL_TORCH_PREFILL_CHUNK``).

    ``auto_start=False`` exposes :meth:`tick` for deterministic
    single-step tests; the default runs the loop on a daemon thread.

    ``chain_tokens`` fuses up to k decode steps into ONE device program
    (one CUDA graph of k steps on the card); k is re-bounded every tick
    by the smallest remaining token budget in flight and by the
    tightest in-flight deadline over the measured per-token time.
    Greedy tokens are identical at any k. None = auto from the dispatch
    gap; 1 (default) = one token per program.

    ``spec_k`` (paged layout) turns on speculative decoding with up to
    ``spec_k - 1`` drafts per slot from ``draft_source`` (default
    radix-trie + n-gram); the verify width shrinks under the same
    budget/deadline caps as ``chain_tokens`` plus the measured
    acceptance rate. ``kv_dtype`` ("fp32" | "bf16" | "int8") picks the
    paged pool's storage layout.

    ``host_kv_blocks`` (paged layout) parks cold blocks in a host-DRAM
    tier of that many blocks instead of evicting them; ``disk_kv_blocks``
    adds a disk tier below it, spilling into ``kv_spill_dir`` (a temporary
    directory by default, removed at close).
    """

    def __init__(self, config, model, *, device=None, n_slots: int = 8,
                 max_len: int = 512, max_queue_depth: int = 256,
                 eos_id: Optional[int] = None,
                 idle_wait_s: float = 0.005,
                 chain_tokens: "int | None" = 1,
                 kv_layout: str = "paged",
                 kv_block_size: int = 16,
                 kv_blocks: "int | None" = None,
                 prefill_chunk: "int | None" = None,
                 sp: "int | None" = None,
                 spec_k: "int | None" = None,
                 draft_source: Any = None,
                 kv_dtype: str = "fp32",
                 host_kv_blocks: "int | None" = None,
                 disk_kv_blocks: "int | None" = None,
                 kv_spill_dir: "str | None" = None,
                 metrics: ServingMetrics | None = None,
                 slo: "slo_mod.SLO | None" = None,
                 tenants: "tenancy.TenantRegistry | None" = None,
                 host_id: "str | None" = None,
                 auto_start: bool = True):
        from sparkdl_torch.ingest.pipeline import resolve_pin
        from sparkdl_torch.runtime.batching import default_buckets
        from sparkdl_torch.serving.kv_blocks import KV_DTYPES
        from sparkdl_torch.serving.metrics import default_host_id

        if n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {n_slots}")
        if chain_tokens is not None and chain_tokens < 1:
            raise ValueError(
                f"chain_tokens must be >= 1, got {chain_tokens}"
            )
        if kv_layout not in ("paged", "dense"):
            raise ValueError(
                f"kv_layout must be 'paged' or 'dense', got {kv_layout!r}"
            )
        if spec_k is not None and spec_k < 2:
            raise ValueError(
                f"spec_k must be >= 2 (one draft + its verify), got "
                f"{spec_k}; None disables speculative decoding"
            )
        if kv_dtype not in KV_DTYPES:
            raise ValueError(
                f"unknown KV pool dtype {kv_dtype!r} (fp32 | bf16 | int8)")
        if kv_layout != "paged" and (spec_k is not None
                                     or kv_dtype != "fp32"):
            raise ValueError(
                "speculative decoding (spec_k) and quantized KV pools "
                "(kv_dtype) require kv_layout='paged'; the dense layout "
                "is the exact parity oracle"
            )
        if kv_layout != "paged" and host_kv_blocks is not None:
            raise ValueError(
                "tiered KV (host_kv_blocks) requires kv_layout='paged': "
                "parking pages pool blocks, and the dense layout has "
                "no block pool"
            )
        if disk_kv_blocks is not None and host_kv_blocks is None:
            raise ValueError(
                "disk_kv_blocks requires host_kv_blocks: the disk tier "
                "sits below the host tier (blocks spill host->disk, "
                "never device->disk directly)"
            )
        if host_kv_blocks is not None and host_kv_blocks < 1:
            raise ValueError(
                f"host_kv_blocks must be >= 1, got {host_kv_blocks}")
        if disk_kv_blocks is not None and disk_kv_blocks < 0:
            raise ValueError(
                f"disk_kv_blocks must be >= 0, got {disk_kv_blocks}")
        if sp is not None and sp < 1:
            raise ValueError(f"sp must be >= 1, got {sp}")
        sp_val, _, _ = resolve_pin(sp, "SPARKDL_TORCH_SP", 1, what="sp")
        if sp_val > 1:
            raise NotImplementedError(
                "sequence-parallel prefill (sp > 1) "
                + _NOT_PORTED.format(item="A8"))
        if (config.positions == "learned"
                and max_len > config.max_seq_len):
            raise ValueError(
                f"max_len {max_len} exceeds the learned position table "
                f"(max_seq_len={config.max_seq_len})"
            )

        self.config = config
        self._model = _engine_model(config, model, device)
        self.device = next(self._model.parameters()).device
        #: stable host identity: snapshot()/capacity are keyed by it
        self.host_id = host_id if host_id is not None else default_host_id()
        self.n_slots = n_slots
        self.max_len = max_len
        self.eos_id = eos_id
        self.idle_wait_s = idle_wait_s
        self.chain_tokens = chain_tokens
        self.kv_layout = kv_layout
        self.spec_k = spec_k
        self.kv_dtype = kv_dtype
        self.sp = 1
        self._spec_policy = (SpecPolicy(max_k=spec_k)
                             if spec_k is not None else None)
        self._spec_dispatches = 0
        self._spec_proposed = 0
        self._spec_accepted = 0
        self._spec_tokens = 0
        self._spec_fallbacks = 0
        self._chain_policy = ChainPolicy(
            max_chain=chain_tokens if chain_tokens is not None else 32
        )
        if chain_tokens is None:
            # auto mode reads the gap per tick: calibrate once here,
            # outside the engine lock, never inside the decode loop
            self._chain_policy.gap()
        self.queue = RequestQueue(max_depth=max_queue_depth,
                                  tenants=tenants)
        #: next monotonic stamp the tick feeds the process brownout
        #: controller (bounded evaluation stride, not per-tick)
        self._overload_next = 0.0
        self.metrics = metrics if metrics is not None else ServingMetrics()
        #: the device programs as CUDA graphs (on the card; eager on CPU)
        self.graphs = GraphCache("serving.continuous", maxsize=_MAX_GRAPHS)
        self._graphed = self.device.type == "cuda"
        self._len_buckets = default_buckets(max_len, min_bucket=8)
        self._inflight: dict[int, _InFlight] = {}
        self._prefilling: dict[int, _Prefill] = {}
        self._last_tok = np.zeros((n_slots,), np.int64)
        self._prefill_seconds = 0.0
        self._prefill_chunks = 0
        self._deferrals = 0
        #: host/disk tier store for parked cold sessions; None = flat
        #: single-tier cache (the default)
        self._kv_tiers = None
        self._park_fallbacks = 0
        self._max_tick_prefill_tokens = 0
        self._prefill_rr = 0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

        if kv_layout == "paged":
            self._init_paged(kv_block_size, kv_blocks, prefill_chunk,
                             draft_source, resolve_pin, host_kv_blocks,
                             disk_kv_blocks, kv_spill_dir)
        else:
            from sparkdl_torch.models.gpt import init_cache

            self._cache = init_cache(config, n_slots, max_len,
                                     per_slot=True, device=self.device)
            self._start = np.zeros((n_slots,), np.int64)
        # process-wide registrations go LAST: a constructor failure above
        # (bad config, cache allocation) must not leak a tracker/provider
        # bound to a half-built engine
        from sparkdl_torch.serving.metrics import EngineObservability

        self._obs = EngineObservability(
            "continuous", self._flight_context, slo=slo, n_slots=n_slots)
        self.slo_tracker = self._obs.tracker
        if auto_start:
            self.start()

    def _init_paged(self, kv_block_size, kv_blocks, prefill_chunk,
                    draft_source, resolve_pin, host_kv_blocks,
                    disk_kv_blocks, kv_spill_dir) -> None:
        from sparkdl_torch.models.gpt import init_block_pool
        from sparkdl_torch.serving.kv_blocks import KVBlockPool
        from sparkdl_torch.serving.prefix_cache import PrefixCache
        from sparkdl_torch.serving.spec_decode import default_draft_source

        config, n_slots, max_len = self.config, self.n_slots, self.max_len
        if kv_block_size < 1:
            raise ValueError(
                f"kv_block_size must be >= 1, got {kv_block_size}")
        # default 256: the chunk is a decode-LATENCY bound (one tick
        # never prefills more than this many tokens), so it should sit
        # well ABOVE typical prompts
        chunk, _, _ = resolve_pin(
            prefill_chunk, "SPARKDL_TORCH_PREFILL_CHUNK", 256,
            what="prefill_chunk",
        )
        if chunk < 1:
            raise ValueError(f"prefill_chunk must be >= 1, got {chunk}")
        self.prefill_chunk = chunk
        bs = kv_block_size
        mb = -(-max_len // bs)  # table width, blocks per sequence
        w = mb * bs  # gathered virtual-cache width (>= max_len)
        # widest chunk PROGRAM ever built: chunks bucket to their real
        # token count, and no chunk carries more than a whole prompt
        self._chunk_cap = min(chunk, w)
        # the private prefill cache is one max-width chunk wider than the
        # table span: a chunk write must never be dropped
        wp = w + self._chunk_cap
        if kv_blocks is None:
            # default pool = the dense layout's worst case, so the
            # default engine can never defer where dense admitted
            kv_blocks = n_slots * mb
        if kv_blocks < 1:
            raise ValueError(f"kv_blocks must be >= 1, got {kv_blocks}")
        self._kv_bs = bs
        self._mb = mb
        self._w = w
        self._wp = wp
        if self.kv_dtype != "fp32":
            # a compressed pool's bring-up is its own failure surface:
            # an injected kv.quantize fault fails construction before
            # any process-wide registration
            fault_point("kv.quantize")
        self._pool = KVBlockPool(kv_blocks, bs, dtype=self.kv_dtype)
        self._defer_pool = self._pool
        if host_kv_blocks is not None:
            from sparkdl_torch.serving.kv_tiers import TieredKVStore

            # disk overflow may only drop trie LEAVES — dropping an
            # interior parked node would orphan its (parked) descendants
            self._kv_tiers = TieredKVStore(
                host_kv_blocks, disk_kv_blocks or 0, spill_dir=kv_spill_dir,
                is_droppable=lambda node: not node.children)
        self._prefix = PrefixCache(self._pool, tiers=self._kv_tiers)
        self._draft = (draft_source if draft_source is not None
                       else default_draft_source(self._prefix))
        # one scratch block past the real ones, at the sentinel id: empty
        # table entries gather it and sentinel writes land in it
        self._pool_kv = init_block_pool(config, kv_blocks + 1, bs,
                                        dtype=self.kv_dtype,
                                        device=self.device)
        self._table = np.full((n_slots, mb), self._pool.sentinel, np.int64)
        self._pidx = np.zeros((n_slots,), np.int64)
        self._max_pos = (config.max_seq_len - 1
                         if config.positions == "learned" else wp + chunk)

    # -- the device programs -------------------------------------------------
    def _run(self, name: str, fn, inputs: tuple, key: Any = ()):
        """``fn(*inputs)``: one CUDA-graph replay per (``name``, ``key``,
        input shapes) on the card (captured at first use, after an eager
        warm-up that is this call), eagerly on the CPU. ``key`` holds the
        program's static arguments; everything else is an input."""
        with torch.no_grad():
            if not self._graphed:
                return fn(*inputs)
            return self.graphs(fn, inputs,
                               (name, key, storage_key(self._model)))

    def _dev(self, a, dtype=torch.long) -> torch.Tensor:
        """A host array as a program input on the engine's device."""
        return torch.as_tensor(np.asarray(a)).to(self.device, dtype)

    def _dq_gather(self, name: str, ids: torch.Tensor) -> torch.Tensor:
        """pool[name][:, ids] in storage dtype -> compute dtype (the
        scratch block stands at the sentinel id)."""
        pool = self._pool_kv
        x = pool[name][:, ids]
        if self.kv_dtype == "int8":
            from sparkdl_torch.models.gpt import dequantize_kv

            return dequantize_kv(x, pool[name + "_scale"][:, ids],
                                 self.config.dtype)
        return x.to(self.config.dtype)

    def _q_write(self, where: tuple, newk: torch.Tensor,
                 newv: torch.Tensor) -> None:
        """THE quantize-on-write path, in place (every pool write goes
        through here, so scatter and install cannot desynchronize):
        ``where`` indexes after the layer axis — (blk, off) columns for a
        decode/verify scatter, (ids,) whole blocks for an install. int8
        writes codes and their per-column scales; sentinel entries land
        in the scratch block."""
        pool = self._pool_kv
        ix = (slice(None),) + where
        for name, vals in (("k", newk), ("v", newv)):
            if self.kv_dtype == "int8":
                from sparkdl_torch.models.gpt import quantize_kv

                q, s = quantize_kv(vals)
                pool[name][ix] = q
                pool[name + "_scale"][ix] = s
            else:
                pool[name][ix] = vals.to(pool[name].dtype)

    def _virtual_cache(self, sub: torch.Tensor) -> dict:
        """The table's blocks gathered into a dense [layers, S, nb*bs, H,
        D] cache (sentinel entries read the scratch block)."""
        c = self.config
        hd = c.hidden_size // c.num_heads
        s, nb = sub.shape
        shape = (c.num_layers, s, nb * self._kv_bs, c.num_heads, hd)
        return {"k": self._dq_gather("k", sub).reshape(shape),
                "v": self._dq_gather("v", sub).reshape(shape)}

    def _paged_step(self, table, idx, tok, *, k: int, nb: int):
        """k tokens for every slot over the BLOCK TABLE: each step
        gathers the table's first ``nb`` blocks into a virtual dense
        cache (the dense layout's math, so greedy tokens agree), runs the
        per-slot decode on it, then scatters the one written column back
        to its pool block. ``nb`` covers the deepest live row through the
        chain. Rows are right-aligned (column i holds token i), so the
        causal mask alone hides garbage columns. Returns [k, S] tokens."""
        sub = table[:, :nb]
        rows = torch.arange(self.n_slots, device=table.device)
        bs = self._kv_bs
        toks = []
        for _ in range(k):
            cache = self._virtual_cache(sub)
            cache["idx"] = idx.clone()
            logits, _ = self._model(tok[:, None], cache=cache)
            tok = torch.argmax(logits[:, -1], dim=-1)
            self._q_write((table[rows, idx // bs], idx % bs),
                          cache["k"][:, rows, idx], cache["v"][:, rows, idx])
            idx = idx + 1
            toks.append(tok)
        return torch.stack(toks)

    def _paged_verify(self, table, idx, toks, *, nb: int):
        """Speculative verify: score a k-token span for every slot in ONE
        program. Column 0 of ``toks`` is each slot's current last token,
        columns 1.. its drafts; the L=k per-slot step writes all k
        columns at [idx[s], idx[s]+k) and the per-row causal mask
        conditions position j on the real context plus drafts [:j].
        Columns of REJECTED drafts scatter back PAST the accepted
        frontier (the host advances pidx over accepted inputs only): they
        stay causally masked until later writes overwrite them. Returns
        [S, k] argmax tokens."""
        k = toks.shape[1]
        cache = self._virtual_cache(table[:, :nb])
        cache["idx"] = idx.clone()
        logits, _ = self._model(toks, cache=cache)
        out = torch.argmax(logits, dim=-1)
        rows = torch.arange(self.n_slots, device=table.device)[:, None]
        pos = idx[:, None] + torch.arange(k, device=table.device)[None, :]
        bs = self._kv_bs
        self._q_write((table[rows, pos // bs], pos % bs),
                      cache["k"][:, rows, pos], cache["v"][:, rows, pos])
        return out

    def _gathered(self, gids):
        """Cached-prefix blocks -> the head of a private prefill cache
        [layers, 1, wp, H, D] (the copy that makes partial-block sharing
        copy-on-write: the sharer re-installs into blocks it owns, the
        donor block is never written). Sentinel ids read the scratch
        block: garbage the chunked prefill masks or overwrites. Quantized
        pools dequantize here; the final install requantizes to the same
        codes."""
        c = self.config
        hd = c.hidden_size // c.num_heads
        shape = (c.num_layers, 1, self._w, c.num_heads, hd)
        pad = (0, 0, 0, 0, 0, self._wp - self._w)
        return (F.pad(self._dq_gather("k", gids).reshape(shape), pad),
                F.pad(self._dq_gather("v", gids).reshape(shape), pad))

    def _chunk_apply(self, ck, cv, idx, ids, cols: int):
        """One bounded prefill chunk, right-aligned: writes K/V at
        columns [idx, idx + width) of the private cache in place, width
        = ``ids.shape[1]`` (the power-of-2 bucket of the chunk's real
        token count), attending over its live head [0, ``cols``) only —
        every column past it is causally masked garbage. Pad queries at
        the right write garbage PAST every real position, hidden by the
        causal mask until real writes overwrite them. Returns the argmax
        token at every chunk position."""
        wc = ids.shape[1]
        positions = torch.clamp(
            idx[:, None] + torch.arange(wc, device=ids.device)[None, :],
            max=self._max_pos)
        cache = {"k": ck[:, :, :cols], "v": cv[:, :, :cols],
                 "idx": idx.clone()}
        logits, _ = self._model(ids, cache=cache, positions=positions)
        return torch.argmax(logits[0], dim=-1)

    def _installed(self, ck, cv, inst) -> None:
        """Private prefill cache -> the slot's OWNED pool blocks (the
        shared quantize-on-write path). ``inst`` holds the sentinel at
        shared-prefix positions and past the covered span: those writes
        land in the scratch block."""
        c = self.config
        hd = c.hidden_size // c.num_heads
        shape = (c.num_layers, self._mb, self._kv_bs, c.num_heads, hd)
        self._q_write((inst,), ck[:, 0, :self._w].reshape(shape),
                      cv[:, 0, :self._w].reshape(shape))

    # Four chunk programs so a prefill pays the fewest programs: the
    # FIRST chunk fuses the prefix gather, the FINAL one the install, so
    # a suffix that fits one chunk is ONE program end to end.
    def _chunk_one(self, gids, idx, ids, inst, *, cols: int):
        ck, cv = self._gathered(gids)
        out = self._chunk_apply(ck, cv, idx, ids, cols)
        self._installed(ck, cv, inst)
        return out

    def _chunk_first(self, gids, idx, ids, *, cols: int):
        ck, cv = self._gathered(gids)
        return self._chunk_apply(ck, cv, idx, ids, cols), ck, cv

    def _chunk_mid(self, ck, cv, idx, ids, *, cols: int):
        return self._chunk_apply(ck, cv, idx, ids, cols), ck, cv

    def _chunk_final(self, ck, cv, idx, ids, inst, *, cols: int):
        out = self._chunk_apply(ck, cv, idx, ids, cols)
        self._installed(ck, cv, inst)
        return out

    def _prefill(self, ids, mask, slot):
        """Dense layout: a batch-1 left-padded prefill in a fresh cache
        of the shared buffer width (so columns line up), scattered into
        ``slot`` of the per-slot cache in place. One graph per prompt
        bucket. Returns the first token [1]."""
        from sparkdl_torch.models.gpt import init_cache

        lp = ids.shape[1]
        cache = init_cache(self.config, 1, self.max_len, device=ids.device)
        positions = torch.clamp(torch.cumsum(mask, dim=1) - 1, min=0)
        key_valid = torch.cat(
            [mask.bool(), torch.ones((1, self.max_len - lp),
                                     dtype=torch.bool, device=ids.device)],
            dim=1)
        logits, cache = self._model(ids, cache=cache, positions=positions,
                                    attention_mask=key_valid)
        # the scatter: install the row into the slot (slot is an input)
        self._cache["k"].index_copy_(1, slot, cache["k"])
        self._cache["v"].index_copy_(1, slot, cache["v"])
        self._cache["idx"].index_fill_(0, slot, lp)
        return torch.argmax(logits[:, -1], dim=-1)

    def _step_chain(self, tok, start, *, k: int):
        """Dense layout: k tokens for every slot, each step's argmax
        feeding the next (k = 1 is the reference's ``_step``): the
        per-slot cache gives each row its own causal depth, ``start``
        masks its left-pad columns, and positions count real tokens
        only. Returns [k, S] tokens."""
        key_valid = (torch.arange(self.max_len, device=tok.device)[None, :]
                     >= start[:, None])
        toks = []
        for _ in range(k):
            positions = (self._cache["idx"] - start)[:, None]
            logits, _ = self._model(tok[:, None], cache=self._cache,
                                    positions=positions,
                                    attention_mask=key_valid)
            tok = torch.argmax(logits[:, -1], dim=-1)
            toks.append(tok)
        return torch.stack(toks)

    # -- submission ----------------------------------------------------------
    def submit(self, prompt_ids, max_new_tokens: int, *,
               timeout_s: float | None = None,
               tenant: str = "default",
               priority: "int | None" = None) -> Future:
        """Admit one prompt; Future resolves to the generated ids
        (np.int32 array, ``<= max_new_tokens`` long — shorter on eos).
        ``tenant``/``priority`` scope the request for quota, DRR weight
        and class scheduling; see :meth:`RequestQueue.submit` for the
        typed admission rejects."""
        from sparkdl_torch.runtime.batching import pick_bucket

        prompt = np.asarray(prompt_ids, np.int32)
        if prompt.ndim != 1 or prompt.size == 0:
            raise ValueError(
                f"prompt must be a non-empty 1-D id array, got shape "
                f"{prompt.shape}"
            )
        if max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {max_new_tokens}"
            )
        if self.kv_layout == "paged":
            # the paged layout stores tokens unpadded, so the bound is the
            # RAW length — and the pool: a request whose worst-case block
            # count exceeds the whole pool can never fit
            if len(prompt) + max_new_tokens > self.max_len:
                raise ValueError(
                    f"prompt {len(prompt)} + max_new_tokens "
                    f"{max_new_tokens} exceeds cache max_len "
                    f"{self.max_len}: raise max_len or shorten the "
                    "request"
                )
            need = -(-(len(prompt) + max_new_tokens) // self._kv_bs)
            if need > self._pool.n_blocks:
                raise ValueError(
                    f"request needs {need} KV blocks but the pool holds "
                    f"{self._pool.n_blocks}: it can never fit — raise "
                    "kv_blocks or shorten the request"
                )
        else:
            lp = pick_bucket(len(prompt), self._len_buckets)
            if lp + max_new_tokens > self.max_len:
                raise ValueError(
                    f"prompt bucket {lp} + max_new_tokens "
                    f"{max_new_tokens} exceeds cache max_len "
                    f"{self.max_len}: raise max_len or shorten the "
                    "request"
                )
        return self.queue.submit(
            GenRequest(prompt, max_new_tokens), timeout_s=timeout_s,
            tenant=tenant, priority=priority,
        )

    # -- engine loop ---------------------------------------------------------
    def start(self) -> "ContinuousGPTEngine":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, name="sparkdl-continuous-gpt", daemon=True
            )
            self._thread.start()
        return self

    def close(self, *, drain: bool = True,
              timeout_s: float | None = 30.0) -> None:
        """Stop. ``drain=True`` finishes every admitted request (queued
        and in-flight) first; ``drain=False`` fails them now."""
        self.queue.close()
        if not drain:
            self.queue.fail_pending()
            self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout_s)
        elif drain:  # manual-tick mode: drain inline
            while (self.queue.depth > 0 or self._inflight
                   or self._prefilling):
                self.tick()
        self._stop.set()
        # a join timeout or a crashed loop may leave requests queued: no
        # Future may ever be left unresolved
        self.queue.fail_pending()
        with self._lock:
            self._fail_inflight(EngineClosedError("engine shut down"))
        self._obs.close(drain=drain)
        self.graphs.clear()  # their private memory pools go with them
        if self.kv_layout == "paged":
            self._pool.close()
            if self._kv_tiers is not None:
                self._kv_tiers.close()

    def begin_drain(self) -> "list[Request]":
        """Graceful host drain, phase one: stop admission and hand back
        every request that was accepted but NOT yet placed in a slot.
        Requests already prefilling/decoding finish here — the loop
        exits on its own once the last one retires."""
        self.queue.close()
        reqs = self.queue.extract_pending()
        flight_mod.record_event(
            "engine.drain_begin", engine=getattr(self._obs, "name", None),
            host=self.host_id, extracted=len(reqs),
            inflight=len(self._inflight) + len(self._prefilling))
        return reqs

    def reopen(self) -> "ContinuousGPTEngine":
        """Reverse :meth:`begin_drain`: accept submits again and, if the
        loop thread exited on graceful drain, restart it. Only for
        engines that were DRAINED, never CLOSED."""
        self._stop.clear()
        self.queue.reopen()
        t = self._thread
        if t is not None and not t.is_alive():
            self._thread = None
            self.start()
        return self

    def prefix_digest(self, max_entries: int = 1024) -> "dict | None":
        """The compact prefix digest this host publishes: chained hashes
        of its cached block-aligned prompt prefixes, most recently used
        first, bounded. None under the dense layout (no prefix cache)."""
        if self.kv_layout != "paged":
            return None
        with self._lock:
            return {
                "host_id": self.host_id,
                "block_size": self._kv_bs,
                "version": self._prefix.digest_version,
                "hashes": self._prefix.block_hashes(max_entries),
            }

    def prefix_digest_delta(self, since_version: int,
                            max_entries: int = 1024) -> "dict | None":
        """Membership adds/evictions since ``since_version``; None = gap
        (refresh wholesale). The ``digest.delta`` fault site models a
        torn delta read."""
        if self.kv_layout != "paged":
            return None
        with self._lock:
            fault_point("digest.delta")
            delta = self._prefix.block_hash_delta(
                int(since_version), max_entries)
            if delta is None:
                return None
            delta["host_id"] = self.host_id
            delta["block_size"] = self._kv_bs
            return delta

    def _loop(self) -> None:
        try:
            while not self._stop.is_set():
                did_work = self.tick()
                if self.queue.closed and not did_work:
                    with self._lock:
                        if (self.queue.depth == 0 and not self._inflight
                                and not self._prefilling):
                            return  # graceful drain complete
        except BaseException as e:
            # a crashed loop (device OOM, a failed capture) must not
            # strand callers blocked on their Futures
            exc = (e if isinstance(e, Exception)
                   else EngineClosedError(f"engine loop died: {e!r}"))
            self.queue.close()
            self.queue.fail_pending(exc)
            with self._lock:
                self._fail_inflight(exc)
            raise

    # -- one scheduling quantum ---------------------------------------------
    def tick(self) -> bool:
        """Admit into free slots, advance chunked prefills by at most
        ``prefill_chunk`` tokens, advance every live row, retire
        finished rows. Returns True if any work happened. Thread-safe;
        the background loop is just ``while True: tick()``."""
        with self._lock:
            now = time.monotonic()
            self._overload_tick(now)
            self._expire_inflight(now)
            free = [s for s in range(self.n_slots)
                    if s not in self._inflight
                    and s not in self._prefilling]
            if not free and self._prefilling:
                # saturated with a background prefill in flight: a more
                # urgent waiting class may claim its slot
                if self._maybe_preempt(now):
                    free = [s for s in range(self.n_slots)
                            if s not in self._inflight
                            and s not in self._prefilling]
            if free:
                wait = (0.0 if self._inflight or self._prefilling
                        else self.idle_wait_s)
                reqs = self.queue.take(len(free), wait)
                deferred = False
                for i, req in enumerate(reqs):
                    slot = free.pop(0)
                    try:
                        admitted = self._admit(slot, req)
                    except Exception as e:
                        # take() already moved this Future to RUNNING: a
                        # failed admission is THIS request's error, never
                        # the engine's — the slot stays free
                        free.insert(0, slot)
                        self._fail_request(req, e, tokens=0)
                        continue
                    if not admitted:
                        # pool exhausted: defer this request AND every
                        # later one taken this tick back to the queue
                        # head, in order
                        free.insert(0, slot)
                        self._defer(reqs[i:])
                        deferred = True
                        break
                if (not deferred and self.kv_layout == "paged"
                        and self._pool.deferral_streak):
                    # free slots existed and nothing deferred this tick:
                    # the exhaustion episode is over
                    self._pool.reset_deferral_streak()
            else:
                self.queue.sweep_expired()  # deadlines don't wait for slots
            did_work = False
            if self._prefilling:
                self._prefill_tick()
                did_work = True
            if self._inflight:
                self._decode_step()
                did_work = True
            return did_work

    def _defer(self, reqs: "list[Request]") -> None:
        """KV pool exhaustion: re-queue in order, count the streak on the
        pool, and after ``_EXHAUST_DUMP_STREAK`` consecutive deferrals
        hand the flight recorder a postmortem trigger. Self-recovering:
        blocks free as slots retire."""
        self.queue.requeue(reqs)
        self._deferrals += 1
        gen: GenRequest = reqs[0].payload
        pool = self._defer_pool
        # the recovery bar: worst-case blocks of the request being owed
        span_tokens = len(gen.prompt) + gen.max_new_tokens
        pool.record_deferral(need=-(-span_tokens // self._kv_bs))
        streak = pool.deferral_streak
        flight_mod.record_event(
            "kv.admission_deferred",
            engine=getattr(self._obs, "name", None),
            request_id=reqs[0].request_id,
            deferred=len(reqs),
            streak=streak,
            pool="decode",
            blocks_free=pool.free_count,
            blocks_total=pool.n_blocks,
        )
        if streak == _EXHAUST_DUMP_STREAK:
            flight_mod.trigger_dump(
                "kv.pool_exhausted",
                streak=streak,
                pool="decode",
                blocks_total=pool.n_blocks,
            )

    def _maybe_preempt(self, now: float) -> bool:
        """Priority preemption between prefill chunks: with every slot
        busy and a strictly more urgent class waiting, tear down the
        LEAST urgent background prefill and re-queue its request at its
        own class head — zero lost. Only background-class requests are
        preemptible, and only BETWEEN chunks. The ``tenant.preempt``
        fault site fires before teardown; an injected fault still
        re-queues the victim. Returns True when a slot was freed."""
        waiting = self.queue.highest_waiting_priority()
        if waiting is None:
            return False
        slot, st = max(self._prefilling.items(),
                       key=lambda kv: kv[1].req.priority)
        if (st.req.priority < tenancy.PRIORITY_BACKGROUND
                or waiting >= st.req.priority):
            return False
        fault: "Exception | None" = None
        try:
            fault_point("tenant.preempt")
        except Exception as e:
            fault = e
        del self._prefilling[slot]
        self._prefix.release(st.all_blocks())
        if fault is None:
            tenancy.note_preemption()
            flight_mod.record_event(
                "tenant.preempted",
                request_id=st.req.request_id, tenant=st.req.tenant,
                victim_priority=st.req.priority,
                waiting_priority=waiting,
                prefilled=st.pos, prompt_tokens=len(st.prompt))
        else:
            flight_mod.record_event(
                "tenant.preempt_failed",
                error=type(fault).__name__,
                request_id=st.req.request_id, tenant=st.req.tenant)
        self.queue.requeue([st.req])
        return fault is None

    def _overload_tick(self, now: float) -> None:
        """Feed the process brownout controller (when installed) this
        engine's overload signals — worst SLO burn rate plus queue fill —
        on a bounded stride. No controller installed = zero work."""
        ctrl = tenancy.process_overload()
        if ctrl is None or now < self._overload_next:
            return
        self._overload_next = now + _OVERLOAD_STRIDE_S
        burn = None
        if self.slo_tracker is not None:
            rep = self.slo_tracker.sample()
            burns = [d["burn_rate"] for d in
                     (rep.get("latency"), rep.get("availability"))
                     if isinstance(d, dict)]
            if burns:
                burn = max(burns)
        ctrl.evaluate(
            burn_rate=burn,
            queue_frac=self.queue.depth / self.queue.max_depth)

    def _admit(self, slot: int, req: Request) -> bool:
        """Place one taken request into ``slot``. Returns False when the
        paged block pool cannot back it right now (caller defers)."""
        if self.kv_layout == "paged":
            return self._admit_paged(slot, req)
        self._admit_dense(slot, req)
        return True

    def _admit_dense(self, slot: int, req: Request) -> None:
        from sparkdl_torch.runtime.batching import pick_bucket

        gen: GenRequest = req.payload
        lp = pick_bucket(len(gen.prompt), self._len_buckets)
        t0 = time.perf_counter()
        with span("serving.prefill", parent=req.trace_ctx,
                  prompt_len=len(gen.prompt), bucket=lp, slot=slot,
                  request_id=req.request_id):
            ids = np.zeros((1, lp), np.int64)
            mask = np.zeros((1, lp), np.int64)
            ids[0, lp - len(gen.prompt):] = gen.prompt
            mask[0, lp - len(gen.prompt):] = 1
            tok = self._run("prefill", self._prefill,
                            (self._dev(ids), self._dev(mask),
                             self._dev([slot])))
            first = int(np.asarray(start_fetch(tok, path="prefill")
                                   .result())[0])
        self._prefill_seconds += time.perf_counter() - t0
        self._start[slot] = lp - len(gen.prompt)
        self._last_tok[slot] = first
        self._first_token(req)
        flight = _InFlight(req, [first], gen.max_new_tokens)
        self._inflight[slot] = flight
        if self._is_done(flight):  # max_new_tokens=1, or instant eos
            self._complete(slot)

    # -- paged admission + chunked prefill -----------------------------------
    def _admit_paged(self, slot: int, req: Request) -> bool:
        """Match the longest cached prefix, allocate the request's
        worst-case remaining blocks up front (so decode can never hit
        mid-stream exhaustion), and queue the suffix for chunked
        prefill. False = pool exhausted right now (defer)."""
        gen: GenRequest = req.payload
        prompt = np.asarray(gen.prompt, np.int32)
        plen = len(prompt)
        toks = tuple(int(t) for t in prompt)
        nb_total = -(-(plen + gen.max_new_tokens) // self._kv_bs)
        # turn resume: page any parked prefix of this prompt back in
        # BEFORE matching, so the match below sees device blocks and the
        # resume costs one H2D copy per block instead of a re-prefill.
        # Restored blocks hold a temporary reference (restore allocation
        # may demote OTHER cold leaves, never these) released as soon as
        # match has taken its own.
        restored: "list[int]" = []
        if self._kv_tiers is not None:
            restored = self._prefix.restore_path(
                toks[:-1], alloc_block=self._alloc_one_block,
                install=self._install_parked)
            self._update_unpark_reserved()
            if restored:
                flight_mod.record_event(
                    "kv.unparked", request_id=req.request_id,
                    blocks=len(restored))
        # the last prompt token must always prefill — the cache holds
        # K/V, not the logits that seed decode
        m = self._prefix.match(toks[:-1])
        if restored:
            self._prefix.release(restored)
        matched = (m.full_blocks
                   + ([m.partial_block] if m.partial_block is not None
                      else []))
        try:
            owned = self._alloc_blocks(nb_total - len(m.full_blocks))
        except Exception as e:
            # an injected kv.alloc fault or allocator error is
            # exhaustion, not a request error: defer, recover
            flight_mod.record_event(
                "kv.alloc_error", error=type(e).__name__,
                request_id=req.request_id)
            owned = None
        if owned is None:
            self._prefix.release(matched)
            self._defer_pool = self._pool
            return False
        # the first chunk gathers the cached prefix into the private
        # prefill cache (also the COW copy of a partial tail block);
        # sentinel entries are masked garbage, so no hit = fresh cache.
        # The partial block keeps its extra reference until that gather
        # has been enqueued.
        gids = np.full((self._mb,), self._pool.sentinel, np.int64)
        gids[:len(m.full_blocks)] = m.full_blocks
        if m.partial_block is not None:
            gids[len(m.full_blocks)] = m.partial_block
        n_shared = len(m.full_blocks)
        inst = np.full((self._mb,), self._pool.sentinel, np.int64)
        inst[n_shared:n_shared + len(owned)] = owned
        self._prefix.record_lookup(m.hit_tokens, plen - m.hit_tokens)
        if m.hit_tokens:
            flight_mod.record_event(
                "kv.prefix_hit", request_id=req.request_id,
                hit_tokens=m.hit_tokens, prompt_tokens=plen)
        self._prefilling[slot] = _Prefill(
            req=req, prompt=prompt, max_new=gen.max_new_tokens,
            pos=m.hit_tokens, hit=m.hit_tokens,
            shared=m.full_blocks, owned=owned,
            gather_ids=gids, install_ids=inst,
            cow_block=m.partial_block,
        )
        self._pool.reset_deferral_streak()
        return True

    def _alloc_blocks(self, n: int) -> "list[int] | None":
        got = self._pool.allocate(n)
        if got is None:
            short = n - self._pool.free_count
            if self._kv_tiers is not None:
                # tiered: page cold leaves OUT (device->host->disk)
                # instead of discarding them — the demoted sessions
                # resume with one H2D copy, not a re-prefill
                freed = self._prefix.demote(short, self._park_payload)
                self._update_unpark_reserved()
            else:
                freed = self._prefix.evict(short)
            if freed >= short:
                got = self._pool.allocate(n)
        return got

    def _alloc_one_block(self) -> "int | None":
        got = self._alloc_blocks(1)
        return got[0] if got else None

    # -- tiered park/resume ---------------------------------------------------
    def _raw_block(self, bid: int) -> "dict[str, torch.Tensor]":
        """Block ``bid`` as it lies in the pool: ``k``/``v`` [layers, bs,
        H, D] in storage dtype (bf16 as its 16-bit patterns: numpy has no
        bf16) plus the int8 layout's ``k_scale``/``v_scale`` [layers,
        bs]. Never the scratch block: parking starts from trie nodes,
        and the sentinel id is never registered."""
        names = ("k", "v") + (("k_scale", "v_scale")
                              if self.kv_dtype == "int8" else ())
        out = {}
        for name in names:
            t = self._pool_kv[name][:, bid]
            out[name] = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
        return out

    def _park_payload(self, bid: int) -> "dict | None":
        """D2H-fetch one cold block's raw bytes for parking: an async copy
        into page-locked memory on the engine's stream, so it runs behind
        the program that last wrote the block. None = torn park (injected
        ``kv.park`` fault or transfer failure): the caller falls back to
        plain eviction — the session re-prefills next turn, nothing is
        lost."""
        from sparkdl_torch.serving import kv_tiers as kv_tiers_mod
        from sparkdl_torch.serving.kv_codec import bf16_bits

        t0 = time.monotonic()
        try:
            fault_point("kv.park")
            fetched = start_fetch(self._raw_block(bid),
                                  path="kv_park").result()
        except Exception as e:
            self._park_fallbacks += 1
            kv_tiers_mod._M_FALLBACKS.inc(op="park")
            flight_mod.record_event(
                "kv.park_failed", error=type(e).__name__, block=bid)
            return None
        # into pageable memory: the page-locked copy goes back to the
        # caching host allocator for the next park instead of living in
        # the tier (and a CPU fetch is a view of the pool itself)
        payload = {name: np.array(v) for name, v in fetched.items()}
        if self.kv_dtype == "bf16":
            payload = {name: bf16_bits(v) for name, v in payload.items()}
        kv_tiers_mod._M_PARK_SEC.observe(time.monotonic() - t0)
        return payload

    def _install_parked(self, bid: int, payload: dict) -> bool:
        """H2D-install one parked block's raw bytes into fresh pool block
        ``bid``, in place (graphs hold the pool's addresses; the tensors
        never move). False = corrupt unpark (injected ``kv.unpark`` fault
        or a payload that does not fit): the caller prunes the parked
        subtree and the suffix re-prefills — the request still
        completes."""
        from sparkdl_torch.serving import kv_tiers as kv_tiers_mod
        from sparkdl_torch.serving.kv_codec import BF16Bits

        t0 = time.monotonic()
        try:
            fault_point("kv.unpark")
            for name, vals in payload.items():
                dst = self._pool_kv[name][:, bid]
                src = np.ascontiguousarray(vals)
                if isinstance(vals, BF16Bits):
                    src = torch.from_numpy(src.view(np.int16)).view(
                        torch.bfloat16)
                else:
                    src = torch.from_numpy(src)
                if dst.shape != src.shape or dst.dtype != src.dtype:
                    raise ValueError(
                        f"parked {name} {src.dtype} {tuple(src.shape)} "
                        f"does not fit the pool's {dst.dtype} "
                        f"{tuple(dst.shape)}")
                if dst.is_cuda:
                    # stream-ordered; the caching host allocator keeps
                    # the pinned source alive until the copy has run
                    src = src.pin_memory()
                dst.copy_(src, non_blocking=True)
        except Exception as e:
            self._park_fallbacks += 1
            kv_tiers_mod._M_FALLBACKS.inc(op="unpark")
            flight_mod.record_event(
                "kv.unpark_failed", error=type(e).__name__, block=bid)
            return False
        kv_tiers_mod._M_UNPARK_SEC.observe(time.monotonic() - t0)
        return True

    def _update_unpark_reserved(self) -> None:
        """Tell the pool how many free blocks parked state expects to
        claim on resume, so an autoscaler's shrink defers instead of
        stranding unparks behind re-prefills (capped at the pool)."""
        if self._kv_tiers is None:
            return
        s = self._kv_tiers.stats()
        self._pool.unpark_reserved = min(
            s["host_blocks"] + s["disk_blocks"], self._pool.n_blocks)

    def park_cold(self, max_blocks: "int | None" = None) -> int:
        """Explicitly page every currently cold cached block out to the
        host tier (benches/tests; production parks lazily under
        allocation pressure). Returns device blocks freed. Refcounted
        shares and partial-block COW donors never park."""
        if self._kv_tiers is None:
            raise RuntimeError(
                "park_cold needs a host tier: construct the engine "
                "with host_kv_blocks")
        with self._lock:
            n = (max_blocks if max_blocks is not None
                 else self._prefix.cached_blocks)
            freed = self._prefix.demote(
                n, self._park_payload, evict_fallback=False)
            self._update_unpark_reserved()
            return freed

    # -- parked-session migration ---------------------------------------------
    def export_parked_sessions(self,
                               max_sessions: "int | None" = None
                               ) -> "dict | None":
        """Serialize every parked session's block-aligned prefix path for
        re-parking on another engine (a host's drain or scale-down:
        without this, parked state strands where it parked and every
        idle conversation re-prefills cold). Each session ships its WHOLE
        path (device-resident ancestors are D2H-fetched like a park;
        parked blocks are peeked from their tier) through the raw codec,
        so the importing engine resumes bitwise-identically. Exported
        parked subtrees are pruned here — the state now lives on the
        target; a torn export (``kv.migrate`` fault) skips that session,
        which simply re-prefills on resume (never lost, never
        duplicated). None when this engine has no tier store."""
        if self.kv_layout != "paged" or self._kv_tiers is None:
            return None
        from sparkdl_torch.serving import kv_tiers as kv_tiers_mod
        from sparkdl_torch.serving.kv_codec import encode

        t0 = time.monotonic()
        sessions: "list[dict]" = []
        with self._lock:
            paths = self._prefix.parked_leaf_paths()
            if max_sessions is not None:
                paths = paths[:int(max_sessions)]
            prune: "list[Any]" = []
            for tokens, nodes in paths:
                try:
                    fault_point("kv.migrate")
                    blocks = []
                    for n in nodes:
                        pl = (self._park_payload(n.block_id)
                              if n.tier == "device"
                              else self._kv_tiers.peek(n))
                        if pl is None:
                            raise RuntimeError(
                                "torn export: block payload unavailable")
                        blocks.append({k: encode(v) for k, v in pl.items()})
                except Exception as e:
                    kv_tiers_mod._M_MIGRATIONS.inc(outcome="export_failed")
                    flight_mod.record_event(
                        "kv.migrate_export_failed", host=self.host_id,
                        error=type(e).__name__)
                    continue
                sessions.append({"tokens": [int(t) for t in tokens],
                                 "blocks": blocks})
                kv_tiers_mod._M_MIGRATIONS.inc(outcome="exported")
                kv_tiers_mod._M_MIG_BLOCKS.inc(len(blocks))
                top = next((n for n in nodes if n.tier != "device"), None)
                if top is not None:
                    prune.append(top)
            seen: "set[int]" = set()
            for top in prune:
                # tops are roots of maximal parked subtrees — disjoint,
                # but two leaves under one top share it: prune once
                if id(top) in seen:
                    continue
                seen.add(id(top))
                self._prefix._prune_parked(top)
            self._update_unpark_reserved()
        kv_tiers_mod._M_MIG_SEC.observe(time.monotonic() - t0)
        flight_mod.record_event(
            "kv.migrate_export", host=self.host_id, sessions=len(sessions))
        return {"host_id": self.host_id, "block_size": self._kv_bs,
                "kv_dtype": self.kv_dtype, "sessions": sessions}

    def import_parked_sessions(self, bundle: "dict | None") -> int:
        """Adopt migrated parked sessions into this engine's tier store
        (the receiving end of :meth:`export_parked_sessions`): each
        session's blocks re-park here and its trie path is grafted in, so
        the next turn's ``restore_path`` pages it in with one H2D copy
        per block instead of a re-prefill. Sessions on a different block
        grid or storage dtype are skipped whole (their bytes cannot
        install here — re-prefill is the correct fallback), as is any
        session torn by the ``kv.migrate`` fault site. Returns sessions
        adopted."""
        if (self.kv_layout != "paged" or self._kv_tiers is None
                or not bundle):
            return 0
        from sparkdl_torch.serving import kv_tiers as kv_tiers_mod
        from sparkdl_torch.serving.kv_codec import decode

        if int(bundle.get("block_size") or 0) != self._kv_bs:
            return 0
        dtype = bundle.get("kv_dtype")
        if dtype is not None and str(dtype) != str(self.kv_dtype):
            return 0
        t0 = time.monotonic()
        adopted = 0
        with self._lock:
            for sess in bundle.get("sessions") or ():
                try:
                    fault_point("kv.migrate")
                    blocks = [{k: decode(v) for k, v in b.items()}
                              for b in sess["blocks"]]
                    toks = tuple(int(t) for t in sess["tokens"])
                    if len(toks) != len(blocks) * self._kv_bs:
                        raise ValueError("ragged migration payload")
                    self._prefix.adopt_parked(toks, blocks)
                except Exception as e:
                    kv_tiers_mod._M_MIGRATIONS.inc(outcome="import_failed")
                    flight_mod.record_event(
                        "kv.migrate_import_failed", host=self.host_id,
                        error=type(e).__name__)
                    continue
                adopted += 1
                kv_tiers_mod._M_MIGRATIONS.inc(outcome="imported")
            self._update_unpark_reserved()
        kv_tiers_mod._M_MIG_SEC.observe(time.monotonic() - t0)
        flight_mod.record_event(
            "kv.migrate_import", host=self.host_id, sessions=adopted)
        return adopted

    def _prefill_tick(self) -> None:
        """Advance chunked prefills by at most ``prefill_chunk`` REAL
        tokens this tick, round-robin across prefilling slots — the bound
        that keeps a long prompt from freezing in-flight decode latency
        (several short prompts fit one tick's budget; a long one takes
        exactly one chunk per tick)."""
        budget = self.prefill_chunk
        slots = sorted(self._prefilling)
        if len(slots) > 1:
            pivot = self._prefill_rr % len(slots)
            slots = slots[pivot:] + slots[:pivot]
        self._prefill_rr += 1
        tick_tokens = 0
        for slot in slots:
            st = self._prefilling[slot]
            r = min(self.prefill_chunk, len(st.prompt) - st.pos)
            if r > budget:
                continue  # over this tick's budget: next tick
            budget -= r
            tick_tokens += r
            self._prefill_chunk_step(slot, st, r)
            if budget <= 0:
                break
        self._max_tick_prefill_tokens = max(
            self._max_tick_prefill_tokens, tick_tokens)

    def _prefill_chunk_step(self, slot: int, st: _Prefill,
                            r: int) -> None:
        from sparkdl_torch.runtime.batching import pow2_bucket

        c0 = st.pos
        first = st.ck is None
        final = c0 + r == len(st.prompt)
        # chunk-program width: power-of-2 bucket of the real token count
        # (capped by the budget) — graph reuse without paying the full
        # budget width for a short suffix
        wc = pow2_bucket(r, 8, self._chunk_cap)
        ids = np.zeros((1, wc), np.int64)
        ids[0, :r] = st.prompt[c0:c0 + r]
        # static attention width: bucket of the live buffer head
        cols = pow2_bucket(c0 + wc, 8, self._wp)
        idx = self._dev([c0], torch.int32)
        ids = self._dev(ids)
        key = (wc, cols)
        t0 = time.perf_counter()
        with span("serving.prefill_chunk", parent=st.req.trace_ctx,
                  request_id=st.req.request_id, slot=slot,
                  start=c0, tokens=r, first=first, final=final):
            if first and final:
                out = self._run(
                    "chunk_one",
                    lambda g, i, x, n: self._chunk_one(g, i, x, n, cols=cols),
                    (self._dev(st.gather_ids), idx, ids,
                     self._dev(st.install_ids)), key)
            elif first:
                out, st.ck, st.cv = self._run(
                    "chunk_first",
                    lambda g, i, x: self._chunk_first(g, i, x, cols=cols),
                    (self._dev(st.gather_ids), idx, ids), key)
            elif final:
                out = self._run(
                    "chunk_final",
                    lambda a, b, i, x, n: self._chunk_final(
                        a, b, i, x, n, cols=cols),
                    (st.ck, st.cv, idx, ids, self._dev(st.install_ids)), key)
                st.ck = st.cv = None
            else:
                out, st.ck, st.cv = self._run(
                    "chunk_mid",
                    lambda a, b, i, x: self._chunk_mid(a, b, i, x, cols=cols),
                    (st.ck, st.cv, idx, ids), key)
        if first and st.cow_block is not None:
            # the gather is enqueued ahead of any later write to the
            # source block (one stream): drop the hold
            self._prefix.release([st.cow_block])
            st.cow_block = None
        st.pos += r
        st.chunks += 1
        self._prefill_chunks += 1
        _M_PREFILL_CHUNKS.inc()
        if final:
            # the chunk's last REAL column seeds decode
            toks = np.asarray(start_fetch(out, path="prefill").result())
            self._finish_prefill(slot, st, int(toks[r - 1]))
        self._prefill_seconds += time.perf_counter() - t0

    def _finish_prefill(self, slot: int, st: _Prefill,
                        first: int) -> None:
        n_shared = len(st.shared)
        nb_total = n_shared + len(st.owned)
        row = np.full((self._mb,), self._pool.sentinel, np.int64)
        row[:n_shared] = st.shared
        row[n_shared:nb_total] = st.owned
        self._table[slot] = row
        plen = len(st.prompt)
        n_prompt_blocks = -(-plen // self._kv_bs)
        self._prefix.register(
            tuple(int(t) for t in st.prompt),
            [int(b) for b in row[:n_prompt_blocks]],
        )
        self._pidx[slot] = plen
        self._last_tok[slot] = first
        self._first_token(st.req)
        del self._prefilling[slot]
        flight = _InFlight(st.req, [first], st.max_new,
                           blocks=st.shared + st.owned,
                           prompt=st.prompt)
        self._inflight[slot] = flight
        if self._is_done(flight):  # max_new_tokens=1, or instant eos
            self._complete(slot)

    def _release_slot(self, slot: int,
                      blocks: "list[int] | None") -> None:
        """Return a retiring slot's table to sentinel and drop its block
        references (registered prompt blocks stay cached for prefix
        reuse; the rest free)."""
        if self.kv_layout != "paged":
            return
        self._table[slot] = self._pool.sentinel
        self._pidx[slot] = 0
        if blocks:
            self._prefix.release(blocks)

    def _bounded_tokens(self, now: float, cap: int) -> int:
        """Clamp a per-program token count to (a) the smallest remaining
        token budget in flight — nothing is decoded past the earliest
        possible retirement — and (b) the tightest in-flight deadline
        over the measured per-token time (2x safety). Shared by the
        chained decode AND the speculative verify width."""
        cap = min(cap, *(
            f.max_new - len(f.produced) for f in self._inflight.values()
        ))
        tok_s = self._chain_policy.program_s
        if tok_s:
            for f in self._inflight.values():
                if f.req.deadline is not None:
                    headroom = (f.req.deadline - now) / (2.0 * tok_s)
                    cap = min(cap, int(headroom))
        elif any(f.req.deadline is not None
                 for f in self._inflight.values()):
            # no per-token estimate yet and a deadline in flight: the
            # first program doubles as the measurement probe at k=1
            return 1
        return cap

    def _decode_chain_len(self, now: float) -> int:
        """Tokens to fuse into the next plain decode program: the
        configured/auto cap under the shared budget/deadline bound,
        rounded down to a power of two — at most log2(cap) chain graphs
        per gather depth ever exist."""
        if tenancy.overload_level() >= tenancy.LEVEL_DEGRADE:
            return 1  # brownout: shed chained-decode burstiness first
        cap = (self.chain_tokens if self.chain_tokens is not None
               else self._chain_policy.chain_len())
        cap = self._bounded_tokens(now, cap)
        if cap <= 1:
            return 1
        return 1 << (cap.bit_length() - 1)

    def _spec_width(self, now: float) -> int:
        """Verify width (1 + drafts) for the next speculative program:
        the ``spec_k`` cap shrunk by the measured acceptance rate and the
        same budget/deadline bound as ``chain_tokens``. Power of two."""
        if tenancy.overload_level() >= tenancy.LEVEL_DEGRADE:
            return 1  # brownout: wasted verify FLOPs are shed first
        cap = min(self.spec_k, self._spec_policy.spec_len())
        cap = self._bounded_tokens(now, cap)
        if cap < 2:
            return 1
        return 1 << (cap.bit_length() - 1)

    def _gather_depth(self, k: int) -> int:
        """Table blocks the next program gathers: those covering the
        deepest live row through ``k`` more columns, bucketed to a power
        of two and capped at the table width."""
        from sparkdl_torch.runtime.batching import pow2_bucket

        need = max((self._pidx[s] for s in self._inflight), default=0) + k
        return pow2_bucket(-(-int(need) // self._kv_bs), 1, self._mb)

    def _spec_step(self) -> bool:
        """One propose -> verify -> accept quantum. Returns True when a
        verify program advanced the batch; False when speculation stood
        down this tick — width bounded below 2, no proposer had a draft,
        or the ``spec.verify`` fault site fired (the tick falls back to
        plain decode, zero lost requests)."""
        from sparkdl_torch.serving.spec_decode import greedy_accept

        k = self._spec_width(time.monotonic())
        if k < 2:
            return False
        # propose per live slot (ids only, host-side). Slots whose
        # proposer stands down ride with filler drafts: rejection costs
        # them nothing, and a filler match is by construction the argmax
        drafts = np.zeros((self.n_slots, k - 1), np.int64)
        real_len: "dict[int, int]" = {}
        proposed = 0
        for slot, f in self._inflight.items():
            ctx = np.concatenate(
                [f.prompt, np.asarray(f.produced, np.int32)])
            got = self._draft.propose(ctx, k - 1)[:k - 1]
            real_len[slot] = len(got)
            proposed += len(got)
            if got:
                drafts[slot, :len(got)] = got
        if not proposed:
            return False
        try:
            # fires BEFORE the program is enqueued, so the pool is never
            # half-written; the tick serves everyone through plain decode
            fault_point("spec.verify")
        except Exception as e:
            self._spec_fallbacks += 1
            _M_SPEC_FALLBACKS.inc()
            flight_mod.record_event(
                "spec.verify_failed",
                engine=getattr(self._obs, "name", None),
                error=type(e).__name__, k=k,
                slots=len(self._inflight))
            return False
        toks = np.concatenate([self._last_tok[:, None], drafts], axis=1)
        nb = self._gather_depth(k)
        t0 = time.perf_counter()
        links = ([f.req.request_id for f in self._inflight.values()]
                 if tracing.tracing_enabled() else ())
        with span("serving.spec_verify", slots=len(self._inflight),
                  k=k, links=links):
            out = self._run(
                "paged_verify",
                lambda t, i, x: self._paged_verify(t, i, x, nb=nb),
                (self._dev(self._table), self._dev(self._pidx),
                 self._dev(toks)), (k, nb))
            out = np.asarray(start_fetch(out, path="decode").result())
        wall = time.perf_counter() - t0
        record_dispatch("decode", k, wall)
        # the deadline bound's per-token estimate: a width-k verify is
        # ~ONE model pass (weight-bound), so record it as one step
        self._chain_policy.record(wall, 1)
        self.metrics.record_batch(len(self._inflight), self.n_slots)
        self._spec_dispatches += 1
        accepted = 0
        for slot in list(self._inflight):
            flight = self._inflight[slot]
            m = greedy_accept(drafts[slot], out[slot, :k - 1])
            accepted += min(m, real_len.get(slot, 0))
            # outputs [:m+1] are real greedy tokens (m accepted drafts +
            # the bonus/correction); eos or budget mid-span drops the
            # rest and frees the slot now
            for j in range(m + 1):
                flight.produced.append(int(out[slot, j]))
                self._last_tok[slot] = out[slot, j]
                self._pidx[slot] += 1
                self._spec_tokens += 1
                if self._is_done(flight):
                    self._complete(slot)
                    break
        self._spec_proposed += proposed
        self._spec_accepted += accepted
        self._spec_policy.record(proposed, accepted)
        _M_SPEC_PROPOSED.inc(proposed)
        if accepted:
            _M_SPEC_ACCEPTED.inc(accepted)
        with _SPEC_TOTALS_LOCK:
            _SPEC_TOTALS["proposed"] += proposed
            _SPEC_TOTALS["accepted"] += accepted
            _M_SPEC_RATE.set(
                _SPEC_TOTALS["accepted"] / _SPEC_TOTALS["proposed"])
        return True

    def _decode_step(self) -> None:
        if (self.spec_k is not None and self.kv_layout == "paged"
                and self._spec_step()):
            return
        k = self._decode_chain_len(time.monotonic())
        t0 = time.perf_counter()
        # decode ticks are batch-level: their spans link every rider's
        # request id so each request's trace pulls in its decode steps
        links = ([f.req.request_id for f in self._inflight.values()]
                 if tracing.tracing_enabled() else ())
        with span("serving.decode_step", slots=len(self._inflight),
                  chain=k, links=links):
            if self.kv_layout == "paged":
                nb = self._gather_depth(k)
                toks = self._run(
                    "paged_step",
                    lambda t, i, x: self._paged_step(t, i, x, k=k, nb=nb),
                    (self._dev(self._table), self._dev(self._pidx),
                     self._dev(self._last_tok)), (k, nb))
            else:
                toks = self._run(
                    "step_chain",
                    lambda x, s: self._step_chain(x, s, k=k),
                    (self._dev(self._last_tok), self._dev(self._start)), k)
            # the token readback is enqueued right behind the program
            toks = np.asarray(start_fetch(toks, path="decode").result())
        wall = time.perf_counter() - t0
        record_dispatch("decode", k, wall)
        self._chain_policy.record(wall, k)
        self.metrics.record_batch(len(self._inflight), self.n_slots)
        paged = self.kv_layout == "paged"
        for j in range(k):
            live = list(self._inflight)
            if not live:
                break
            for slot in live:
                flight = self._inflight[slot]
                flight.produced.append(int(toks[j, slot]))
                self._last_tok[slot] = toks[j, slot]
                if paged:
                    # one column written per decoded token
                    self._pidx[slot] += 1
                if self._is_done(flight):
                    # eos (or budget) mid-chain: later tokens the chain
                    # decoded for this row are dropped — rows are
                    # independent, so they influenced nobody
                    self._complete(slot)

    def _first_token(self, req: Request) -> None:
        """The request's first token is on the host: its time to first
        token goes to the metrics and onto its Future (``ttft_s``)."""
        ttft = time.monotonic() - req.enqueued
        req.future.ttft_s = ttft
        self.metrics.record_first_token(ttft)

    def _is_done(self, flight: _InFlight) -> bool:
        return (len(flight.produced) >= flight.max_new
                or (self.eos_id is not None
                    and flight.produced[-1] == self.eos_id))

    def _record_request_span(self, req: Request, now: float, *,
                             ok: bool, tokens: int,
                             error: "Exception | None" = None) -> None:
        if tracing.tracing_enabled():
            tracing.record_span(
                "serving.request", req.enqueued, now,
                parent=req.trace_ctx, request_id=req.request_id,
                ok=ok, tokens=tokens,
                **({"error": type(error).__name__} if error else {}),
            )

    def _register_session(self, slot: int, flight: _InFlight) -> None:
        """Index the finished turn's whole sequence — prompt plus
        produced tokens minus the last (columns ``[0, pidx)`` hold
        exactly the K/V of ``prompt + produced[:-1]``) — so the
        session's NEXT turn, whose prompt embeds this turn verbatim,
        parks and resumes instead of re-prefilling. Tiered engines only:
        without a park tier the extra registrations would just bloat the
        LRU."""
        seq = (tuple(int(t) for t in flight.prompt)
               + tuple(int(t) for t in flight.produced[:-1]))
        if not seq:
            return
        nb = -(-len(seq) // self._kv_bs)
        row = self._table[slot]
        self._prefix.register(seq, [int(b) for b in row[:nb]])

    def _complete(self, slot: int) -> None:
        flight = self._inflight.pop(slot)
        if self._kv_tiers is not None:
            self._register_session(slot, flight)
        self._release_slot(slot, flight.blocks)
        now = time.monotonic()
        self._record_request_span(
            flight.req, now, ok=True, tokens=len(flight.produced))
        flight.req.future.set_result(
            np.asarray(flight.produced, np.int32)
        )
        self.metrics.record_request(now - flight.req.enqueued, ok=True)
        reg = self.queue.tenants
        if reg is not None:
            reg.note_outcome(flight.req.tenant,
                             now - flight.req.enqueued, ok=True)

    def _fail_request(self, req: Request, exc: Exception, *,
                      tokens: int) -> None:
        """The one failure sequence every retire-with-error path shares:
        terminal span, Future exception, shed-load counter, latency
        metric. Skips Futures already resolved elsewhere."""
        if req.future.done():
            return
        now = time.monotonic()
        self._record_request_span(
            req, now, ok=False, tokens=tokens, error=exc)
        req.future.set_exception(exc)
        record_request_failure(exc, request_id=req.request_id)
        self.metrics.record_request(now - req.enqueued, ok=False)
        reg = self.queue.tenants
        if reg is not None:
            reg.note_outcome(req.tenant, now - req.enqueued, ok=False)

    def _expire_inflight(self, now: float) -> None:
        for slot in list(self._inflight):
            flight = self._inflight[slot]
            if flight.req.expired(now):
                self._inflight.pop(slot)
                self._release_slot(slot, flight.blocks)
                self._fail_request(
                    flight.req,
                    DeadlineExceededError(
                        "deadline exceeded mid-decode "
                        f"({len(flight.produced)}/{flight.max_new} "
                        "tokens)"),
                    tokens=len(flight.produced))
        for slot in list(self._prefilling):
            st = self._prefilling[slot]
            if st.req.expired(now):
                self._prefilling.pop(slot)
                self._release_slot(slot, st.all_blocks())
                self._fail_request(
                    st.req,
                    DeadlineExceededError(
                        "deadline exceeded mid-prefill "
                        f"({st.pos}/{len(st.prompt)} prompt tokens)"),
                    tokens=0)

    def _fail_inflight(self, exc: Exception) -> None:
        for slot in list(self._inflight):
            flight = self._inflight.pop(slot)
            self._release_slot(slot, flight.blocks)
            self._fail_request(flight.req, exc,
                               tokens=len(flight.produced))
        for slot in list(self._prefilling):
            st = self._prefilling.pop(slot)
            self._release_slot(slot, st.all_blocks())
            self._fail_request(st.req, exc, tokens=0)

    # -- introspection -------------------------------------------------------
    @property
    def active_slots(self) -> int:
        return len(self._inflight)

    def trace(self, request_id: int) -> "list[dict]":
        """Every finished span of one request's trace (queue wait,
        prefill, its decode steps via links, the terminal
        ``serving.request``). Empty with tracing off."""
        return tracing.spans_for_trace(request_id)

    def inflight_request_ids(self) -> "list[int]":
        """Ids of queued + prefilling + decoding requests (postmortem
        input). Best-effort: read without the engine lock."""
        out = self.queue.pending_request_ids()
        try:
            out.extend(f.req.request_id
                       for f in list(self._inflight.values()))
            out.extend(s.req.request_id
                       for s in list(self._prefilling.values()))
        except RuntimeError:  # pragma: no cover - mutation race
            pass
        return out

    def _kv_snapshot(self) -> "dict[str, Any] | None":
        from sparkdl_torch.serving.kv_blocks import (
            kv_bytes_per_token,
            kv_capacity_ratio,
        )

        if self.kv_layout != "paged":
            return None
        return {
            "block_size": self._kv_bs,
            "blocks_total": self._pool.n_blocks,
            "blocks_used": self._pool.used_count,
            "blocks_used_peak": self._pool.used_peak,
            "blocks_spare": self._pool.spare_count,
            "blocks_cached": self._prefix.cached_blocks,
            "prefix_hits": self._prefix.hit_tokens,
            "prefix_misses": self._prefix.miss_tokens,
            "prefix_evictions": self._prefix.evictions,
            "prefill_chunk": self.prefill_chunk,
            "prefill_chunks": self._prefill_chunks,
            "deferrals_total": self._deferrals,
            # /healthz reads a nonzero streak as degraded
            "exhausted_streak": self._pool.deferral_streak,
            "dtype": self.kv_dtype,
            "bytes_per_token": kv_bytes_per_token(
                self.config, self.kv_dtype),
            "capacity_ratio_vs_fp32": round(kv_capacity_ratio(
                self.config, self.kv_dtype), 4),
            # host/disk tier occupancy rides the same snapshot into the
            # flight recorder's pool-pressure context and healthz
            **({"tiers": {
                **(self._prefix.tier_stats() or {}),
                "park_fallbacks": self._park_fallbacks,
                "unpark_reserved": self._pool.unpark_reserved,
            }} if self._kv_tiers is not None else {}),
        }

    def _spec_snapshot(self) -> "dict[str, Any] | None":
        if self.spec_k is None:
            return None
        return {
            "spec_k": self.spec_k,
            "dispatches": self._spec_dispatches,
            "fallbacks": self._spec_fallbacks,
            "proposed": self._spec_proposed,
            "accepted": self._spec_accepted,
            "acceptance_rate": (
                round(self._spec_accepted / self._spec_proposed, 4)
                if self._spec_proposed else None),
            "tokens": self._spec_tokens,
            "tokens_per_dispatch": (
                round(self._spec_tokens / self._spec_dispatches, 4)
                if self._spec_dispatches else None),
        }

    def _graph_snapshot(self) -> dict:
        """The device programs' CUDA graphs: how many were captured (on
        the card; 0 on the CPU), what capturing cost, and their pools."""
        graphs = self.graphs.graphs()
        return {
            "captured": self.graphs.captures,
            "cached": len(graphs),
            "capture_s": sum(g.capture_s for g in graphs),
            "pool_bytes": sum(g.pool_bytes for g in graphs),
        }

    def _flight_context(self) -> dict:
        out = self.metrics.snapshot(self.queue)
        out["active_slots"] = self.active_slots
        out["prefilling_slots"] = len(self._prefilling)
        out["inflight_request_ids"] = self.inflight_request_ids()
        kv = self._kv_snapshot()
        if kv is not None:
            # healthz_report aggregates this shape: a nonzero
            # exhaustion streak reads as degraded (self-recovering)
            out["kv_pool"] = kv
        spec = self._spec_snapshot()
        if spec is not None:
            out["spec"] = spec
        ctrl = tenancy.process_overload()
        if ctrl is not None:
            out["overload"] = ctrl.snapshot()
        reg = self.queue.tenants
        if reg is not None:
            out["tenants"] = reg.snapshot()
        return out

    def kv_autoscale_binding(self) -> "tuple[Any, Any]":
        """``(pool, lock)`` for an autoscaler's KV actuator: the block
        pool whose serving/spare split it resizes, plus the engine lock
        that guards every pool mutation."""
        if self.kv_layout != "paged":
            raise RuntimeError(
                "KV autoscaling needs kv_layout='paged' (the dense "
                "layout has no block pool to resize)")
        return self._pool, self._lock

    def capacity(self) -> "dict[str, Any]":
        """The one structure a router's weighting reads: identity + room.
        Best-effort reads (no engine lock)."""
        paged = self.kv_layout == "paged"
        # parkable pressure split: cold = refcount-0 cached blocks that
        # COULD page out on demand, parked = blocks already in the
        # host/disk tiers
        cold = parked = sessions = None
        if paged:
            try:
                cold = self._prefix.cold_blocks()
            except RuntimeError:
                cold = None  # racing registration: stale next refresh
            if self._kv_tiers is not None:
                s = self._kv_tiers.stats()
                parked = s["host_blocks"] + s["disk_blocks"]
                try:
                    sessions = self._prefix.parked_sessions()
                except RuntimeError:
                    sessions = None
        return {
            "host_id": self.host_id,
            "replica_count": 1,
            "n_slots": self.n_slots,
            "free_slots": (self.n_slots - len(self._inflight)
                           - len(self._prefilling)),
            "kv_blocks_free": self._pool.free_count if paged else None,
            "kv_blocks_total": self._pool.n_blocks if paged else None,
            "kv_blocks_cold": cold,
            "kv_parked_blocks": parked,
            "kv_parked_sessions": sessions,
            "queue_depth": self.queue.depth,
            "max_queue_depth": self.queue.max_depth,
            "draining": self.queue.closed,
            "overload_level": tenancy.overload_level(),
        }

    def snapshot(self) -> dict[str, Any]:
        out = self.metrics.snapshot(self.queue)
        out["host_id"] = self.host_id
        out["capacity"] = self.capacity()
        out["active_slots"] = self.active_slots
        out["n_slots"] = self.n_slots
        out["kv_layout"] = self.kv_layout
        out["prefill_seconds"] = self._prefill_seconds
        out["kv"] = self._kv_snapshot()
        out["spec"] = self._spec_snapshot()
        out["graphs"] = self._graph_snapshot()
        out["slo"] = (self.slo_tracker.sample()
                      if self.slo_tracker is not None else None)
        return out

    def __enter__(self) -> "ContinuousGPTEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close(drain=exc == (None, None, None))
