"""Tier workers: the prefill-only and decode-only engine modes.

Both are thin subclasses of
:class:`~sparkdl_torch.serving.continuous.ContinuousGPTEngine` — the
split reuses the colocated engine's admission, chunked prefill,
deferral, expiry, and decode machinery wholesale and overrides exactly
the seams where a phase boundary exists:

* :class:`PrefillWorker` ends a request where decode would begin:
  ``_finish_prefill`` exports the prompt's pool blocks (raw storage —
  int8 pools ship quantized bytes + scales, bf16 pools their 16-bit
  patterns) instead of occupying a decode slot, and its Futures resolve
  to :class:`~sparkdl_torch.disagg.handoff.KVHandoff`. Admission
  reserves PROMPT blocks only (``_admission_budget_tokens`` → 0): the
  tier's pool capacity is spent entirely on prefill concurrency, which
  is why a prefill tier absorbs long prompts without inflating anyone's
  decode latency.
* :class:`DecodeWorker` begins a request where prefill ended:
  ``submit_handoff`` adopts a transferred handoff into the queue
  (already-accepted — depth limits do not re-reject it) and
  ``_admit_handoff`` installs the wire blocks through the engine's own
  quantizing write path (``_q_write``, in place on the card's pool, so
  the decode step's captured graphs keep their addresses), then hands
  the slot to the untouched decode loop. No prompt token is ever re-run
  on the decode tier.

The export is one gather of the prompt's blocks on the prefill card and
one copy to the host; the install is one host-to-card copy of the wire
blocks and one ``_q_write``. The two workers may sit on different cards
(or hosts): the handoff crosses through host memory.

Failure surfaces are the two fault sites: ``handoff.export`` tears
down like ``_sp_abort`` (blocks released, victim re-queued at the
head, zero loss) and ``handoff.install`` raises the typed
:class:`~sparkdl_torch.disagg.handoff.HandoffInstallError` the
:class:`~sparkdl_torch.disagg.PhaseRouter` converts into a prefill-tier
requeue.
"""

from __future__ import annotations

import time
from concurrent.futures import Future
from typing import Any

import numpy as np
import torch

from sparkdl_torch.models.gpt import dequantize_kv
from sparkdl_torch.observability import flight as flight_mod
from sparkdl_torch.observability import tracing
from sparkdl_torch.observability.tracing import span
from sparkdl_torch.reliability.faults import fault_point
from sparkdl_torch.runtime.completion import start_fetch
from sparkdl_torch.serving import kv_codec
from sparkdl_torch.serving.continuous import ContinuousGPTEngine, _InFlight
from sparkdl_torch.serving.queue import Request

from sparkdl_torch.disagg.handoff import (
    _M_HANDOFF_BYTES,
    _M_HANDOFF_SECONDS,
    _M_HANDOFFS,
    HandoffInstallError,
    KVHandoff,
    observe_phase,
)

__all__ = ["DecodeWorker", "PrefillWorker"]


def _require_paged(kwargs: dict, who: str) -> None:
    if kwargs.get("kv_layout", "paged") != "paged":
        raise ValueError(
            f"{who} requires kv_layout='paged': the block pool is the "
            "unit the tier crossing transfers")


def _upload(a: np.ndarray, device) -> torch.Tensor:
    """One wire array on ``device`` in its storage dtype: the wire's own
    bytes cross the host link (a
    :class:`~sparkdl_torch.serving.kv_codec.BF16Bits` array as bfloat16,
    the patterns reinterpreted, never converted)."""
    bf16 = isinstance(a, kv_codec.BF16Bits)
    a = np.ascontiguousarray(a)
    if bf16:
        a = a.view(np.int16)  # numpy has no bfloat16: move the patterns
    t = torch.from_numpy(a).to(device)
    return t.view(torch.bfloat16) if bf16 else t


class PrefillWorker(ContinuousGPTEngine):
    """A :class:`ContinuousGPTEngine` that ONLY prefills (see module
    docstring). ``submit()`` keeps the colocated signature; the Future
    resolves to a :class:`KVHandoff` instead of generated ids. Chunked
    (and, with ``sp > 1``, sequence-parallel) prefill, prefix caching,
    deferral, and deadline expiry all behave exactly as on the
    colocated engine."""

    def __init__(self, config, model, **kwargs):
        _require_paged(kwargs, "PrefillWorker")
        auto_start = kwargs.pop("auto_start", True)
        super().__init__(config, model, auto_start=False, **kwargs)
        self._handoffs = 0
        self._export_aborts = 0
        if auto_start:
            self.start()

    def _admission_budget_tokens(self, max_new_tokens: int) -> int:
        # prompt blocks only: the decode tier owns the generation span
        return 0

    def _export(self, row: "list[int]") -> "dict[str, np.ndarray]":
        """The prompt's blocks in RAW storage, on the host: ``k``, ``v``
        (and the int8 layout's ``k_scale``, ``v_scale``; bfloat16 as its
        16-bit patterns, :class:`~sparkdl_torch.serving.kv_codec.BF16Bits`).
        No dequantize: the wire ships the pool's own bytes, so the
        decode-side install's requantize round-trips exactly. One gather
        on the card, then one copy into page-locked memory
        (``start_fetch``), which completes before this returns — the
        caller drops the block references only after (releasing first
        would let an eviction + realloc overwrite a block mid-copy)."""
        with torch.no_grad():
            ticket = start_fetch(self._raw_block(self._dev(row)),
                                 path="handoff")
            # the one wait: the event behind this gather's enqueued copy
            host = {n: np.asarray(a) for n, a in ticket.result().items()}
        # int16 is _raw_block's view of bfloat16 (int8 codes stay int8)
        return {n: kv_codec.bf16_bits(a) if a.dtype == np.int16 else a
                for n, a in host.items()}

    def _finish_prefill(self, slot, st, first) -> None:
        """Export instead of decode: package the prompt's pool blocks
        (+ the first decode token the final chunk computed) as a
        :class:`KVHandoff` and resolve the Future with it. The prompt
        stays registered in THIS tier's prefix cache, so a later prompt
        sharing the prefix prefills only its suffix before exporting."""
        try:
            # the injectable stand-in for a failed export gather or a
            # dead wire: fires BEFORE the prefix registration, so the
            # abort path releases a state identical to _sp_abort's
            fault_point("handoff.export")
        except Exception as e:
            self._export_abort(slot, st, e)
            return
        blocks = st.shared + st.owned
        plen = len(st.prompt)
        nbp = -(-plen // self._kv_bs)
        row = [int(b) for b in blocks[:nbp]]
        # register BEFORE releasing the request's holds: the cache's
        # own hold keeps the prompt blocks alive for prefix reuse
        self._prefix.register(tuple(int(t) for t in st.prompt), row)
        t0 = time.perf_counter()
        with span("disagg.handoff_export", parent=st.req.trace_ctx,
                  request_id=st.req.request_id, slot=slot, blocks=nbp):
            out = self._export(row)
        _M_HANDOFF_SECONDS.observe(time.perf_counter() - t0)
        self._first_token(st.req)
        del self._prefilling[slot]
        self._prefix.release(blocks)
        # phase boundaries: the export stamp ends this tier's work;
        # queue/prefill ship as measured DURATIONS so the decode tier
        # can publish all five phases without sharing a clock with us
        exported_at = time.monotonic()
        taken = st.req.taken_at if st.req.taken_at is not None \
            else st.req.enqueued
        h = KVHandoff(
            prompt=st.prompt, max_new_tokens=st.max_new,
            first_token=int(first), kv_dtype=self.kv_dtype,
            block_size=self._kv_bs,
            k=out["k"], v=out["v"],
            k_scale=out.get("k_scale"), v_scale=out.get("v_scale"),
            request_id=st.req.request_id, deadline=st.req.deadline,
            enqueued=st.req.enqueued, trace_ctx=st.req.trace_ctx,
            src_host=self.host_id,
            exported_at=exported_at,
            queue_wait_s=max(0.0, taken - st.req.enqueued),
            prefill_s=max(0.0, exported_at - taken),
            incident_id=flight_mod.current_incident_id())
        self._handoffs += 1
        _M_HANDOFFS.inc(stage="export")
        _M_HANDOFF_BYTES.inc(h.wire_bytes)
        flight_mod.record_event(
            "disagg.handoff_export", request_id=st.req.request_id,
            host=self.host_id, blocks=nbp, bytes=h.wire_bytes)
        now = time.monotonic()
        self._record_request_span(st.req, now, ok=True, tokens=1)
        st.req.future.set_result(h)
        self.metrics.record_request(now - st.req.enqueued, ok=True)

    def _export_abort(self, slot, st, exc: Exception) -> None:
        """An injected ``handoff.export`` fault: tear down exactly like
        ``_sp_abort`` — every block released (staging included), victim
        re-queued at the HEAD (it is owed its place ahead of later
        arrivals), nothing lost. The re-run re-prefills from scratch;
        correctness over the partial work."""
        del self._prefilling[slot]
        self._release_sp_staging(st)
        self._prefix.release(st.all_blocks())
        self._export_aborts += 1
        flight_mod.record_event(
            "disagg.handoff_export_failed",
            request_id=st.req.request_id, host=self.host_id,
            error=type(exc).__name__, prompt_tokens=len(st.prompt))
        self.queue.requeue([st.req])

    def snapshot(self) -> "dict[str, Any]":
        out = super().snapshot()
        out["disagg"] = {"tier": "prefill", "handoffs": self._handoffs,
                         "export_aborts": self._export_aborts}
        return out


class DecodeWorker(ContinuousGPTEngine):
    """A :class:`ContinuousGPTEngine` whose slots start at decode (see
    module docstring). Regular ``submit()`` still works (a decode tier
    can colocate small prompts); ``submit_handoff`` is the cross-tier
    admission surface :class:`~sparkdl_torch.fabric.host.InProcessHost`
    and the HTTP transport route ``{"handoff": ...}`` payloads to."""

    def __init__(self, config, model, **kwargs):
        _require_paged(kwargs, "DecodeWorker")
        auto_start = kwargs.pop("auto_start", True)
        super().__init__(config, model, auto_start=False, **kwargs)
        self._installs = 0
        self._install_faults = 0
        if auto_start:
            self.start()

    # -- cross-tier admission -------------------------------------------------
    def submit_handoff(self, handoff: KVHandoff, *,
                       timeout_s: "float | None" = None) -> Future:
        """Adopt one finished prefill. The Future resolves to generated
        ids exactly like ``submit()``'s would have (first token
        included), so callers cannot tell the phases were split.

        Identity carries over: the handoff's request id IS this
        request's id (one trace end to end), its original enqueue stamp
        feeds latency accounting, and its absolute deadline still
        binds (tightened by ``timeout_s`` if given). The request
        enters via ``queue.adopt`` — already accepted upstream, so the
        depth limit never re-rejects it."""
        h = handoff
        if int(h.block_size) != self._kv_bs:
            raise ValueError(
                f"handoff block_size {h.block_size} != decode tier "
                f"block_size {self._kv_bs}: tiers must agree on the "
                "block geometry")
        self._check_wire(h)
        plen = len(h.prompt)
        if plen + h.max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt ({plen}) + max_new_tokens ({h.max_new_tokens})"
                f" exceeds decode-tier max_len {self.max_len}")
        need = -(-(plen + h.max_new_tokens) // self._kv_bs)
        if need > self._pool.n_blocks:
            raise ValueError(
                f"request needs {need} KV blocks; decode-tier pool has "
                f"{self._pool.n_blocks} total — it can never fit")
        deadline = h.deadline
        if timeout_s is not None:
            cap = time.monotonic() + timeout_s
            deadline = cap if deadline is None else min(deadline, cap)
        if h.arrived_at is None:
            # in-process crossing (no from_wire): arrival is now
            h.arrived_at = time.monotonic()
        # postmortem correlation: if the prefill tier was mid-incident
        # at export, this tier's next dump joins it
        flight_mod.adopt_incident(h.incident_id)
        rid = int(h.request_id) or tracing.next_request_id()
        fut: Future = Future()
        fut.request_id = rid
        # straight to RUNNING: adopted requests skip take()'s handshake
        # (started=True), and a PENDING Future could be cancelled out
        # from under the install
        fut.set_running_or_notify_cancel()
        req = Request(
            h, fut, deadline,
            h.enqueued if h.enqueued else time.monotonic(),
            trace_ctx=(h.trace_ctx if h.trace_ctx is not None
                       else tracing.request_context(rid)),
            request_id=rid,
            started=True)
        self.queue.adopt(req)
        return fut

    def _check_wire(self, h: KVHandoff) -> None:
        """Raise ``ValueError`` unless ``h`` holds what the install
        writes: the prompt's ceil(len/block_size) blocks in this tier's
        pool geometry, int8 codes with their scales exactly when the wire
        is int8, and a first token in the vocabulary. A handoff may
        arrive over the wire (``HostServer``): one that fails here is
        refused before admission takes any block."""
        plen, first = len(h.prompt), int(h.first_token)
        if plen < 1 or h.max_new_tokens < 1:
            raise ValueError(
                f"handoff needs a non-empty prompt and max_new_tokens >= 1,"
                f" got {plen} and {h.max_new_tokens}")
        if not 0 <= first < self.config.vocab_size:
            raise ValueError(
                f"handoff first_token {first} is outside the vocabulary "
                f"[0, {self.config.vocab_size})")
        layers, _, bs, heads, hd = self._pool_kv["k"].shape
        want = (layers, -(-plen // bs), bs, heads, hd)
        int8 = h.kv_dtype == "int8"
        for name in ("k", "v"):
            a = getattr(h, name)
            shape = None if a is None else tuple(np.shape(a))
            if shape != want:
                raise ValueError(
                    f"handoff {name} has shape {shape}; this tier's pool "
                    f"takes {want} for a {plen}-token prompt")
            kind = np.asarray(a).dtype
            ok = (kind == np.int8 if int8 else
                  isinstance(a, kv_codec.BF16Bits) or kind.kind == "f")
            if not ok:
                raise ValueError(
                    f"handoff {name} of dtype {kind} does not carry "
                    f"kv_dtype {h.kv_dtype!r} blocks")
        for name in ("k_scale", "v_scale"):
            a = getattr(h, name)
            shape = None if a is None else tuple(np.shape(a))
            if shape != (want[:3] if int8 else None):
                raise ValueError(
                    f"handoff {name} has shape {shape}; an "
                    f"{'int8' if int8 else h.kv_dtype} wire takes "
                    f"{want[:3] if int8 else None}")

    def _admit(self, slot: int, req: Request) -> bool:
        if isinstance(req.payload, KVHandoff):
            return self._admit_handoff(slot, req)
        return super()._admit(slot, req)

    def _admit_handoff(self, slot: int, req: Request) -> bool:
        """Install a transferred handoff into this tier's pool and
        start decode with NO re-prefill. Mirrors ``_admit_paged`` +
        ``_finish_prefill``: longest-prefix match first (full blocks
        only — the wire carries every block whole, so a partial-tail
        COW copy buys nothing), worst-case allocation under the same
        deferral protocol, install through the shared quantizing write
        path, then prefix registration so the transferred prompt is
        shareable on THIS tier too. Returns False on pool exhaustion
        (caller defers — the handoff duck-types GenRequest). Raises
        :class:`HandoffInstallError` when the ``handoff.install`` site
        fires — a request-level error the PhaseRouter answers with a
        prefill-tier requeue."""
        try:
            fault_point("handoff.install")
        except Exception as e:
            self._install_faults += 1
            flight_mod.record_event(
                "disagg.handoff_install_failed",
                request_id=req.request_id, host=self.host_id,
                error=type(e).__name__)
            raise HandoffInstallError(
                f"KV handoff install failed on host {self.host_id}: "
                f"{e!r}") from e
        h: KVHandoff = req.payload
        prompt = np.asarray(h.prompt, np.int32)
        plen = len(prompt)
        toks = tuple(int(t) for t in prompt)
        nbp = -(-plen // self._kv_bs)
        nb_total = -(-(plen + h.max_new_tokens) // self._kv_bs)
        m = self._prefix.match(toks[:-1])
        if m.partial_block is not None:
            # full blocks only (see docstring): drop the partial hold
            self._prefix.release([m.partial_block])
        shared = m.full_blocks
        n_shared = len(shared)
        try:
            owned = self._alloc_blocks(nb_total - n_shared)
        except Exception as e:
            # an injected kv.alloc fault is exhaustion here too: defer,
            # never fail the transferred request
            flight_mod.record_event(
                "kv.alloc_error", error=type(e).__name__,
                request_id=req.request_id)
            owned = None
        if owned is None:
            self._prefix.release(shared)
            self._defer_pool = self._pool
            return False
        # commit point: blocks are allocated, the install WILL run.
        # Everything before this stamp is decode-queue time; everything
        # after (install + decode loop) is decode-compute time.
        t_adm = time.monotonic()
        self._prefix.record_lookup(m.hit_tokens, plen - m.hit_tokens)
        if m.hit_tokens:
            flight_mod.record_event(
                "kv.prefix_hit", request_id=req.request_id,
                hit_tokens=m.hit_tokens, prompt_tokens=plen)
        # install targets: owned blocks at the non-shared prompt
        # positions (the shared ones hold the cached blocks' content;
        # decode writes the blocks past the prompt)
        t0 = time.perf_counter()
        try:
            with span("disagg.handoff_install", parent=req.trace_ctx,
                      request_id=req.request_id, slot=slot, blocks=nbp,
                      shared_blocks=n_shared):
                self._install(h, n_shared, owned[:nbp - n_shared])
        except Exception:
            # the request fails with this error; no table or trie holds
            # these blocks yet, so hand them back or they leak
            self._prefix.release(shared + owned)
            raise
        _M_HANDOFF_SECONDS.observe(time.perf_counter() - t0)
        _M_HANDOFFS.inc(stage="install")
        self._installs += 1
        row = np.full((self._mb,), self._pool.sentinel, np.int64)
        row[:n_shared] = shared
        row[n_shared:nb_total] = owned
        self._table[slot] = row
        self._prefix.register(toks, [int(b) for b in row[:nbp]])
        self._pidx[slot] = plen
        self._last_tok[slot] = int(h.first_token)
        self._first_token(req)
        fl = _InFlight(req, [int(h.first_token)], h.max_new_tokens,
                       blocks=shared + owned, prompt=prompt)
        self._inflight[slot] = fl
        self._pool.reset_deferral_streak()
        # latency attribution: this is the single place all five
        # request phases publish from — the prefill tier shipped its two
        # as measured durations; wire/queue/compute are local stamps on
        # THIS clock. fl carries the admit stamp so _complete() can
        # close the (compute, decode) phase.
        arrived = h.arrived_at if h.arrived_at is not None else t_adm
        observe_phase("queue", "prefill", h.queue_wait_s)
        observe_phase("compute", "prefill", h.prefill_s)
        if h.exported_at is not None:
            wire_s = max(0.0, arrived - h.exported_at)
            observe_phase("wire", "handoff", wire_s)
            # the wire crossing as a span: recorded retroactively on
            # the DECODE host (re-anchored export stamp → install end),
            # parented into the request's one fleet-wide trace
            tracing.record_span(
                "handoff.wire", h.exported_at, time.monotonic(),
                parent=req.trace_ctx, request_id=req.request_id,
                src_host=h.src_host, dst_host=self.host_id,
                bytes=h.wire_bytes, wire_s=wire_s,
                decode_queue_s=max(0.0, t_adm - arrived),
                # the prefill tier's measured durations ride along so
                # fleet stitching reads ALL five phases off this one
                # span
                queue_wait_s=float(h.queue_wait_s),
                prefill_s=float(h.prefill_s))
        observe_phase("queue", "decode", max(0.0, t_adm - arrived))
        fl._phase_admit_start = t_adm
        flight_mod.record_event(
            "disagg.handoff_installed", request_id=req.request_id,
            host=self.host_id, blocks=nbp, shared_blocks=n_shared,
            src_host=h.src_host)
        if self._is_done(fl):  # max_new_tokens=1, or instant eos
            self._complete(slot)
        return True

    def _install(self, h: KVHandoff, n_shared: int,
                 targets: "list[int]") -> None:
        """The wire's blocks past the shared prefix -> ``targets`` of
        this tier's pool, through ``_q_write`` (quantized pools quantize
        HERE — the exact requantize round trip that keeps a transferred
        block bitwise-identical to a local prefill's)."""
        if not targets:
            return
        sel = slice(n_shared, n_shared + len(targets))
        with torch.no_grad():
            k, v = self._wire_to_compute(h, sel)
            self._q_write((self._dev(targets),), k, v)

    def _complete(self, slot: int) -> None:
        # close the (compute, decode) phase for adopted handoffs: the
        # admit stamp rides the _InFlight (dies with it — failure-safe)
        fl = self._inflight.get(slot)
        t_adm = getattr(fl, "_phase_admit_start", None)
        if t_adm is not None:
            observe_phase("compute", "decode",
                          time.monotonic() - t_adm)
        super()._complete(slot)

    def _wire_to_compute(self, h: KVHandoff, sel: slice):
        """Wire blocks ``sel`` → block data at the compute dtype on this
        tier's card: the raw storage crosses the host link, then int8
        dequantizes there exactly (``dequantize_kv``, the pool's own
        read); since the wire values ORIGINATED from the storage dtype,
        every downstream cast or requantize round-trips exactly —
        transferred blocks land bitwise-identical to locally prefilled
        ones."""
        dt = self.config.dtype
        k = _upload(h.k[:, sel], self.device)
        v = _upload(h.v[:, sel], self.device)
        if h.k_scale is None:
            return k.to(dt), v.to(dt)
        return (dequantize_kv(k, _upload(h.k_scale[:, sel], self.device), dt),
                dequantize_kv(v, _upload(h.v_scale[:, sel], self.device), dt))

    def snapshot(self) -> "dict[str, Any]":
        out = super().snapshot()
        out["disagg"] = {"tier": "decode", "installs": self._installs,
                         "install_faults": self._install_faults}
        return out
