"""Quantized KV-block handoff between serving tiers.

The unit of work a disaggregated fabric moves is not a request — it is
a FINISHED PREFILL: the prompt's KV blocks plus the one token the final
prefill chunk produced. :class:`KVHandoff` packages exactly that, in
the pool's RAW storage layout, so the tier crossing inherits the
quantized pool's wire economics for free:

* an ``int8`` pool ships ``int8`` values plus one fp32 scale per
  written column (``models.gpt.quantize_kv``'s layout) — per token that
  is ``2·hidden + 8`` bytes against fp32's ``8·hidden``, a
  ``4/(1 + 4/hidden)``× reduction (3.56× at hidden=32, →4× as hidden
  grows);
* the decode-side install dequantizes (``q·s``, exact) and rides the
  engine's shared ``_q_write`` path, whose requantize is the exact
  round trip ``quantize_kv`` documents (absmax maps to ±127) — so a
  transferred block is BITWISE-identical to one the decode host would
  have prefilled itself, and greedy tokens cannot drift across the
  split.

Identity crosses with the data: ``request_id`` (= trace id, fleet-unique
), the serialized trace ``SpanContext`` (so decode-tier
spans parent into the SAME trace the prefill tier started), the live
flight-recorder ``incident_id`` if any (so both tiers' postmortem
bundles join on one incident), the absolute deadline (re-anchored as
remaining seconds over the HTTP transport — monotonic clocks do not
cross processes; the export stamp re-anchors the same way, as elapsed
age), and the original enqueue stamp, so latency accounting and the
zero-loss requeue contract see ONE request end to end. The prefill
tier's measured ``queue_wait_s``/``prefill_s`` ship as DURATIONS (clock-
safe), feeding the decode-side per-request phase attribution
(``sparkdl_request_phase_seconds{phase,tier}``). The object duck-types
:class:`~sparkdl_torch.serving.continuous.GenRequest`
(``.prompt``/``.max_new_tokens``), so the decode engine's deferral path
treats an adopted handoff like any admitted request.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any

import numpy as np

from sparkdl_torch.observability import tracing
from sparkdl_torch.observability.registry import registry
from sparkdl_torch.serving.kv_codec import decode as _dec
from sparkdl_torch.serving.kv_codec import encode as _enc

__all__ = ["HandoffInstallError", "KVHandoff", "observe_phase"]

_M_HANDOFFS = registry().counter(
    "sparkdl_disagg_handoffs_total",
    "KV-block handoffs between serving tiers, by stage (export = "
    "prefill-side gather+package complete; install = decode-side "
    "blocks installed, decode started without re-prefill)",
    labels=("stage",))
_M_HANDOFF_BYTES = registry().counter(
    "sparkdl_disagg_handoff_bytes_total",
    "K/V payload bytes exported on the tier-crossing wire (int8 pools "
    "ship quantized values + per-column scales — ~4x fewer bytes than "
    "fp32 at serving hidden sizes)")
_M_HANDOFF_SECONDS = registry().histogram(
    "sparkdl_disagg_handoff_seconds",
    "per-stage handoff cost: one observation for the prefill-side "
    "export gather, one for the decode-side install dispatch")
_M_TIER_DEPTH = registry().gauge(
    "sparkdl_disagg_tier_depth",
    "queued requests per disaggregated serving tier",
    labels=("tier",))
_M_PHASE_SECONDS = registry().histogram(
    "sparkdl_request_phase_seconds",
    "per-request latency attribution: where one request's "
    "wall time went — (queue,prefill) submit→take, (compute,prefill) "
    "take→export, (wire,handoff) export→decode-tier arrival, "
    "(queue,decode) arrival→admit, (compute,decode) admit→done. The "
    "five phases telescope: their sum IS the request's end-to-end "
    "latency (asserted by run-tests.sh)",
    labels=("phase", "tier"))


def observe_phase(phase: str, tier: str, seconds: float) -> None:
    """Record one request's time in one phase (clamped at 0 — phase
    boundaries are monotonic stamps, but cross-process re-anchoring can
    produce a negative hairline)."""
    _M_PHASE_SECONDS.observe(max(0.0, float(seconds)),
                             phase=phase, tier=tier)


class HandoffInstallError(RuntimeError):
    """The decode tier failed to install a transferred KV handoff (the
    ``handoff.install`` fault site). A REQUEST-level error by the
    fabric's taxonomy — the host is healthy — but a retryable one: the
    :class:`~sparkdl_torch.disagg.PhaseRouter` answers it by re-queuing
    the victim at the PREFILL tier's queue head (zero accepted
    requests lost; the cross-tier half of the drain contract)."""


@dataclasses.dataclass
class KVHandoff:
    """One finished prefill, packaged for the tier crossing (see module
    docstring). ``k``/``v`` are the prompt's blocks in RAW pool storage
    ``[num_layers, n_blocks, block_size, heads, head_dim]`` (int8/bf16/
    fp32 per ``kv_dtype``; bf16 as its 16-bit patterns in a
    :class:`~sparkdl_torch.serving.kv_codec.BF16Bits` array — numpy has
    no bfloat16 — which the wire carries as ``"bfloat16"``, as the JAX
    package writes it); ``k_scale``/``v_scale`` are the int8
    layout's per-column fp32 scales ``[num_layers, n_blocks,
    block_size]`` (None otherwise). ``first_token`` seeds decode — the
    argmax the final prefill chunk computed, so the decode tier never
    re-runs the prompt."""

    prompt: np.ndarray
    max_new_tokens: int
    first_token: int
    kv_dtype: str
    block_size: int
    k: np.ndarray
    v: np.ndarray
    k_scale: "np.ndarray | None" = None
    v_scale: "np.ndarray | None" = None
    request_id: int = 0
    deadline: "float | None" = None
    enqueued: float = 0.0
    trace_ctx: Any = None
    src_host: "str | None" = None
    #: monotonic stamp (LOCAL clock) of export completion on the
    #: prefill tier; re-anchored as elapsed age over the wire, exactly
    #: like the deadline — the ``handoff.wire`` span's start
    exported_at: "float | None" = None
    #: monotonic stamp (LOCAL clock) of arrival on the decode tier
    #: (``from_wire``/``submit_handoff``): the wire→decode-queue phase
    #: boundary
    arrived_at: "float | None" = None
    #: prefill-tier measured durations (clock-safe across processes):
    #: submit→take and take→export — the decode side publishes all five
    #: request phases from one place using these
    queue_wait_s: float = 0.0
    prefill_s: float = 0.0
    #: live flight-recorder incident id at export time: the
    #: decode tier adopts it so both tiers' postmortem bundles join
    incident_id: "str | None" = None

    @property
    def n_blocks(self) -> int:
        return int(self.k.shape[1])

    @property
    def wire_bytes(self) -> int:
        """K/V payload bytes this handoff moves (the quantity the int8
        wire-cost arithmetic in the module docstring bounds)."""
        n = int(self.k.nbytes) + int(self.v.nbytes)
        if self.k_scale is not None:
            n += int(self.k_scale.nbytes) + int(self.v_scale.nbytes)
        return n

    def to_wire(self) -> dict:
        """JSON-safe dict (base64 tensors) for the ``HostServer``
        transport. The absolute monotonic deadline ships as REMAINING
        seconds and re-anchors on arrival; ``exported_at`` ships the
        same way (as elapsed ``export_age_s``); ``trace_ctx`` crosses
        as a serialized :class:`~sparkdl_torch.observability.tracing.
        SpanContext` so decode-tier spans parent into the prefill
        tier's trace."""
        out = {
            "prompt": [int(t) for t in self.prompt],
            "max_new_tokens": int(self.max_new_tokens),
            "first_token": int(self.first_token),
            "kv_dtype": self.kv_dtype,
            "block_size": int(self.block_size),
            "k": _enc(self.k),
            "v": _enc(self.v),
            "request_id": int(self.request_id),
            "src_host": self.src_host,
            "queue_wait_s": float(self.queue_wait_s),
            "prefill_s": float(self.prefill_s),
        }
        trace = tracing.context_to_wire(self.trace_ctx)
        if trace is not None:
            out["trace"] = trace
        if self.incident_id:
            out["incident_id"] = str(self.incident_id)
        if self.deadline is not None:
            out["remaining_s"] = max(
                0.0, self.deadline - time.monotonic())
        if self.exported_at is not None:
            out["export_age_s"] = max(
                0.0, time.monotonic() - self.exported_at)
        if self.k_scale is not None:
            out["k_scale"] = _enc(self.k_scale)
            out["v_scale"] = _enc(self.v_scale)
        return out

    @classmethod
    def from_wire(cls, d: dict) -> "KVHandoff":
        now = time.monotonic()
        deadline = None
        if "remaining_s" in d:
            deadline = now + float(d["remaining_s"])
        exported_at = None
        if "export_age_s" in d:
            exported_at = now - float(d["export_age_s"])
        return cls(
            prompt=np.asarray(d["prompt"], np.int32),
            max_new_tokens=int(d["max_new_tokens"]),
            first_token=int(d["first_token"]),
            kv_dtype=str(d["kv_dtype"]),
            block_size=int(d["block_size"]),
            k=_dec(d["k"]),
            v=_dec(d["v"]),
            k_scale=_dec(d["k_scale"]) if "k_scale" in d else None,
            v_scale=_dec(d["v_scale"]) if "v_scale" in d else None,
            request_id=int(d.get("request_id") or 0),
            deadline=deadline,
            enqueued=now,
            trace_ctx=tracing.context_from_wire(d.get("trace")),
            src_host=d.get("src_host"),
            exported_at=exported_at,
            arrived_at=now,
            queue_wait_s=float(d.get("queue_wait_s") or 0.0),
            prefill_s=float(d.get("prefill_s") or 0.0),
            incident_id=d.get("incident_id"),
        )
