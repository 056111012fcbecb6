"""Disaggregated prefill/decode serving on the card.

Prefill and decode are different workloads sharing one engine only by
historical accident: prefill is bursty, compute-bound, and brief;
decode is steady, memory-bound, and long-lived. Colocated, a 3072-token
prompt's chunked prefill shares every engine tick with live decode —
interactive p95 pays for throughput traffic. This package splits them
into separately placed tiers connected by one quantized KV-block
transfer per request:

* :class:`PrefillWorker` — prefill-only engine mode; Futures resolve
  to a :class:`KVHandoff` (the prompt's pool blocks in RAW storage —
  int8 pools ship ~4× fewer wire bytes than fp32 — plus the first
  decode token).
* :class:`DecodeWorker` — decode-tier engine mode; ``submit_handoff``
  installs transferred blocks through the engine's own quantizing
  write path and starts decode with no re-prefill. Greedy tokens stay
  bitwise-identical to the colocated engine's.
* :class:`PhaseRouter` — per-phase placement (prefill: queue depth /
  affinity; decode: slot + KV headroom) and the cross-tier zero-loss
  contract: a handoff lost mid-crossing re-queues at the prefill
  tier's queue head.
* :class:`BatchPrefillFiller` — offline work soaks idle prefill
  capacity, preempted by interactive arrivals.
* :func:`tier_autoscalers` — one
  :class:`~sparkdl_torch.autoscale.AutoScaler` per tier, each on its
  own pressure signal (:func:`prefill_tier_signals`: queue depth;
  :func:`decode_tier_signals`: slot occupancy, with KV exhaustion on the
  burn channel).
"""

from sparkdl_torch.disagg.filler import BatchPrefillFiller
from sparkdl_torch.disagg.handoff import HandoffInstallError, KVHandoff
from sparkdl_torch.disagg.phase_router import PhaseRouter
from sparkdl_torch.disagg.scaling import (
    decode_tier_signals,
    prefill_tier_signals,
    tier_autoscalers,
)
from sparkdl_torch.disagg.workers import DecodeWorker, PrefillWorker

__all__ = [
    "BatchPrefillFiller",
    "DecodeWorker",
    "HandoffInstallError",
    "KVHandoff",
    "PhaseRouter",
    "PrefillWorker",
    "decode_tier_signals",
    "prefill_tier_signals",
    "tier_autoscalers",
]
