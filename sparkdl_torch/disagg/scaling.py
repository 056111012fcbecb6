"""Per-tier autoscaling: each tier scales on ITS OWN pressure signal.

A disaggregated fabric decouples more than placement — it decouples
capacity planning. Prefill pressure is QUEUE DEPTH: prompts are bursty,
each occupies a slot briefly, and a backlog means the tier needs more
compute. Decode pressure is OCCUPANCY: requests camp on slots for their
whole generation span, and the binding resource is KV blocks — a
decode tier in a deferral streak is out of memory, not out of queue.

These readers adapt both signals to the
:class:`~sparkdl_torch.autoscale.controller.AutoScaler`'s two-channel
``signals`` contract ``(queue_depth, burn)``: the prefill reader feeds
raw tier depth; the decode reader feeds waiting + running work per the
depth channel and maps KV exhaustion (a host's ``degraded`` health,
which an exhaustion streak sets) onto the burn channel — so the
existing control law (hysteresis, cooldown, veto) drives both tiers
unmodified, each against the bound that actually constrains it.

:func:`tier_autoscalers` wires the pair: each scaler binds its tier's
Router as the fabric actuator, so scale-down drains + parks a host
handle and scale-up re-opens a parked one (the rejoin path).
"""

from __future__ import annotations

import time
from typing import Callable

from sparkdl_torch.disagg.handoff import _M_TIER_DEPTH

__all__ = [
    "decode_tier_signals",
    "prefill_tier_signals",
    "tier_autoscalers",
]


def prefill_tier_signals(phase_router) -> "Callable[[], tuple]":
    """An ``AutoScaler(signals=...)`` reader for the PREFILL tier:
    queued prompts across the tier's hosts (burn channel unused —
    prefill work has no per-token SLO of its own; the decode tier
    carries the latency objective)."""

    def read() -> "tuple[float, float]":
        depth = 0
        for handle in phase_router.prefill.host_handles():
            try:
                depth += int(handle.capacity().get("queue_depth") or 0)
            except Exception:
                continue
        _M_TIER_DEPTH.set(depth, tier="prefill")
        return float(depth), 0.0

    return read


def decode_tier_signals(phase_router) -> "Callable[[], tuple]":
    """An ``AutoScaler(signals=...)`` reader for the DECODE tier:
    occupied slots + queued handoffs on the depth channel; KV-block
    exhaustion — any host reading ``degraded``, which is exactly what
    a deferral streak sets — saturates the burn channel, so block
    starvation scales the tier up even while slots look free."""

    def read() -> "tuple[float, float]":
        pressure = 0
        depth = 0
        burn = 0.0
        for handle in phase_router.decode.host_handles():
            try:
                cap = handle.capacity()
                health = handle.health()
            except Exception:
                continue
            n = int(cap.get("n_slots") or 0)
            free = int(cap.get("free_slots") or 0)
            q = int(cap.get("queue_depth") or 0)
            pressure += max(0, n - free) + q
            depth += q
            if health.get("status") == "degraded":
                burn = 1.0
        _M_TIER_DEPTH.set(depth, tier="decode")
        return float(pressure), burn

    return read


def tier_autoscalers(phase_router, *, prefill_policy=None,
                     decode_policy=None, interval_s: float = 0.25,
                     clock=time.monotonic):
    """Build one :class:`AutoScaler` per tier (neither started — call
    ``.start()`` or drive ``tick()`` manually), each bound to its
    tier's Router and its tier's signal reader. Returns
    ``(prefill_scaler, decode_scaler)``."""
    from sparkdl_torch.autoscale.controller import (
        AutoscalePolicy,
        AutoScaler,
    )

    prefill = AutoScaler(
        router=phase_router.prefill,
        policy=prefill_policy or AutoscalePolicy(),
        signals=prefill_tier_signals(phase_router),
        interval_s=interval_s, clock=clock)
    try:
        decode = AutoScaler(
            router=phase_router.decode,
            policy=decode_policy or AutoscalePolicy(),
            signals=decode_tier_signals(phase_router),
            interval_s=interval_s, clock=clock)
    except BaseException:
        prefill.close()
        raise
    return prefill, decode
