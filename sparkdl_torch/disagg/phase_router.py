"""Phase routing: prefill placement and decode placement are different
problems, so each tier gets its own :class:`~sparkdl_torch.fabric.router.Router`.

Prefill is bursty and compute-bound — its router scores on queue depth
(and prompt affinity, so shared prefixes keep landing where their
blocks are cached). Decode is steady and memory-bound — its router
runs the ``headroom`` policy (free slots × KV availability), because a
decode host with slots but no blocks is not headroom at all.

:meth:`PhaseRouter.submit` chains the two: place prefill → Future of a
:class:`~sparkdl_torch.disagg.handoff.KVHandoff` → place the handoff on
the decode tier → the caller's one Future of generated ids. The chain
is callback-driven (no thread parks per request).

**The zero-loss contract crosses tiers.** Each inner Router already
covers failures within its tier (drain/requeue, host-level failover).
The new surface is the crossing itself: a decode-side
:class:`~sparkdl_torch.disagg.handoff.HandoffInstallError` — or a decode
tier whose failover options ran out mid-handoff — re-queues the victim
at the PREFILL tier's queue head via :meth:`Router.requeue`, identity
intact (request id, trace, original enqueue stamp, absolute deadline),
ahead of later arrivals. Bounded by ``max_handoff_retries``; an
accepted request is only ever lost to its own deadline.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future, InvalidStateError
from typing import Any

import numpy as np

from sparkdl_torch.fabric.host import HOST_LEVEL_ERRORS
from sparkdl_torch.fabric.router import Router
from sparkdl_torch.observability import flight
from sparkdl_torch.serving.continuous import GenRequest
from sparkdl_torch.serving.queue import Request

from sparkdl_torch.disagg.handoff import (
    _M_TIER_DEPTH,
    HandoffInstallError,
    KVHandoff,
)

__all__ = ["PhaseRouter"]

#: Errors that re-queue the victim at the prefill tier: the typed
#: install failure, plus a decode tier that lost the request at the
#: host level after the inner router exhausted its failover options.
_REQUEUE_ERRORS = (HandoffInstallError,) + HOST_LEVEL_ERRORS


class PhaseRouter:
    """Route requests across a prefill tier and a decode tier (see
    module docstring). ``prefill_hosts``/``decode_hosts`` are iterables
    of :class:`~sparkdl_torch.fabric.host.HostHandle`; extra
    ``router_kwargs`` reach both inner Routers."""

    def __init__(self, prefill_hosts, decode_hosts, *,
                 prefill_policy: str = "affinity",
                 decode_policy: str = "headroom",
                 max_handoff_retries: int = 2,
                 **router_kwargs):
        if max_handoff_retries < 0:
            raise ValueError(
                f"max_handoff_retries must be >= 0, got "
                f"{max_handoff_retries}")
        self.max_handoff_retries = max_handoff_retries
        self.prefill = Router(prefill_hosts, policy=prefill_policy,
                              **router_kwargs)
        try:
            self.decode = Router(decode_hosts, policy=decode_policy,
                                 **router_kwargs)
        except BaseException:
            self.prefill.close()
            raise
        self._lock = threading.Lock()
        self._closed = False
        self.submitted = 0
        self.completed = 0
        self.failed = 0
        self.requeues = 0
        flight.record_event(
            "disagg.phase_router_start",
            prefill_hosts=len(self.prefill.hosts()),
            decode_hosts=len(self.decode.hosts()))
        # context provider LAST: everything it reads exists by now
        self._flight_name = f"disagg-phase-router-{id(self):x}"
        flight.add_context_provider(self._flight_name, self.snapshot)

    # -- submission -----------------------------------------------------------
    def submit(self, prompt_ids, max_new_tokens: int, *,
               timeout_s: "float | None" = None,
               session: "str | None" = None,
               tenant: str = "default",
               priority: "int | None" = None) -> Future:
        """One Future of the generated ids (first token included) —
        indistinguishable from a colocated engine's ``submit``, except
        the prompt prefilled on one tier and decodes on another.
        ``tenant``/``priority`` ride the payload onto the prefill
        tier's per-tenant scheduler and survive a mid-
        handoff requeue — a background victim re-enters its own class,
        never ahead of interactive work."""
        if self._closed:
            raise RuntimeError("PhaseRouter is closed")
        deadline = (time.monotonic() + timeout_s
                    if timeout_s is not None else None)
        caller: Future = Future()
        caller.set_running_or_notify_cancel()
        with self._lock:
            self.submitted += 1
        self._start_prefill(prompt_ids, max_new_tokens, caller,
                            deadline, session,
                            self.max_handoff_retries,
                            tenant, priority)
        return caller

    @staticmethod
    def _remaining(deadline: "float | None") -> "float | None":
        if deadline is None:
            return None
        # floor just above zero: the tier engines expire it properly,
        # where a negative timeout would be a submit-time ValueError
        return max(1e-3, deadline - time.monotonic())

    def _start_prefill(self, prompt, max_new, caller, deadline,
                       session, retries_left,
                       tenant: str = "default",
                       priority: "int | None" = None) -> None:
        try:
            fut = self.prefill.submit(
                {"prompt": prompt, "max_new_tokens": max_new,
                 "tenant": tenant, "priority": priority},
                timeout_s=self._remaining(deadline), session=session)
        except Exception as e:
            self._finish(caller, exc=e)
            return
        fut.add_done_callback(lambda f: self._on_prefill_done(
            f, caller, deadline, session, retries_left,
            tenant, priority))

    def _on_prefill_done(self, f: Future, caller, deadline, session,
                         retries_left, tenant: str = "default",
                         priority: "int | None" = None) -> None:
        try:
            handoff = f.result()
        except BaseException as e:
            # the prefill Router already burned its own failover
            # options; what reaches here is the request's outcome
            self._finish(caller, exc=e)
            return
        self._start_decode(handoff, caller, deadline, session,
                           retries_left, tenant, priority)

    def _start_decode(self, h: KVHandoff, caller, deadline, session,
                      retries_left, tenant: str = "default",
                      priority: "int | None" = None) -> None:
        try:
            fut = self.decode.submit(
                {"handoff": h}, timeout_s=self._remaining(deadline))
        except Exception as e:
            self._lost_mid_handoff(e, h, caller, deadline, session,
                                   retries_left, tenant, priority)
            return
        fut.add_done_callback(lambda f: self._on_decode_done(
            f, h, caller, deadline, session, retries_left,
            tenant, priority))

    def _on_decode_done(self, f: Future, h, caller, deadline, session,
                        retries_left, tenant: str = "default",
                        priority: "int | None" = None) -> None:
        try:
            self._finish(caller, result=f.result())
        except BaseException as e:
            self._lost_mid_handoff(e, h, caller, deadline, session,
                                   retries_left, tenant, priority)

    def _lost_mid_handoff(self, exc, h, caller, deadline, session,
                          retries_left, tenant: str = "default",
                          priority: "int | None" = None) -> None:
        """The handoff died between tiers. Retryable losses re-enter at
        the prefill tier's queue HEAD; anything else is the request's
        own outcome."""
        if (not isinstance(exc, _REQUEUE_ERRORS)
                or retries_left <= 0 or self._closed):
            self._finish(caller, exc=exc)
            return
        self._requeue_at_prefill(exc, h, caller, deadline, session,
                                 retries_left - 1, tenant, priority)

    def _requeue_at_prefill(self, exc, h: KVHandoff, caller, deadline,
                            session, retries_left,
                            tenant: str = "default",
                            priority: "int | None" = None) -> None:
        """The zero-loss crossing: rebuild the victim as an
        already-accepted :class:`Request` — request id, trace context,
        original enqueue stamp, and absolute deadline all preserved —
        and hand it to :meth:`Router.requeue`, which places it at a
        surviving prefill host's queue head: the victim re-prefills
        AHEAD of requests that arrived after it."""
        with self._lock:
            self.requeues += 1
        flight.record_event(
            "disagg.handoff_requeued", request_id=h.request_id,
            error=type(exc).__name__, retries_left=retries_left)
        # postmortem trigger: a lost crossing is an incident
        # — the dump's incident_id joins this tier's bundle with the
        # prefill tier's (the id rode the handoff wire, or mints here
        # and rides the NEXT export within the TTL)
        flight.trigger_dump(
            "disagg.handoff_lost", request_id=h.request_id,
            error=type(exc).__name__, src_host=h.src_host)
        inner: Future = Future()
        inner.request_id = h.request_id
        inner.set_running_or_notify_cancel()
        from sparkdl_torch.serving import tenancy

        req = Request(
            GenRequest(np.asarray(h.prompt, np.int32),
                       int(h.max_new_tokens)),
            inner,
            deadline if deadline is not None else h.deadline,
            h.enqueued if h.enqueued else time.monotonic(),
            trace_ctx=h.trace_ctx,
            request_id=int(h.request_id),
            started=True,
            tenant=tenant,
            priority=(priority if priority is not None
                      else tenancy.PRIORITY_INTERACTIVE))
        inner.add_done_callback(lambda f: self._on_prefill_done(
            f, caller, deadline, session, retries_left,
            tenant, priority))
        try:
            self.prefill.requeue([req])
        except Exception as e:
            # requeue itself failing resolves inner (or nothing took
            # the request): make sure the caller hears SOMETHING
            if not inner.done():
                self._finish(caller, exc=e)

    def _finish(self, caller: Future, *, result=None,
                exc: "BaseException | None" = None) -> None:
        with self._lock:
            if exc is None:
                self.completed += 1
            else:
                self.failed += 1
        try:
            if exc is not None:
                caller.set_exception(exc)
            else:
                caller.set_result(result)
        except InvalidStateError:
            pass  # already resolved (e.g. double failure report)

    # -- introspection / lifecycle --------------------------------------------
    def tier_depths(self) -> "dict[str, int]":
        """Live queued-request count per tier (and the
        ``sparkdl_disagg_tier_depth`` gauge publication point)."""
        out = {}
        for tier, router in (("prefill", self.prefill),
                             ("decode", self.decode)):
            depth = 0
            for handle in router.host_handles():
                try:
                    depth += int(
                        handle.capacity().get("queue_depth") or 0)
                except Exception:
                    continue  # a dead host holds no queue
            out[tier] = depth
            _M_TIER_DEPTH.set(depth, tier=tier)
        return out

    def refresh(self) -> None:
        """Manual host-state refresh for both tiers (tests run with
        ``auto_refresh=False``); also republishes the depth gauges."""
        self.prefill.refresh()
        self.decode.refresh()
        self.tier_depths()

    def snapshot(self) -> "dict[str, Any]":
        with self._lock:
            counts = {"submitted": self.submitted,
                      "completed": self.completed,
                      "failed": self.failed,
                      "requeues": self.requeues}
        return {"disagg": {
            **counts,
            "prefill_hosts": len(self.prefill.hosts()),
            "decode_hosts": len(self.decode.hosts()),
            "prefill": self.prefill.snapshot(),
            "decode": self.decode.snapshot(),
        }}

    def close(self) -> None:
        """Stop both inner routers. Hosts are NOT closed — the caller
        owns their lifecycle (same contract as :meth:`Router.close`)."""
        if self._closed:
            return
        self._closed = True
        flight.remove_context_provider(self._flight_name)
        try:
            self.prefill.close()
        finally:
            self.decode.close()

    def __enter__(self) -> "PhaseRouter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
