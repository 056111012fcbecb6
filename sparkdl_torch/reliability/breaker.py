"""ProbationBreaker: the quarantine/probation state machine.

A copy of ``sparkdl_tpu.reliability.breaker`` (framework-free). The
reference's ReplicaPool and fabric Router share it; in the port its
consumer is :class:`~sparkdl_torch.serving.replicas.ReplicaPool`.
``max_failures`` *consecutive* failures open the circuit (quarantine),
after ``probation_s`` ONE live probe is due, probe success closes the
circuit, probe failure doubles the backoff up to ``probation_max_s``.

Deliberately NOT thread-safe: each consumer mutates its breakers under
its own lock (the pool lock). The breaker carries no metrics or flight
events either — those are consumer-owned (``sparkdl_replica_*``).

Transition verbs:

* :meth:`record_failure` — one NON-probe failure; opens the circuit
  (returns True) when the consecutive-failure streak reaches
  ``max_failures``, scheduling the first probe ``probation_s`` out.
* :meth:`record_probe_failure` — a probation probe failed: stay open,
  double the backoff (capped at ``probation_max_s``), reschedule.
* :meth:`record_success` — any success: streak and backoff reset, an
  in-flight probe slot releases, and an open circuit closes (returns
  True — the consumer's "reintegrated" event/metric hook).
* :meth:`probe_due` / :meth:`begin_probe` / :meth:`release_probe` —
  probe scheduling: at most one probe in flight (``probing``);
  ``release_probe`` frees the slot on an *inconclusive* outcome (the
  probe's request failed for its own reasons, saying nothing about the
  host — without the release the circuit would never close).
* :meth:`trip` / :meth:`schedule_probe` — direct open (the hung-dispatch
  watchdog quarantines without a failure streak) and explicit probe
  (re)scheduling for consumers that gate probes on extra state (the
  pool's hung-freeze lifts by scheduling a probe one backoff out).

``probation_s=None`` disables probes entirely — an opened circuit stays
open (permanent quarantine).
"""

from __future__ import annotations

import time

__all__ = ["ProbationBreaker"]


class ProbationBreaker:
    """One endpoint's circuit state (see module docstring). ``now`` is
    injectable everywhere (``time.monotonic`` default) so consumers can
    evaluate transitions at the single timestamp they read under their
    lock."""

    __slots__ = (
        "max_failures",
        "probation_s",
        "probation_max_s",
        "consecutive_failures",
        "quarantined",
        "probing",
        "probation_until",
        "probation_backoff_s",
    )

    def __init__(self, *, max_failures: int = 3,
                 probation_s: "float | None" = 1.0,
                 probation_max_s: float = 30.0):
        if max_failures < 1:
            raise ValueError(
                f"max_failures must be >= 1, got {max_failures}")
        if probation_s is not None and probation_s <= 0:
            raise ValueError(
                f"probation_s must be > 0 or None, got {probation_s}")
        if probation_max_s <= 0:
            raise ValueError(
                f"probation_max_s must be > 0, got {probation_max_s}")
        self.max_failures = max_failures
        self.probation_s = probation_s
        self.probation_max_s = probation_max_s
        self.consecutive_failures = 0
        self.quarantined = False
        self.probing = False
        #: monotonic time the next probation probe becomes due
        self.probation_until = 0.0
        self.probation_backoff_s = probation_s or 0.0

    # -- transitions ---------------------------------------------------------
    def record_success(self) -> bool:
        """Any successful unit of work: streak/backoff reset, probe slot
        released; returns True when this CLOSED an open circuit (the
        consumer fires its reintegration event/metric)."""
        self.consecutive_failures = 0
        self.probing = False
        if self.probation_s is not None:
            self.probation_backoff_s = self.probation_s
        if self.quarantined:
            self.quarantined = False
            return True
        return False

    def record_failure(self, now: "float | None" = None) -> bool:
        """One non-probe failure; returns True when the streak just
        opened the circuit (the consumer quarantines + emits)."""
        self.probing = False
        self.consecutive_failures += 1
        if (self.consecutive_failures >= self.max_failures
                and not self.quarantined):
            self.quarantined = True
            if self.probation_s is not None:
                self.probation_backoff_s = self.probation_s
                self.probation_until = (
                    (now if now is not None else time.monotonic())
                    + self.probation_s)
            return True
        return False

    def record_probe_failure(self, now: "float | None" = None) -> None:
        """A probation probe failed: stay open, back off exponentially
        (capped), schedule the next probe."""
        self.probing = False
        self.probation_backoff_s = min(
            self.probation_backoff_s * 2.0, self.probation_max_s)
        self.probation_until = (
            (now if now is not None else time.monotonic())
            + self.probation_backoff_s)

    def trip(self) -> bool:
        """Open the circuit directly, without a failure streak (the
        hung-dispatch watchdog's verb). Returns True when the circuit
        was previously closed (the consumer counts ONE quarantine)."""
        was_open = self.quarantined
        self.quarantined = True
        self.probing = False
        return not was_open

    # -- probe scheduling ----------------------------------------------------
    def probe_due(self, now: "float | None" = None) -> bool:
        """An open circuit whose backoff elapsed and no probe in flight:
        the next first-routing unit of work may probe it."""
        return (self.probation_s is not None and self.quarantined
                and not self.probing
                and (now if now is not None else time.monotonic())
                >= self.probation_until)

    def begin_probe(self) -> None:
        self.probing = True

    def release_probe(self) -> None:
        """Free the probe slot on an inconclusive outcome (the probe's
        request failed for its own reasons — deadline, bad payload —
        which says nothing about the endpoint)."""
        self.probing = False

    def schedule_probe(self, now: "float | None" = None) -> None:
        """(Re)schedule the next probe one current-backoff from ``now``
        (no-op with probes disabled)."""
        if self.probation_s is not None:
            self.probation_until = (
                (now if now is not None else time.monotonic())
                + self.probation_backoff_s)

    def next_probe_in_s(self, now: "float | None" = None
                        ) -> "float | None":
        """Seconds until the next probe is due (snapshot surface); None
        when closed or probes are disabled."""
        if not self.quarantined or self.probation_s is None:
            return None
        return max(0.0, self.probation_until
                   - (now if now is not None else time.monotonic()))
