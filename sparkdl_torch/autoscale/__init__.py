"""Elastic fleet autoscaling: SLO-driven grow/shrink with drain-safe
scale-down.

:class:`AutoScaler` closes the loop from the observability spine (SLO
burn, queue depth, KV deferral streaks) to the fleet's capacity knobs:
replica count (:meth:`ReplicaPool.add_replica` /
:meth:`ReplicaPool.remove_replica`), the KV block pool's serving/spare
split (:meth:`KVBlockPool.grow` / :meth:`KVBlockPool.shrink`), and
fabric host membership (:meth:`Router.remove_host` over the shared
drain path). The control law is the ingest AutoTuner's discipline —
hysteresis, post-move cooldown, and an SLO-burn veto that reverts a
scale-down and tabus the direction. See
:mod:`sparkdl_torch.autoscale.controller`.
"""

from sparkdl_torch.autoscale.controller import (
    AutoScaler,
    AutoscalePolicy,
    read_autoscale_signals,
)

__all__ = [
    "AutoScaler",
    "AutoscalePolicy",
    "read_autoscale_signals",
]
