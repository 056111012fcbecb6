"""Multi-host serving fabric: a cache-aware router tier over per-host
engines.

ReplicaPool scales across the cards of ONE host; this package is the
front door over MANY hosts — the coordinator/worker split of distributed
TensorFlow (arXiv 1603.04467, 1603.02339) applied to the serving tier.
Three layers, separately testable:

- :mod:`~sparkdl_torch.fabric.host` — the uniform host surface
  (``submit/snapshot/capacity/health/prefix_digest/drain/close``):
  :class:`InProcessHost` wraps a live engine in this process (tests,
  the CPU harness, ``chip_smoke.py``'s ``[fabric]`` phase) and defines
  :data:`HOST_LEVEL_ERRORS`, the retry class for failures that indict
  the host rather than the request.
- :mod:`~sparkdl_torch.fabric.http` — the thin HTTP/json transport for
  real multi-process deployments (:class:`HostServer` over one engine,
  :class:`HttpHostHandle` on the router side), built on the same stdlib
  ``http.server`` machinery as the metrics exporter; remote errors
  re-raise as the same typed exceptions the in-process engine raises.
- :mod:`~sparkdl_torch.fabric.router` — the :class:`Router`: weighted
  least-outstanding-work placement with prefix-cache **affinity**
  (hosts publish bounded prefix→host digests,
  :mod:`~sparkdl_torch.fabric.digest`; requests sharing a cached prefix
  land where their blocks already live, capped so a hot prefix cannot
  hotspot one host), sticky sessions, spillover admission control,
  probation circuit-breaking with postmortem bundles on quarantine,
  host-level failover, and graceful :meth:`Router.drain_host` whose
  unstarted requests transfer queue-to-queue onto surviving hosts (and
  whose parked sessions migrate to survivors).
- :mod:`~sparkdl_torch.fabric.group` — the horizontally scaled router
  tier: N stateless routers agreeing on placement through
  rendezvous hashing (:func:`~sparkdl_torch.fabric.digest.hrw_score`)
  instead of shared state, fronted by :class:`RouterGroup`
  (in-process) or :class:`RouterServer`/:class:`RouterHandle` (HTTP),
  with digest DELTAS keeping per-router refresh traffic ≤KBs/sec.
"""

from sparkdl_torch.fabric.digest import (
    HostDigest,
    hrw_preferred_host,
    hrw_score,
    match_blocks,
    path_anchor,
    placement_key,
    prompt_block_hashes,
    session_key,
)
from sparkdl_torch.fabric.group import (
    AllRoutersUnavailableError,
    RouterGroup,
    RouterHandle,
    RouterServer,
)
from sparkdl_torch.fabric.host import (
    HOST_LEVEL_ERRORS,
    HostDrainingError,
    HostHandle,
    HostUnavailableError,
    InProcessHost,
)
from sparkdl_torch.fabric.http import HostServer, HttpHostHandle
from sparkdl_torch.fabric.router import AllHostsUnavailableError, Router

__all__ = [
    "AllHostsUnavailableError",
    "AllRoutersUnavailableError",
    "HOST_LEVEL_ERRORS",
    "HostDigest",
    "HostDrainingError",
    "HostHandle",
    "HostServer",
    "HostUnavailableError",
    "HttpHostHandle",
    "InProcessHost",
    "Router",
    "RouterGroup",
    "RouterHandle",
    "RouterServer",
    "hrw_preferred_host",
    "hrw_score",
    "match_blocks",
    "path_anchor",
    "placement_key",
    "prompt_block_hashes",
    "session_key",
]
