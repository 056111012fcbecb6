"""Online serving: async admission, dynamic micro-batching, replica
pools, continuous GPT decode with tiered KV — the port of
``sparkdl_tpu.serving`` (ROADMAP A7).

Requests arrive one at a time, asynchronously, and the engines coalesce
them into the device programs the batch stack already runs:

- :mod:`~sparkdl_torch.serving.queue` — bounded admission with
  deadlines, reject-with-error backpressure, tenants and priority
  classes (:mod:`~sparkdl_torch.serving.tenancy`: quotas, fair weights,
  the brownout ladder);
- :mod:`~sparkdl_torch.serving.microbatcher` /
  :mod:`~sparkdl_torch.serving.engine` — max-wait/max-batch dispatch
  into a :class:`~sparkdl_torch.transformers._inference.BatchedRunner`
  (one CUDA graph per bucket on the card) or a
  :class:`~sparkdl_torch.serving.replicas.ReplicaPool` of them (least-
  work routing, re-route-once rider protection, the probation circuit
  breaker, the hung-dispatch watchdog), per-request error isolation,
  graceful drain;
- :mod:`~sparkdl_torch.serving.continuous` — continuous batching for GPT
  generation over a per-slot dense cache or a block-paged KV pool
  (:mod:`~sparkdl_torch.serving.kv_blocks`), with radix prefix reuse
  (:mod:`~sparkdl_torch.serving.prefix_cache`), chunked prefill,
  chained and speculative decode (:mod:`~sparkdl_torch.serving.
  spec_decode`), bf16/int8 pool layouts, and cold sessions parked in
  host-DRAM and disk tiers (:mod:`~sparkdl_torch.serving.kv_tiers`,
  raw bytes through :mod:`~sparkdl_torch.serving.kv_codec`), exported
  and imported across engines; greedy tokens identical to the unbatched
  ``generate``, parked or not.

Observability (:mod:`~sparkdl_torch.serving.metrics`): queue depth,
batch occupancy %, admission rejects and p50/p95/p99 request latency.
"""

from sparkdl_torch.serving.continuous import ContinuousGPTEngine, GenRequest
from sparkdl_torch.serving.engine import ServingEngine
from sparkdl_torch.serving.kv_blocks import KVBlockPool
from sparkdl_torch.serving.metrics import ServingMetrics
from sparkdl_torch.serving.microbatcher import MicroBatcher
from sparkdl_torch.serving.prefix_cache import PrefixCache
from sparkdl_torch.serving.queue import (
    DeadlineExceededError,
    EngineClosedError,
    QueueFullError,
    Request,
    RequestQueue,
    failure_reason,
)
from sparkdl_torch.serving.replicas import (
    AllReplicasQuarantinedError,
    HungDispatchError,
    ReplicaPool,
)
from sparkdl_torch.serving.spec_decode import (
    ChainedDraftSource,
    NGramDraftSource,
    PrefixCacheDraftSource,
)
from sparkdl_torch.serving.tenancy import (
    PRIORITY_BACKGROUND,
    PRIORITY_INTERACTIVE,
    BrownoutShedError,
    OverloadController,
    TenantRegistry,
    TenantThrottledError,
)

__all__ = [
    "AllReplicasQuarantinedError",
    "BrownoutShedError",
    "ChainedDraftSource",
    "ContinuousGPTEngine",
    "DeadlineExceededError",
    "EngineClosedError",
    "GenRequest",
    "HungDispatchError",
    "KVBlockPool",
    "MicroBatcher",
    "NGramDraftSource",
    "OverloadController",
    "PRIORITY_BACKGROUND",
    "PRIORITY_INTERACTIVE",
    "PrefixCache",
    "PrefixCacheDraftSource",
    "QueueFullError",
    "ReplicaPool",
    "Request",
    "RequestQueue",
    "ServingEngine",
    "ServingMetrics",
    "TenantRegistry",
    "TenantThrottledError",
    "failure_reason",
]
