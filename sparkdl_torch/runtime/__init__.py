"""The runtime: the dtype policy, meshes, batching, the feed's prefetch,
chained dispatch (CUDA graphs on the card) and async readback."""

from sparkdl_torch.runtime.dtypes import FLOAT32, DtypePolicy, default_policy
from sparkdl_torch.runtime.mesh import (
    AXIS_ORDER,
    MeshSpec,
    batch_sharding,
    data_parallel_mesh,
    replicated_sharding,
    single_device_mesh,
)
from sparkdl_torch.runtime.batching import (
    PaddedBatch,
    default_buckets,
    pad_batch_to_multiple,
    pad_to_bucket,
    rebatch,
)
from sparkdl_torch.runtime.completion import (
    AsyncFetcher,
    FetchTicket,
    start_fetch,
)
from sparkdl_torch.runtime.dispatch import (
    ChainPolicy,
    ScanChainer,
    calibrate_dispatch_gap,
    chain_carry,
    overhead_share,
)
from sparkdl_torch.runtime.prefetch import (
    PrefetchIterator,
    pipelined_map,
    prefetch_to_device,
)

__all__ = [
    "AXIS_ORDER",
    "AsyncFetcher",
    "ChainPolicy",
    "DtypePolicy",
    "FLOAT32",
    "FetchTicket",
    "MeshSpec",
    "PaddedBatch",
    "PrefetchIterator",
    "ScanChainer",
    "batch_sharding",
    "calibrate_dispatch_gap",
    "chain_carry",
    "data_parallel_mesh",
    "default_buckets",
    "default_policy",
    "overhead_share",
    "pad_batch_to_multiple",
    "pad_to_bucket",
    "pipelined_map",
    "prefetch_to_device",
    "rebatch",
    "replicated_sharding",
    "single_device_mesh",
    "start_fetch",
]
