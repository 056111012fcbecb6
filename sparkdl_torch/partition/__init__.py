"""Placement of batches, parameters and optimizer state: the port of
``sparkdl_tpu.partition``.

- ``rules``: regex ``(pattern, PartitionSpec)`` tables over the port's
  ``state_dict`` names, first applicable match wins, unmatched-param
  fail-loud, per-model defaults (GPT/BERT/ViT), hit counts in the
  metrics spine.
- ``partitioner``: :class:`SingleDevicePartitioner` (a ReplicaPool
  executor), :class:`LocalDevicePartitioner` (a batch split over the
  devices of one process: data-parallel inference),
  :class:`DataParallelPartitioner` (dp + optional ZeRO opt-state
  sharding), :class:`SPMDPartitioner` (rule-placed state), and the
  :class:`ShardedOptimizer` whose step holds the collectives.
- ``mesh_factory``: dp × tp × fsdp meshes over the ranks of the process
  group, with typed :class:`MeshShapeError` validation.
- ``zero``: the ZeRO spec policy and per-rank optimizer-state bytes
  (``sparkdl_opt_state_bytes{axis}``).
"""

from sparkdl_torch.partition.mesh_factory import (
    MeshShapeError,
    axis_sizes,
    make_custom_mesh,
    make_mesh,
)
from sparkdl_torch.partition.partitioner import (
    DataParallelPartitioner,
    LocalDevicePartitioner,
    Partitioner,
    ShardedOptimizer,
    SingleDevicePartitioner,
    SPMDPartitioner,
)
from sparkdl_torch.partition.rules import (
    BERT_RULES,
    GENERIC_RULES,
    GPT_RULES,
    KV_POOL_RULES,
    VIT_RULES,
    PartitionRuleError,
    default_rules_for,
    match_partition_rules,
    rule_hit_counts,
    sequence_activation_spec,
)
from sparkdl_torch.partition.zero import (
    export_opt_state_bytes,
    opt_state_bytes_per_chip,
    zero_partition_specs,
)
from sparkdl_torch.runtime.mesh import PartitionSpec

__all__ = [
    "MeshShapeError",
    "axis_sizes",
    "make_custom_mesh",
    "make_mesh",
    "Partitioner",
    "SingleDevicePartitioner",
    "LocalDevicePartitioner",
    "DataParallelPartitioner",
    "SPMDPartitioner",
    "ShardedOptimizer",
    "PartitionSpec",
    "PartitionRuleError",
    "match_partition_rules",
    "rule_hit_counts",
    "default_rules_for",
    "sequence_activation_spec",
    "GPT_RULES",
    "BERT_RULES",
    "VIT_RULES",
    "GENERIC_RULES",
    "KV_POOL_RULES",
    "zero_partition_specs",
    "opt_state_bytes_per_chip",
    "export_opt_state_bytes",
]
