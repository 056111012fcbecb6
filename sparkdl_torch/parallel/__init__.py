"""Model parallelism over the named mesh axes, the port of
``sparkdl_tpu.parallel``: explicit ``torch.distributed`` collectives on
the process group of each axis (NCCL on the cards, gloo on the CPU),
where the reference lets XLA place them.

- :mod:`collectives`: gradient all-reduce, reduce-scatter and
  all-gather helpers over trees of tensors;
- :mod:`ring_attention`: sequence parallelism over ``sp`` (K/V blocks
  rotating around the ring with an online softmax, or gathered once);
- :mod:`tensor_parallel`: Megatron column/row-parallel layers over
  ``tp``, one all-reduce per block;
- :mod:`pipeline`: the GPipe schedule over ``pp``;
- :mod:`expert_parallel`: mixture-of-experts over ``ep`` (token-choice
  routing with capacity, all-to-all dispatch).

Axis names are the canonical ones of ``sparkdl_torch.runtime.mesh``; a
helper binds them through the ambient ``mesh_context`` or ``mesh=``.
"""

from sparkdl_torch.parallel.collectives import (
    all_gather_params,
    cross_replica_mean,
    psum_grads,
    reduce_scatter_grads,
)
from sparkdl_torch.parallel.ring_attention import ring_attention, ring_self_attention
from sparkdl_torch.parallel.tensor_parallel import (
    ColumnParallelDense,
    RowParallelDense,
    TPMlpBlock,
)
from sparkdl_torch.parallel.pipeline import pipeline_apply
from sparkdl_torch.parallel.expert_parallel import (
    MoEMlpBlock,
    moe_aux_losses,
    top_k_dispatch,
)

__all__ = [
    "all_gather_params",
    "cross_replica_mean",
    "psum_grads",
    "reduce_scatter_grads",
    "ring_attention",
    "ring_self_attention",
    "ColumnParallelDense",
    "RowParallelDense",
    "TPMlpBlock",
    "pipeline_apply",
    "MoEMlpBlock",
    "moe_aux_losses",
    "top_k_dispatch",
]
