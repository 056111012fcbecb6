"""Dtype policy: float32 parameters, a compute dtype, float32 outputs.

The port of ``sparkdl_tpu.runtime.dtypes``. On the card the tensor cores
multiply bfloat16 with float32 accumulation, so the accelerator policy is
float32 parameters / bfloat16 compute / float32 outputs; on the CPU
everything stays float32, so CPU runs stay exact against float32
references. This module is the single switch for that choice.
"""

from __future__ import annotations

import dataclasses

import torch

from sparkdl_torch.runtime.tree import tree_map


def _cast_floating(tree, dtype: torch.dtype):
    return tree_map(
        lambda a: a.to(dtype)
        if isinstance(a, torch.Tensor) and a.is_floating_point() else a,
        tree,
    )


@dataclasses.dataclass(frozen=True)
class DtypePolicy:
    """Dtype policy applied by models and transformers.

    Attributes:
      param_dtype: dtype parameters are stored in (master copy).
      compute_dtype: dtype activations/matmuls run in.
      output_dtype: dtype returned to the caller (DataFrame columns).
    """

    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16
    output_dtype: torch.dtype = torch.float32

    def cast_inputs(self, x):
        """Floating-point tensors of the tree ``x`` in the compute dtype;
        integer tensors and non-tensor leaves as they are."""
        return _cast_floating(x, self.compute_dtype)

    def cast_outputs(self, x):
        """Floating-point tensors of the tree ``x`` in the output dtype."""
        return _cast_floating(x, self.output_dtype)


def default_policy(platform: "str | None" = None) -> DtypePolicy:
    """bfloat16 compute on the card (``"cuda"``), float32 elsewhere (CPU
    tests stay exact). ``platform`` defaults to ``"cuda"`` where CUDA is
    available, else ``"cpu"``."""
    if platform is None:
        platform = "cuda" if torch.cuda.is_available() else "cpu"
    if platform == "cuda":
        return DtypePolicy()
    return DtypePolicy(compute_dtype=torch.float32)


#: Policy that disables mixed precision entirely (used by oracle tests).
FLOAT32 = DtypePolicy(compute_dtype=torch.float32)
