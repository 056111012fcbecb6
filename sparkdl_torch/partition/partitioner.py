"""The one-device partitioner (the reference's
``sparkdl_tpu.partition.partitioner.SingleDevicePartitioner``).

On a TPU the reference's partitioner decides the sharding of every jit
boundary; with one ``torch.device`` there is nothing to shard: a batch is
moved to the device, params are the module's own, and an apply function
runs as it is. ``describe()`` keeps the reference's keys so operator
views read the same in both packages.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from sparkdl_torch.ops._dispatch import resolve_device
from sparkdl_torch.runtime.tree import tree_map

__all__ = ["SingleDevicePartitioner"]


class SingleDevicePartitioner:
    """Everything on one device (``device``, the card by default, which
    raises where CUDA is absent)."""

    def __init__(self, device: Any = None):
        self.device = resolve_device(device if device is not None else "cuda")

    def shard_batch(self, arrays: Any, *, check: bool = True) -> Any:
        """Every leaf of ``arrays`` as a tensor on the device."""
        del check
        return tree_map(lambda a: torch.as_tensor(a).to(self.device), arrays)

    def wrap_apply(self, apply_fn: Callable, params: Any = None) -> Callable:
        return apply_fn  # the module's weights already live on the device

    def describe(self) -> "dict[str, Any]":
        return {"kind": type(self).__name__, "axes": {}, "batch_axes": [],
                "zero_axis": None, "data_axis_size": 1,
                "device": str(self.device)}
