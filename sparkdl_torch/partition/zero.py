"""ZeRO-style cross-replica sharding of optimizer state: the port of
``sparkdl_tpu.partition.zero``.

In data-parallel training the optimizer state, and the weight update
itself, is the same on every replica, so it can be sharded across them
and the updated parameters all-gathered afterwards (arXiv 2004.13336):
per-rank optimizer memory drops ~n-fold on an n-way shard for one
reduce-scatter and one all-gather a step.

This module owns the spec choice: for each state leaf, shard the
**largest dimension divisible by the axis size** (leaves a rule already
shards on the axis, scalars and non-divisible leaves stay as they are),
and the measurement: the optimizer-state bytes this rank holds, exported
as ``sparkdl_opt_state_bytes{axis=...}``. The collectives that act on the
specs are the partitioner's (partition/partitioner.py).
"""

from __future__ import annotations

from typing import Any

from sparkdl_torch.observability.registry import registry
from sparkdl_torch.partition.rules import tree_path_names, unflatten_names
from sparkdl_torch.runtime.mesh import PartitionSpec as P

__all__ = [
    "zero_leaf_spec",
    "zero_partition_specs",
    "opt_state_bytes_per_chip",
    "export_opt_state_bytes",
]

_GAUGE = None


def _opt_bytes_gauge():
    global _GAUGE
    if _GAUGE is None:
        _GAUGE = registry().gauge(
            "sparkdl_opt_state_bytes",
            "per-rank optimizer-state bytes, by sharding axis "
            "('replicated' = no ZeRO sharding)", labels=("axis",))
    return _GAUGE


def zero_leaf_spec(shape: "tuple[int, ...]", *, axis: str, axis_size: int,
                   base: "P | None" = None) -> P:
    """ZeRO spec for one state leaf: ``base`` if it already uses ``axis``,
    else ``base`` with the largest ``axis_size``-divisible unsharded dim
    additionally sharded on ``axis`` (``base`` unchanged when none is:
    a 3-element bias is cheaper replicated than padded)."""
    parts: "list[Any]" = list(base) if base is not None else []
    parts += [None] * (len(shape) - len(parts))
    for p in parts:
        entries = p if isinstance(p, (tuple, list)) else (p,)
        if axis in entries:
            return base if base is not None else P()
    candidates = [
        (dim, i) for i, (dim, p) in enumerate(zip(shape, parts))
        if p is None and dim % axis_size == 0 and dim >= axis_size
    ]
    if not candidates or axis_size <= 1:
        return base if base is not None else P()
    _, best = max(candidates, key=lambda t: (t[0], -t[1]))
    parts[best] = axis
    return P(*parts)


def zero_partition_specs(tree: Any, *, axis: str, axis_size: int,
                         base_specs: Any = None) -> Any:
    """Tree of ZeRO specs for an optimizer-state (or param) tree.

    ``base_specs`` (same structure, e.g. the rule-matched specs) is
    honored where it already shards a leaf on ``axis``; everywhere else
    the leaf's largest divisible dim is sharded on ``axis``.
    """
    flat = tree_path_names(tree)
    base_flat = ([s for _, s in tree_path_names(base_specs)]
                 if base_specs is not None else [None] * len(flat))
    if len(base_flat) != len(flat):
        raise ValueError(
            f"base_specs has {len(base_flat)} leaves, tree has {len(flat)}"
        )
    specs = []
    for (_, leaf), base in zip(flat, base_flat):
        shape = tuple(getattr(leaf, "shape", ()))
        n = 1
        for d in shape:
            n *= int(d)
        if len(shape) == 0 or n == 1:
            specs.append(P())
            continue
        specs.append(
            zero_leaf_spec(shape, axis=axis, axis_size=axis_size, base=base)
        )
    return unflatten_names(tree, specs)


def _local_bytes(t: Any) -> int:
    local = getattr(t, "to_local", None)
    if local is not None:  # a DTensor: this rank's shard
        t = local()
    nbytes = getattr(t, "nbytes", None)
    if nbytes is None and hasattr(t, "element_size"):
        nbytes = t.numel() * t.element_size()
    return int(nbytes or 0)


def opt_state_bytes_per_chip(tree: Any, device: Any = None) -> int:
    """Bytes of optimizer state this rank holds.

    ``tree`` is an optimizer (its ``state``: the local shards under
    ZeRO), or a tree of tensors (a DTensor leaf counts its local shard).
    ``device`` is accepted for the reference's signature: a rank owns one
    device.
    """
    del device
    state = getattr(tree, "state", None)
    if state is not None and not isinstance(tree, dict):
        tree = [dict(s) for s in state.values()]
    return sum(_local_bytes(leaf) for _, leaf in tree_path_names(tree))


def export_opt_state_bytes(tree: Any, *, axis: "str | None") -> int:
    """Measure :func:`opt_state_bytes_per_chip` and land it in the spine
    as ``sparkdl_opt_state_bytes{axis=...}``; returns the bytes."""
    n = opt_state_bytes_per_chip(tree)
    _opt_bytes_gauge().set(n, axis=axis if axis else "replicated")
    return n
