"""dp × tp × fsdp mesh construction with loud validation: the port of
``sparkdl_tpu.partition.mesh_factory``.

Named keyword axes over the canonical
:data:`~sparkdl_torch.runtime.mesh.AXIS_ORDER`, at most one ``-1`` axis
inferred from the device count (the ranks of the process group), and
typed :class:`MeshShapeError`\\ s at construction time naming the axis
sizes and the device count.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from sparkdl_torch.runtime.mesh import (
    Mesh,
    MeshShapeError,
    MeshSpec,
    _default_devices,
    resolve_axis_sizes,
)

__all__ = ["MeshShapeError", "make_mesh", "make_custom_mesh", "axis_sizes"]


def make_mesh(*, dp: int = -1, pp: int = 1, fsdp: int = 1, sp: int = 1,
              tp: int = 1, ep: int = 1,
              devices: "Sequence[int] | None" = None) -> Mesh:
    """Build a mesh over the canonical axes (``dp`` inferred by default).

    >>> make_mesh(dp=4, fsdp=2)          # 8 ranks: 4-way dp, 2-way zero
    >>> make_mesh(tp=4)                  # dp inferred = n_ranks // 4

    ``devices`` are ranks (default: every rank of the process group, or
    ``[0]`` without one). Every axis is always present (size-1 axes are
    inert). Bad shapes raise :class:`MeshShapeError` naming the axis
    sizes and the device count.
    """
    if devices is None:
        devices = _default_devices()
    devices = list(devices)
    sizes = dict(dp=dp, pp=pp, fsdp=fsdp, sp=sp, tp=tp, ep=ep)
    for name, size in sizes.items():
        if not isinstance(size, (int, np.integer)) or (size < 1 and size != -1):
            raise MeshShapeError(
                f"mesh axis {name}={size!r} invalid: sizes are ints >= 1, "
                f"or one -1 to infer from the {len(devices)} devices"
            )
    return MeshSpec(**sizes).build(devices)


def make_custom_mesh(axes: "Sequence[tuple[str, int]]",
                     devices: "Sequence[int] | None" = None) -> Mesh:
    """Mesh over caller-named axes (non-canonical layouts, tests).

    Duplicate axis names, non-positive sizes and a product that does not
    match the device count raise :class:`MeshShapeError` up front. At
    most one size may be ``-1`` (inferred).
    """
    if devices is None:
        devices = _default_devices()
    devices = list(devices)
    names = [n for n, _ in axes]
    dupes = sorted({n for n in names if names.count(n) > 1})
    if dupes:
        raise MeshShapeError(
            f"overlapping mesh axis name(s) {dupes}: each of the "
            f"{len(devices)} devices can sit on an axis only once"
        )
    resolved = resolve_axis_sizes(dict(axes), len(devices))
    arr = np.asarray(devices).reshape(tuple(resolved[n] for n in names))
    return Mesh(arr, tuple(names))


def axis_sizes(mesh: "Mesh | None") -> "dict[str, int]":
    """``{axis: size}`` for a mesh (``{}`` for the no-mesh case)."""
    if mesh is None:
        return {}
    return {name: int(mesh.shape[name]) for name in mesh.axis_names}
