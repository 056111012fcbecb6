"""Named device meshes over the ranks of a process group: the port of
``sparkdl_tpu.runtime.mesh``.

The reference lays a ``jax.sharding.Mesh`` over the chips that one JAX
runtime sees. The port runs one process per card (``runner/``), so a
mesh's "devices" are the RANKS of the default process group, laid out
over the same canonical axes:

  axis name | meaning
  ----------+----------------------------------------------
  ``dp``    | data parallel (batch split; gradient all-reduce)
  ``fsdp``  | fully-sharded data parallel (state shard over dp peers)
  ``tp``    | tensor parallel (weight-column/row split)
  ``sp``    | sequence/context parallel (ring attention)
  ``pp``    | pipeline parallel (stage split)
  ``ep``    | expert parallel (MoE expert split)

A :class:`Mesh` is plain data until a collective needs it: its
``torch.distributed.device_mesh.DeviceMesh`` (and the process group of
each axis, or of a tuple of axes) is built on first use, and only when a
process group is up. A world of one needs no ``init_process_group``, and
importing this module never starts one; ``parallel/``'s collectives over
an axis of size 1 are no-ops. A sharding is a tuple of placements
(``Shard(dim)``/``Replicate()``), one per mesh axis; a
:class:`PartitionSpec` names, per tensor dim, the mesh axes it is split
over, as the reference's ``PartitionSpec`` does.
"""

from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Any, Sequence

import numpy as np

#: Canonical axis ordering. dp outermost, then pp, fsdp, sp, tp/ep
#: innermost (neighbouring ranks share the fastest links).
AXIS_ORDER = ("dp", "pp", "fsdp", "sp", "tp", "ep")

_CURRENT: "contextvars.ContextVar[Mesh | None]" = contextvars.ContextVar(
    "sparkdl_torch_mesh", default=None)


class MeshShapeError(ValueError):
    """A requested parallelism layout cannot be laid over the available
    devices (non-divisor axis sizes, duplicate axis names, bad product).

    Raised at mesh-construction time with the device count in the
    message (partition/mesh_factory.py is the loud front door)."""


class PartitionSpec(tuple):
    """Per tensor dim, the mesh axis (or tuple of axes) it is split over,
    None for an unsplit dim; trailing dims left out are unsplit.
    ``P("fsdp", None)`` splits dim 0 over ``fsdp``."""

    def __new__(cls, *parts: Any) -> "PartitionSpec":
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return "P(" + ", ".join(repr(p) for p in self) + ")"

    def padded(self, ndim: int) -> "tuple[Any, ...]":
        """The spec with None for every unnamed trailing dim."""
        return tuple(self) + (None,) * (ndim - len(self))


P = PartitionSpec


def resolve_axis_sizes(sizes: "dict[str, int]", n_devices: int) -> dict[str, int]:
    """Resolve an ordered ``{axis: size}`` layout against ``n_devices``:
    at most one ``-1`` axis is inferred, everything else validated with a
    typed :class:`MeshShapeError` naming the device count. The one
    implementation behind :meth:`MeshSpec.resolve` and
    ``partition.mesh_factory``'s custom-axes builder."""
    sizes = dict(sizes)
    unknown = [a for a, s in sizes.items() if s == -1]
    if len(unknown) > 1:
        raise MeshShapeError(
            f"more than one -1 axis to infer: {unknown}"
        )
    bad = {a: s for a, s in sizes.items() if s != -1 and s < 1}
    if bad:
        raise MeshShapeError(
            f"mesh axis sizes must be >= 1 (or one -1 to infer), got "
            f"{bad} over {n_devices} devices"
        )
    known = math.prod(s for s in sizes.values() if s != -1)
    if unknown:
        if n_devices % known != 0:
            raise MeshShapeError(
                f"{n_devices} devices not divisible by the fixed axes "
                f"product {known} "
                f"({ {a: s for a, s in sizes.items() if s not in (1, -1)} })"
            )
        sizes[unknown[0]] = n_devices // known
    elif known != n_devices:
        raise MeshShapeError(
            f"mesh axes product {known} "
            f"({ {a: s for a, s in sizes.items() if s != 1} }) != "
            f"device count {n_devices}"
        )
    return sizes


def world_size() -> int:
    """Ranks of the default process group (1 when none is up)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def world_rank() -> int:
    """This process's rank in the default process group (0 when none)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def rank_device() -> "Any":
    """This rank's device: the current card under an NCCL process group,
    else the CPU (gloo, or no process group)."""
    import torch
    import torch.distributed as dist

    if (dist.is_available() and dist.is_initialized()
            and dist.get_backend() == "nccl"):
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


class Mesh:
    """Named axes over ranks: ``devices`` is an integer array of ranks of
    the mesh's shape, ``axis_names`` its axes in order. ``shape`` maps
    each axis to its size, as ``jax.sharding.Mesh.shape`` does."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        self.devices = np.asarray(devices, dtype=np.int64)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise MeshShapeError(
                f"{self.devices.ndim}-d rank array for axes {self.axis_names}")
        self.shape = {a: int(s) for a, s in zip(self.axis_names,
                                                self.devices.shape)}
        self._device_mesh = None
        self._groups: "dict[tuple[str, ...], Any]" = {}

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def __repr__(self) -> str:
        return f"Mesh({self.shape})"

    def __eq__(self, other: Any) -> bool:
        return (isinstance(other, Mesh) and self.axis_names == other.axis_names
                and np.array_equal(self.devices, other.devices))

    def __hash__(self) -> int:
        return hash((self.axis_names, self.devices.tobytes()))

    def coordinate(self, axis: str, rank: "int | None" = None) -> int:
        """Index of ``rank`` (default: this process's) along ``axis``."""
        rank = world_rank() if rank is None else rank
        where = np.argwhere(self.devices == rank)
        if where.size == 0:
            raise MeshShapeError(f"rank {rank} is not on {self!r}")
        return int(where[0][self.axis_names.index(axis)])

    @property
    def device_mesh(self):
        """The ``DeviceMesh`` over the default process group, built on
        first use (every rank must reach this together); None when no
        process group is up."""
        if self._device_mesh is None and _pg_up():
            from torch.distributed.device_mesh import DeviceMesh

            if world_size() != self.size:
                raise MeshShapeError(
                    f"{self!r} has {self.size} devices, the process group "
                    f"{world_size()} ranks")
            self._device_mesh = DeviceMesh(
                rank_device().type, self.devices.tolist(),
                mesh_dim_names=self.axis_names)
        return self._device_mesh

    def group(self, axis: "str | Sequence[str]"):
        """The process group of this rank's peers along ``axis``, or along
        a tuple of axes (the ranks that differ from this one only on
        those axes). None when no process group is up. Every rank must
        ask for a group the first time together: it is made then."""
        axes = (axis,) if isinstance(axis, str) else tuple(axis)
        if len(axes) == 1:
            dm = self.device_mesh
            return None if dm is None else dm.get_group(axes[0])
        if not _pg_up():
            return None
        if axes not in self._groups:
            import torch.distributed as dist

            if world_size() != self.size:
                raise MeshShapeError(
                    f"{self!r} has {self.size} devices, the process group "
                    f"{world_size()} ranks")
            mine = None
            for ranks in self._blocks(axes):  # every rank makes every group
                g = dist.new_group(ranks)
                if world_rank() in ranks:
                    mine = g
            self._groups[axes] = mine
        return self._groups[axes]

    def _blocks(self, axes: "tuple[str, ...]") -> "list[list[int]]":
        """The rank array cut into its groups along ``axes``: each row the
        ranks that differ only on those axes, flattened in their order."""
        keep = [self.axis_names.index(a) for a in axes]
        rest = [i for i in range(len(self.axis_names)) if i not in keep]
        size = int(np.prod([self.devices.shape[i] for i in keep]))
        return np.transpose(self.devices, rest + keep).reshape(-1, size).tolist()

    def axis_ranks(self, axis: "str | Sequence[str]",
                   rank: "int | None" = None) -> "list[int]":
        """The global ranks along ``axis`` (or a tuple of axes, flattened
        in their order) through ``rank`` (default this process's): entry
        ``i`` sits at index ``i`` along them."""
        rank = world_rank() if rank is None else rank
        axes = (axis,) if isinstance(axis, str) else tuple(axis)
        for row in self._blocks(axes):
            if rank in row:
                return [int(r) for r in row]
        raise MeshShapeError(f"rank {rank} is not on {self!r}")

    def ring_neighbours(self, axis: str) -> "tuple[int, int]":
        """(previous, next) global ranks of this rank on the ring of
        ``axis`` (itself twice on an axis of size 1)."""
        ranks = self.axis_ranks(axis)
        i = self.coordinate(axis)
        return ranks[(i - 1) % len(ranks)], ranks[(i + 1) % len(ranks)]


def _pg_up() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def _default_devices() -> "list[int]":
    return list(range(world_size()))


class MeshSpec:
    """Logical parallelism layout, independent of the device count.

    A size of 1 means the axis is inert (present so that specs naming it
    always resolve). One size of -1 is inferred from the device count.
    """

    def __init__(self, dp: int = -1, pp: int = 1, fsdp: int = 1,
                 sp: int = 1, tp: int = 1, ep: int = 1):
        self.dp, self.pp, self.fsdp = dp, pp, fsdp
        self.sp, self.tp, self.ep = sp, tp, ep

    def sizes(self) -> dict[str, int]:
        return {a: getattr(self, a) for a in AXIS_ORDER}

    def resolve(self, n_devices: int) -> dict[str, int]:
        """Fill in the single -1 axis from n_devices; validate the product."""
        return resolve_axis_sizes(self.sizes(), n_devices)

    def build(self, devices: "Sequence[int] | None" = None) -> Mesh:
        """A :class:`Mesh` over ``devices`` (ranks; default every rank of
        the process group, or ``[0]`` without one)."""
        if devices is None:
            devices = _default_devices()
        devices = list(devices)
        sizes = self.resolve(len(devices))
        shape = tuple(sizes[a] for a in AXIS_ORDER)
        return Mesh(np.asarray(devices).reshape(shape), AXIS_ORDER)


def data_parallel_mesh(devices: "Sequence[int] | None" = None) -> Mesh:
    """All ranks on the ``dp`` axis (the reference's only parallelism)."""
    return MeshSpec(dp=-1).build(devices)


def single_device_mesh(device: "int | None" = None) -> Mesh:
    """A one-rank mesh over ``device`` (default: this process's rank)."""
    return MeshSpec(dp=1).build([world_rank() if device is None else device])


def spec_placements(spec: "PartitionSpec | Sequence", mesh: Mesh) -> tuple:
    """``spec`` as a DTensor sharding on ``mesh``: per mesh axis,
    ``Shard(d)`` where tensor dim ``d`` is split over it, else
    ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    out: "list[Any]" = [Replicate()] * len(mesh.axis_names)
    for dim, part in enumerate(spec):
        for axis in (part if isinstance(part, (tuple, list)) else (part,)):
            if axis is None:
                continue
            if axis not in mesh.axis_names:
                raise MeshShapeError(
                    f"spec {spec!r} names axis {axis!r}, not one of "
                    f"{mesh.axis_names}")
            i = mesh.axis_names.index(axis)
            if not isinstance(out[i], Replicate):
                raise MeshShapeError(
                    f"spec {spec!r} splits two dims over axis {axis!r}")
            out[i] = Shard(dim)
    return tuple(out)


def batch_sharding(mesh: Mesh,
                   batch_axes: Sequence[str] = ("dp", "fsdp")) -> tuple:
    """Placements that split the leading (batch) dim over the data axes."""
    return spec_placements(P(tuple(batch_axes)), mesh)


def replicated_sharding(mesh: Mesh) -> tuple:
    return spec_placements(P(), mesh)


def mesh_axis_size(mesh: Mesh, axis: str) -> int:
    return mesh.shape[axis]


def current_mesh() -> "Mesh | None":
    """The mesh of the innermost :func:`mesh_context`, or None."""
    return _CURRENT.get()


@contextlib.contextmanager
def mesh_context(mesh: Mesh):
    """``with mesh_context(mesh):`` makes ``mesh`` the ambient mesh
    (:func:`current_mesh`), as the reference's ``jax.set_mesh`` scope."""
    token = _CURRENT.set(mesh)
    try:
        yield mesh
    finally:
        _CURRENT.reset(token)
