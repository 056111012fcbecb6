"""Collectives over the named mesh axes: the port of
``sparkdl_tpu.parallel.collectives``.

The reference calls these inside ``shard_map``, where an axis name is
bound to the chips along it. The port runs one process per card
(``runner/``): an axis name is bound by the ambient
:func:`~sparkdl_torch.runtime.mesh.mesh_context` (or an explicit
``mesh=``) to the process group of this rank's peers along it, and each
helper is a ``torch.distributed`` call on that group. Outside a mesh the
axis is unbound and the helpers raise, as the reference's do. On an
axis of size 1 every collective is the identity, so a world of one needs
no process group.

Each helper takes a tree (nested dicts, lists and tuples of tensors) and
an axis name, or a tuple of names, as the reference's do. Those that the
reference differentiates are ``autograd.Function`` s with the adjoint
collective as their backward, under torch's convention that each rank's
loss is one term of the total (``torch.distributed.nn``'s): the gradient
of an all-reduce is all-reduced, of an all-gather reduce-scattered, of a
reduce-scatter all-gathered.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Sequence

import torch

from sparkdl_torch.runtime.mesh import Mesh, MeshShapeError, current_mesh
from sparkdl_torch.runtime.tree import tree_leaves, tree_map

__all__ = [
    "AxisGroup",
    "axis_group",
    "cross_replica_mean",
    "psum_grads",
    "reduce_scatter_grads",
    "all_gather_params",
    "global_norm",
    "all_reduce",
    "all_gather",
    "reduce_scatter",
    "all_to_all",
    "split_replicated",
    "gather_replicated",
]

AxisNames = "str | Sequence[str]"


@dataclasses.dataclass(frozen=True)
class AxisGroup:
    """This rank's peers along mesh axes: how many (``size``), its
    index among them (``index``), their global ranks in index order
    (``ranks``) and their process group (None when ``size`` is 1)."""

    size: int
    index: int
    ranks: "tuple[int, ...]"
    group: Any = None

    def rank_at(self, index: int) -> int:
        """Global rank of the peer at ``index`` (mod ``size``)."""
        return self.ranks[index % self.size]


def axis_group(axis: "str | Sequence[str]", mesh: "Mesh | None" = None) -> AxisGroup:
    """The :class:`AxisGroup` of ``axis`` (or a tuple of axes, flattened
    in the order given) on ``mesh``, default the ambient mesh. Raises
    outside a mesh (the reference's unbound-axis error) and when an axis
    of size > 1 has no process group to run over."""
    mesh = mesh if mesh is not None else current_mesh()
    axes = (axis,) if isinstance(axis, str) else tuple(axis)
    if mesh is None:
        raise ValueError(
            f"mesh axis {axes} is unbound: call under "
            "runtime.mesh.mesh_context(mesh) or pass mesh=")
    for a in axes:
        if a not in mesh.axis_names:
            raise ValueError(f"axis {a!r} not in the mesh axes {mesh.axis_names}")
    from sparkdl_torch.runtime.mesh import _pg_up, world_rank

    size = math.prod(mesh.shape[a] for a in axes)
    # without a process group this process stands for the mesh's first rank
    rank = world_rank() if _pg_up() else int(mesh.devices.reshape(-1)[0])
    ranks = tuple(mesh.axis_ranks(axes, rank))
    if size == 1:
        return AxisGroup(1, 0, ranks)
    group = mesh.group(axes)
    if group is None:
        raise MeshShapeError(
            f"axis {axes} splits {size} ways and needs a process group of "
            f"{mesh.size} ranks: run under TorchRunner")
    return AxisGroup(size, ranks.index(rank), ranks, group)


def _dist():
    import torch.distributed as dist

    return dist


# -- the raw collectives (one tensor, no autograd) ------------------------------

def _all_reduce(x: torch.Tensor, ag: AxisGroup) -> torch.Tensor:
    out = x.clone()
    if ag.size > 1:
        _dist().all_reduce(out, group=ag.group)
    return out


def _all_gather(x: torch.Tensor, ag: AxisGroup, dim: int) -> torch.Tensor:
    """Every peer's ``x`` concatenated along ``dim``, in index order."""
    if ag.size == 1:
        return x
    moved = x.movedim(dim, 0).contiguous()
    out = torch.empty((ag.size * moved.shape[0],) + tuple(moved.shape[1:]),
                      dtype=x.dtype, device=x.device)
    _dist().all_gather_into_tensor(out, moved, group=ag.group)
    return out.movedim(0, dim)


def _reduce_scatter(x: torch.Tensor, ag: AxisGroup, dim: int) -> torch.Tensor:
    """The sum over peers of ``x``, this rank's ``1/size`` chunk of
    ``dim``."""
    if ag.size == 1:
        return x
    moved = x.movedim(dim, 0).contiguous()
    out = torch.empty((moved.shape[0] // ag.size,) + tuple(moved.shape[1:]),
                      dtype=x.dtype, device=x.device)
    _dist().reduce_scatter_tensor(out, moved, group=ag.group)
    return out.movedim(0, dim)


def _chunk(x: torch.Tensor, ag: AxisGroup, dim: int) -> torch.Tensor:
    """This rank's ``1/size`` chunk of ``dim`` (no communication)."""
    if ag.size == 1:
        return x
    n = x.shape[dim] // ag.size
    return x.narrow(dim, ag.index * n, n)


def _all_to_all(x: torch.Tensor, ag: AxisGroup) -> torch.Tensor:
    """Chunk ``j`` of dim 0 goes to peer ``j``; chunk ``i`` of the result
    came from peer ``i``. Written as one batch of sends and receives, the
    exchange the ring's hops make, which a train step's CUDA graph
    captures on the card (``tools/parallel4_probe.py``'s MoE step at
    ep = 4)."""
    if ag.size == 1:
        return x
    dist = _dist()
    x = x.contiguous()
    out = torch.empty_like(x)
    mine, theirs = x.chunk(ag.size), out.chunk(ag.size)
    theirs[ag.index].copy_(mine[ag.index])
    ops = []
    for j in range(ag.size):
        if j != ag.index:
            ops += [dist.P2POp(dist.isend, mine[j], ag.rank_at(j), ag.group),
                    dist.P2POp(dist.irecv, theirs[j], ag.rank_at(j), ag.group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


# -- differentiable forms -------------------------------------------------------

class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ag):
        ctx.ag = ag
        return _all_reduce(x, ag)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.ag), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ag, dim):
        ctx.ag, ctx.dim = ag, dim
        return _all_gather(x, ag, dim)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.ag, ctx.dim), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ag, dim):
        ctx.ag, ctx.dim = ag, dim
        return _reduce_scatter(x, ag, dim)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.ag, ctx.dim), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ag):
        ctx.ag = ag
        return _all_to_all(x, ag)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.ag), None


def all_reduce(x: torch.Tensor, ag: AxisGroup) -> torch.Tensor:
    """Sum of ``x`` over the peers of ``ag`` (differentiable)."""
    return _AllReduce.apply(x, ag) if ag.size > 1 else x


def all_gather(x: torch.Tensor, ag: AxisGroup, dim: int = 0) -> torch.Tensor:
    """The peers' ``x`` concatenated along ``dim`` (differentiable)."""
    return _AllGather.apply(x, ag, dim) if ag.size > 1 else x


def reduce_scatter(x: torch.Tensor, ag: AxisGroup, dim: int = 0) -> torch.Tensor:
    """This rank's chunk of ``dim`` of the peers' sum (differentiable)."""
    return _ReduceScatter.apply(x, ag, dim) if ag.size > 1 else x


def all_to_all(x: torch.Tensor, ag: AxisGroup) -> torch.Tensor:
    """Chunk ``j`` of dim 0 to peer ``j`` (differentiable: the gradient
    goes back the same way)."""
    return _AllToAll.apply(x, ag) if ag.size > 1 else x


class _SplitReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ag, dim):
        ctx.ag, ctx.dim = ag, dim
        return _chunk(x, ag, dim)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g.contiguous(), ctx.ag, ctx.dim), None, None


class _GatherReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ag, dim):
        ctx.ag, ctx.dim = ag, dim
        return _all_gather(x, ag, dim)

    @staticmethod
    def backward(ctx, g):
        return _chunk(g, ctx.ag, ctx.dim), None, None


def split_replicated(x: torch.Tensor, ag: AxisGroup, dim: int) -> torch.Tensor:
    """This rank's chunk of ``dim`` of an ``x`` that every peer holds
    whole. Its gradient is the peers' chunk gradients gathered, so every
    peer gets the whole gradient (the reference's ``shard_map`` entry
    with the dim split: each rank's loss the same global one)."""
    return _SplitReplicated.apply(x, ag, dim) if ag.size > 1 else x


def gather_replicated(x: torch.Tensor, ag: AxisGroup, dim: int) -> torch.Tensor:
    """The inverse of :func:`split_replicated`: the peers' chunks gathered
    along ``dim`` into the whole on every peer; the gradient of a chunk is
    its part of the whole's gradient (the reference's ``shard_map`` exit)."""
    return _GatherReplicated.apply(x, ag, dim) if ag.size > 1 else x


# -- the reference's tree helpers -----------------------------------------------

def cross_replica_mean(tree: Any, axis: AxisNames = "dp", *,
                       mesh: "Mesh | None" = None) -> Any:
    """Mean-allreduce a tree over the data axes (Horovod's averaged
    gradients): one all-reduce per leaf, divided by the axis size."""
    ag = axis_group(axis, mesh)
    return tree_map(lambda g: all_reduce(g, ag) / ag.size, tree)


def psum_grads(grads: Any, axis: AxisNames = "dp", *,
               mesh: "Mesh | None" = None) -> Any:
    """Sum-allreduce gradients (the caller owns any scaling)."""
    ag = axis_group(axis, mesh)
    return tree_map(lambda g: all_reduce(g, ag), grads)


def reduce_scatter_grads(grads: Any, axis: str = "fsdp", *,
                         mesh: "Mesh | None" = None) -> Any:
    """Reduce-scatter each leaf over ``axis`` along its dim 0: this rank
    keeps its shard of the summed gradient (ZeRO). Leaves whose dim 0 the
    axis size does not divide (scalars, small biases) are all-reduced
    whole instead."""
    ag = axis_group(axis, mesh)

    def rs(g: torch.Tensor) -> torch.Tensor:
        if g.dim() == 0 or g.shape[0] % ag.size != 0:
            return all_reduce(g, ag)
        return reduce_scatter(g, ag, 0)

    return tree_map(rs, grads)


def all_gather_params(params: Any, axis: str = "fsdp", *,
                      full_shapes: Any = None,
                      mesh: "Mesh | None" = None) -> Any:
    """All-gather dim-0 shards into whole leaves for the forward.

    ``full_shapes`` (a matching tree of the unsharded shapes) says which
    leaves :func:`reduce_scatter_grads` scattered: those whose dim 0 the
    axis size divides. The others are returned as they are, not gathered
    into ``size`` stacked copies. Without it every leaf with a dim is
    taken as sharded."""
    ag = axis_group(axis, mesh)

    def ag_one(p: torch.Tensor, full: Any = None) -> torch.Tensor:
        if p.dim() == 0:
            return p
        if full is not None:
            shape = tuple(full)
            if len(shape) == 0 or shape[0] % ag.size != 0:
                return p  # never scattered
        return all_gather(p, ag, 0)

    if full_shapes is None:
        return tree_map(ag_one, params)
    shapes = iter(_shape_leaves(full_shapes))
    return tree_map(lambda p: ag_one(p, next(shapes)), params)


def _shape_leaves(tree: Any) -> "list[tuple]":
    """The leaves of a tree of shapes (tuples of ints, ``torch.Size`` or
    anything with ``.shape``), each as a tuple."""
    out: "list[tuple]" = []

    def walk(node: Any) -> None:
        if hasattr(node, "shape"):
            out.append(tuple(node.shape))
        elif isinstance(node, dict):
            for v in node.values():
                walk(v)
        elif isinstance(node, (list, tuple)) and not all(
                isinstance(d, int) for d in node):
            for v in node:
                walk(v)
        else:
            out.append(tuple(node))

    walk(tree)
    return out


def global_norm(tree: Any, axis: "AxisNames | None" = None, *,
                mesh: "Mesh | None" = None) -> torch.Tensor:
    """L2 norm of a tree in float32; with ``axis``, the global norm of a
    tree whose leaves are sharded over it (the squares summed across the
    peers)."""
    leaves = tree_leaves(tree)
    sq = sum(x.float().square().sum() for x in leaves)
    sq = torch.as_tensor(sq, dtype=torch.float32)
    if axis is not None:
        sq = all_reduce(sq, axis_group(axis, mesh))
    return sq.sqrt()
