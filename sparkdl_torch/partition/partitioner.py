"""The Partitioner: one object that owns every placement decision (the
port of ``sparkdl_tpu.partition.partitioner``).

- **where a batch goes** (:meth:`~Partitioner.shard_batch`, the
  placements of :meth:`~Partitioner.batch_sharding`),
- **where params and optimizer state live** (:meth:`shard_params`,
  :meth:`shard_opt_state`; specs from the rule tables of
  ``partition/rules.py`` and the ZeRO policy of ``partition/zero.py``),
- **how a step runs across ranks** (:meth:`wrap_step` and the
  :class:`ShardedOptimizer` that :meth:`shard_opt_state` returns),
- **how state leaves the mesh** (:meth:`gather_for_checkpoint`).

The reference lets XLA derive the collectives from shardings. The port
runs one process per card over a ``torch.distributed`` process group
(``runner/``), and writes its collectives out, on flat buffers, inside
the train step, so that a step stays one CUDA graph on the card: the
gradient all-reduce over the data axes, and for state sharded on an axis
(ZeRO, or rule-placed params) a reduce-scatter of the gradients into
each rank's shard, the optimizer step on the shard, and an all-gather of
the updated parameters. Parameters stay whole in every rank's module
(they are the all-gather's destination); what a rank owns alone is its
shard of the optimizer state, so ``opt_state_bytes_per_chip`` falls to
~1/n on an n-way shard. Each rank feeds its local shard of the global
batch, as under the reference's multi-process runner.

Implementations:

- :class:`SingleDevicePartitioner`: no mesh, one device. What each
  executor of a :class:`~sparkdl_torch.serving.replicas.ReplicaPool`
  runs, and ``finetune_classifier``'s default without a process group.
- :class:`DataParallelPartitioner`: batch over the data axes, params
  replicated; ``zero_axis="fsdp"`` shards the optimizer state on that
  axis.
- :class:`SPMDPartitioner`: params placed by a rule table on the fsdp
  axis (their optimizer state with them), plus ZeRO on ``zero_axis``
  where a rule left a leaf replicated.
- :class:`LocalDevicePartitioner`: no process group; the devices one
  process drives, a batch's rows split over them (data-parallel
  inference in a :class:`~sparkdl_torch.transformers._inference.
  BatchedRunner`).

Every mesh axis trains. The batch splits over the batch axes only; a
parameter stays whole on every rank unless a rule places its optimizer
state (the fsdp, dp or pp entries of a rule table, or ZeRO) or a parallel
layer holds it split (``tp``: Megatron's tensor parallelism, the model
built under the mesh, ``parallel/tensor_parallel``; ``ep``: the expert
stacks of ``parallel/expert_parallel``); gradients reduce over the ranks
that hold the same slice. How they reduce follows the gradient each
axis's layers leave on a rank:

- ``tp`` and ``pp`` ranks run one model between them, and their layers
  (the conjugate all-reduces of the tensor-parallel layers, the
  pipeline's broadcast of the last stage's output) leave each of them
  the whole gradient of that model's one loss: nothing is summed over
  them;
- over every other axis (the batch axes, ``sp``, ``ep``) each rank's
  loss is one term of the total and the collectives in between are the
  adjoints of their forwards (the ring's K/V accumulators travel back to
  their owners, the experts' all-to-all runs backwards): a rank's
  gradient is its part of the sum, so they are summed, and divided by
  the number of terms. Under ``sp`` every rank feeds the same rows (its
  block of their tokens), and the terms are equal; under ``ep`` the
  batch splits over ``ep`` when it is a batch axis, and otherwise every
  ``ep`` rank feeds the same rows.
"""

from __future__ import annotations

import contextlib
import inspect
from typing import Any, Callable, Sequence

import torch

from sparkdl_torch.ops._dispatch import resolve_device
from sparkdl_torch.partition.mesh_factory import axis_sizes
from sparkdl_torch.partition.rules import (
    match_partition_rules,
    tree_path_names,
    unflatten_names,
)
from sparkdl_torch.partition.zero import (
    export_opt_state_bytes,
    zero_partition_specs,
)
from sparkdl_torch.runtime.mesh import (
    Mesh,
    MeshShapeError,
    PartitionSpec as P,
    _pg_up,
    mesh_context,
    rank_device,
    spec_placements,
    world_size,
)
from sparkdl_torch.runtime.tree import tree_map

__all__ = [
    "Partitioner",
    "SingleDevicePartitioner",
    "LocalDevicePartitioner",
    "DataParallelPartitioner",
    "SPMDPartitioner",
    "ShardedOptimizer",
]

#: the model axes a mesh may split besides the batch axes
_MODEL_AXES = ("tp", "pp", "sp", "ep")
#: axes whose ranks run one model and hold one loss between them: a
#: gradient is not summed over them
_COPY_AXES = ("tp", "pp")
#: axes whose placement the model's own layers hold (a slice per rank)
_LAYER_AXES = ("tp", "ep")
_TP = "tp"


def _parts(entry: Any) -> tuple:
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


class Partitioner:
    """Base class: a mesh (possibly None), the batch axes, and the spec
    policies. Subclasses override the ``*_specs`` hooks; the placement
    and collective mechanics live here once."""

    def __init__(self, mesh: "Mesh | None" = None, *,
                 batch_axes: Sequence[str] = ("dp", "fsdp"),
                 zero_axis: "str | None" = None, device: Any = None):
        self.mesh = mesh
        if mesh is not None:
            missing = [a for a in batch_axes if a not in mesh.axis_names]
            if missing:
                raise MeshShapeError(
                    f"batch axes {missing} not in mesh axes "
                    f"{tuple(mesh.axis_names)}"
                )
            if zero_axis is not None and zero_axis not in mesh.axis_names:
                raise MeshShapeError(
                    f"zero_axis {zero_axis!r} not in mesh axes "
                    f"{tuple(mesh.axis_names)}"
                )
            idle = {a: s for a, s in mesh.shape.items()
                    if s > 1 and a not in batch_axes and a not in _MODEL_AXES}
            if idle:
                raise MeshShapeError(
                    f"mesh axes {idle} are neither batch axes "
                    f"{tuple(batch_axes)} nor model axes {_MODEL_AXES}: "
                    "name them in batch_axes to split the batch over them")
        self.batch_axes = tuple(batch_axes)
        self.zero_axis = zero_axis
        if device is not None:
            self.device = resolve_device(device)
        elif _pg_up():
            self.device = rank_device()  # its card under NCCL, gloo's CPU
        else:
            # as SingleDevicePartitioner: the card, raising without one;
            # the CPU only when asked for
            self.device = resolve_device("cuda")

    # -- spec policy hooks ---------------------------------------------------
    def batch_spec(self) -> P:
        """Leading (batch) dim split over the data axes."""
        return P(self.batch_axes)

    def param_specs(self, params: Any, *, count_hits: bool = False) -> Any:
        """Tree of :class:`PartitionSpec` for the params (a module, or a
        tree of tensors). Replicated here; :class:`SPMDPartitioner`
        consults its rule table. ``count_hits`` lands matches in the
        rule-hit metric: only :meth:`shard_params` sets it."""
        del count_hits
        return unflatten_names(params, [P() for _ in tree_path_names(params)])

    def opt_specs(self, opt_state: Any, *, count_hits: bool = False) -> Any:
        """Specs for the optimizer state (a tree keyed by parameter name,
        each leaf shaped like its parameter): the param rules re-matched
        over the state's names, then, with ``zero_axis`` set,
        ZeRO-sharded along that axis wherever still replicated."""
        base = self._opt_base_specs(opt_state, count_hits=count_hits)
        if self.zero_axis is None:
            return base
        return zero_partition_specs(
            opt_state, axis=self.zero_axis,
            axis_size=self._axis_size(self.zero_axis), base_specs=base,
        )

    def _opt_base_specs(self, opt_state: Any, *,
                        count_hits: bool = False) -> Any:
        del count_hits
        return unflatten_names(
            opt_state, [P() for _ in tree_path_names(opt_state)])

    # -- derived shardings ---------------------------------------------------
    def _named(self, spec: P) -> tuple:
        assert self.mesh is not None
        return spec_placements(spec, self.mesh)

    def batch_sharding(self) -> tuple:
        """Placements of a batch on the mesh (``Shard(0)`` on the data
        axes)."""
        return self._named(self.batch_spec())

    def chain_batch_sharding(self) -> tuple:
        """For a stacked ``[K, batch, ...]`` fused-dispatch feed: K is the
        chained dim (unsharded), batch stays on the data axes."""
        return self._named(P(None, self.batch_axes))

    def replicated_sharding(self) -> tuple:
        return self._named(P())

    # -- placement -----------------------------------------------------------
    def data_index(self) -> int:
        """This rank's index among the ``data_axis_size`` batch shards."""
        if self.mesh is None:
            return 0
        idx = 0
        for a in self.batch_axes:
            idx = idx * self._axis_size(a) + self.mesh.coordinate(a)
        return idx

    def shard_batch(self, arrays: Any, *, check: bool = True,
                    local: bool = False) -> Any:
        """Host batch -> this rank's rows on its device.

        ``arrays`` is the GLOBAL batch: each leaf's leading dim is split
        into ``data_axis_size`` contiguous shards and this rank keeps its
        own, loud on a leading dim the data axes cannot divide.
        ``local=True``: the leaves are this rank's shard already (each
        rank feeds its own, as ``finetune_classifier`` takes them) and
        move whole. ``check=False`` skips the divisibility walk."""
        n = self.data_axis_size
        if check and n > 1 and not local:
            for name, leaf in tree_path_names(arrays):
                dim = tuple(getattr(leaf, "shape", (0,)))
                if dim and dim[0] % n != 0:
                    raise MeshShapeError(
                        f"batch leaf {name!r} has leading dim {dim[0]}, "
                        f"not divisible by the {n}-way data axes "
                        f"{self.batch_axes} of the "
                        f"{self.mesh.size}-device mesh"
                    )
        i = 0 if local else self.data_index()

        def put(a):
            t = torch.as_tensor(a)
            if n > 1 and not local:
                step = t.shape[0] // n
                t = t[i * step:(i + 1) * step]
            return t.to(self.device, non_blocking=True)

        return tree_map(put, arrays)

    def shard_params(self, model: torch.nn.Module) -> torch.nn.Module:
        """Place ``model`` for training: on this rank's device, its
        parameters checked against their specs (the one placement that
        counts rule hits) and, on a live process group, every parameter
        and buffer broadcast from rank 0 so the replicas start equal
        (HorovodRunner's ``broadcast_parameters``). A model on the card
        is never moved off it: a partitioner on the CPU raises for one."""
        on = {t.device for t in (*model.parameters(), *model.buffers())}
        if self.device.type != "cuda" and any(d.type == "cuda" for d in on):
            raise ValueError(
                f"the model lives on {sorted(map(str, on))} and this "
                f"partitioner on {self.device}: pass device= for the card "
                "(the partitioner does not move a model off it)")
        model.to(self.device)
        specs = self.param_specs(model, count_hits=True)
        split = self._layer_split(model)
        self._check_divisible(model, specs, "param")
        group = self._group(None)
        if group is not None and world_size() > 1:
            import torch.distributed as dist

            with torch.no_grad():
                # whole tensors from rank 0; a layer's slice from the first
                # of the ranks that hold the same slice (the same
                # coordinate on its axis)
                whole = [t for n, t in (*model.named_parameters(),
                                        *model.named_buffers())
                         if n not in split]
                jobs = [(whole, group, 0)]
                for axis in sorted(set(split.values())):
                    peers = tuple(a for a in self._split_axes() if a != axis)
                    if peers:  # else no other rank holds this slice
                        jobs.append((
                            [p for n, p in model.named_parameters()
                             if split.get(n) == axis],
                            self.mesh.group(peers),
                            self.mesh.axis_ranks(peers)[0]))
                for tensors, grp, src in jobs:
                    for flat, views in _flat_groups(tensors):
                        dist.broadcast(flat, src=src, group=grp)
                        _copy_back(flat, views)
        return model

    def _layer_split(self, model: torch.nn.Module) -> "dict[str, str]":
        """``{name: axis}`` of the parameters ``model``'s layers hold as
        this rank's slice (over ``tp`` or ``ep``); raises under a ``tp``
        axis > 1 for a model with none (one built without the mesh:
        every rank would hold it whole)."""
        from sparkdl_torch.parallel.tensor_parallel import split_params

        split = {n: axis for n, (axis, _, _) in split_params(model).items()}
        if self._axis_size(_TP) > 1 and _TP not in split.values():
            raise ValueError(
                f"the mesh splits tp {self._axis_size(_TP)} ways and the model "
                "holds no tensor-parallel layer: build it under the mesh "
                "(mesh= or mesh_context) and load its slice "
                "(models.convert.shard_state_dict)")
        return split

    def shard_opt_state(self, optimizer: torch.optim.Optimizer,
                        model: torch.nn.Module) -> "ShardedOptimizer":
        """The optimizer step for ``model`` under this mesh: a
        :class:`ShardedOptimizer` that averages the gradients over the
        data axes and keeps each parameter's optimizer state on the
        shard its spec gives this rank."""
        named = dict(model.named_parameters())
        specs = self.opt_specs(named, count_hits=True)
        split = self._layer_split(model)
        self._check_divisible(named, specs, "opt")
        return ShardedOptimizer(self, model, optimizer, specs, split=split)

    def shard_replicated(self, tree: Any) -> Any:
        """Small replicated leaves (step counters) on this rank's device."""
        return tree_map(lambda a: torch.as_tensor(a).to(self.device), tree)

    def gather_for_checkpoint(self, tree: Any) -> Any:
        """``tree`` with every sharded (DTensor) leaf gathered whole:
        what a layout-independent export wants. The
        :class:`~sparkdl_torch.checkpoint.CheckpointManager` saves
        sharded state directly (DCP records the layout)."""
        leaves = [leaf.full_tensor() if hasattr(leaf, "full_tensor") else leaf
                  for _, leaf in tree_path_names(tree)]
        return unflatten_names(tree, leaves)

    # -- the step ------------------------------------------------------------
    def wrap_step(self, step_fn: Callable, state: Any = None) -> Callable:
        """``step(batch) -> metrics`` whose metrics are the mean over the
        ranks whose losses are terms of the total (:meth:`grad_terms`:
        each saw its shard of the batch, or, over ``sp``, its block of the
        same rows). The gradient collectives live in the
        :class:`ShardedOptimizer`."""
        del state
        if self.mesh is not None and self.mesh.size != world_size():
            raise MeshShapeError(
                f"a step over the {self.mesh.size}-device mesh needs a "
                f"process group of {self.mesh.size} ranks, got "
                f"{world_size()}: run it under TorchRunner")
        group = self._data_group()
        n = self.grad_terms
        if group is None or n == 1:
            return step_fn  # nothing to average

        def wrapped(batch):
            import torch.distributed as dist

            metrics = step_fn(batch)
            keys = sorted(metrics)
            flat = torch.stack([metrics[k].float() for k in keys])
            dist.all_reduce(flat, group=group)
            flat = flat / n
            return {k: flat[i] for i, k in enumerate(keys)}

        wrapped.graph_key = getattr(step_fn, "graph_key", None)
        return wrapped

    def wrap_apply(self, apply_fn: Callable, params: Any = None) -> Callable:
        """``f(params, batch)``: ``apply_fn`` over this rank's rows of the
        global ``batch`` (its output is this rank's rows)."""
        del params
        return lambda p, batch: apply_fn(p, self.shard_batch(batch))

    # -- introspection / context ---------------------------------------------
    def _axis_size(self, axis: str) -> int:
        if self.mesh is None:
            return 1
        return int(self.mesh.shape[axis])

    def _group(self, axis: "str | None"):
        """The process group of ``axis`` (None: every rank), or None when
        no process group is up (nothing to communicate)."""
        import torch.distributed as dist

        if self.mesh is None or not (dist.is_available()
                                     and dist.is_initialized()):
            return None
        if axis is None:
            return dist.group.WORLD
        return self.mesh.group(axis)

    def _split_axes(self) -> "tuple[str, ...]":
        """The mesh axes of size > 1, in mesh order."""
        if self.mesh is None:
            return ()
        return tuple(a for a in self.mesh.axis_names if self._axis_size(a) > 1)

    def _term_axes(self) -> "tuple[str, ...]":
        """The split axes over which each rank's loss is one term of the
        total: every split axis but ``tp`` and ``pp``."""
        return tuple(a for a in self._split_axes() if a not in _COPY_AXES)

    @property
    def grad_terms(self) -> int:
        """The number of loss terms a gradient sums over (the product of
        the :meth:`_term_axes`' sizes): what it is divided by."""
        n = 1
        for a in self._term_axes():
            n *= self._axis_size(a)
        return n

    def _data_group(self, axes: "tuple[str, ...] | None" = None):
        """The process group over ``axes`` (default :meth:`_term_axes`):
        every rank when they are all the split axes, None when there are
        none or no process group is up."""
        axes = self._term_axes() if axes is None else axes
        if not axes or self._group(None) is None:
            return None
        if axes == self._split_axes():
            return self._group(None)
        return self.mesh.group(axes)

    @property
    def data_axis_size(self) -> int:
        """Ways the batch dim is split (1 = no splitting)."""
        n = 1
        for a in self.batch_axes:
            n *= self._axis_size(a)
        return n

    def mesh_context(self):
        if self.mesh is None:
            return contextlib.nullcontext()
        return mesh_context(self.mesh)

    def describe(self) -> "dict[str, Any]":
        """Operator/bench view: kind, axis sizes, batch/zero policy."""
        return {
            "kind": type(self).__name__,
            "axes": axis_sizes(self.mesh),
            "batch_axes": list(self.batch_axes),
            "zero_axis": self.zero_axis,
            "data_axis_size": self.data_axis_size,
        }

    def export_opt_state_bytes(self, opt_state: Any) -> int:
        """Per-rank optimizer-state bytes into the spine
        (``sparkdl_opt_state_bytes{axis=...}``)."""
        return export_opt_state_bytes(opt_state, axis=self.zero_axis)

    # -- validation ----------------------------------------------------------
    def _check_divisible(self, tree: Any, specs: Any, what: str) -> None:
        """Loud on a dim its spec splits more ways than it divides. A
        ``tp`` or ``ep`` entry is not counted: the model's layers hold
        their slices (each layer checked its whole when it was built), and
        a parameter they hold whole is replicated over that axis."""
        if self.mesh is None:
            return
        for (name, leaf), (_, spec) in zip(tree_path_names(tree),
                                           tree_path_names(specs)):
            shape = tuple(getattr(leaf, "shape", ()))
            for i, part in enumerate(spec):
                if part is None or i >= len(shape):
                    continue
                n = 1
                for a in _parts(part):
                    if a not in _LAYER_AXES:
                        n *= self._axis_size(a)
                if n > 1 and shape[i] % n != 0:
                    raise MeshShapeError(
                        f"{what} leaf {name!r} shape {shape}: dim {i} "
                        f"({shape[i]}) not divisible by the {n}-way "
                        f"{_parts(part)} split on the "
                        f"{self.mesh.size}-device mesh"
                    )


class SingleDevicePartitioner(Partitioner):
    """Everything on one device (``device``, the card by default, which
    raises where CUDA is absent).

    What a :class:`~sparkdl_torch.serving.replicas.ReplicaPool` executor
    runs (the pool scales by replicating single-device partitioners, not
    by splitting batches), and ``finetune_classifier``'s default where no
    process group is up."""

    def __init__(self, device: Any = None):
        super().__init__(mesh=None, batch_axes=(),
                         device=device if device is not None else "cuda")

    def batch_spec(self) -> P:
        return P()

    def _named(self, spec: P) -> Any:
        # no mesh: every derived "sharding" is the one device
        return self.device

    def shard_batch(self, arrays: Any, *, check: bool = True,
                    local: bool = False) -> Any:
        """Every leaf of ``arrays`` as a tensor on the device."""
        del check, local
        return tree_map(lambda a: torch.as_tensor(a).to(self.device), arrays)

    def shard_opt_state(self, optimizer: torch.optim.Optimizer,
                        model: torch.nn.Module) -> torch.optim.Optimizer:
        return optimizer  # one device: the optimizer runs as it is

    def gather_for_checkpoint(self, tree: Any) -> Any:
        return tree

    def wrap_step(self, step_fn: Callable, state: Any = None) -> Callable:
        return step_fn  # nothing to reduce on one device

    def wrap_apply(self, apply_fn: Callable, params: Any = None) -> Callable:
        return apply_fn  # the module's weights already live on the device

    def describe(self) -> "dict[str, Any]":
        out = super().describe()
        out["device"] = str(self.device)
        return out


class DataParallelPartitioner(Partitioner):
    """Batch over the data axes, params replicated (the reference-parity
    layout), with an optional ZeRO twist: ``zero_axis="fsdp"`` shards the
    optimizer state, and so the weight update, along the fsdp axis while
    params stay replicated. Default mesh: every rank on ``dp``."""

    def __init__(self, mesh: "Mesh | None" = None, *,
                 batch_axes: Sequence[str] = ("dp", "fsdp"),
                 zero_axis: "str | None" = None, device: Any = None):
        if mesh is None:
            from sparkdl_torch.runtime.mesh import data_parallel_mesh

            mesh = data_parallel_mesh()
        super().__init__(mesh, batch_axes=batch_axes, zero_axis=zero_axis,
                         device=device)


class SPMDPartitioner(Partitioner):
    """Params placed by a regex rule table (partition/rules.py), batch
    over the data axes, optimizer state rule-matched the same way plus
    ZeRO sharding along ``zero_axis`` where replicated: dp x tp x fsdp,
    the reference's general form. A rule's ``tp`` (``ep``) entry is live
    where the model's tensor-parallel layers (expert stacks) hold that
    parameter's slice; a parameter they hold whole (the embeddings) is
    replicated over that axis. The rules' fsdp entries shard the optimizer
    state of what a rank holds: a whole parameter, or a ``tp`` slice."""

    def __init__(self, mesh: Mesh, rules: "Sequence[tuple[str, P]]", *,
                 batch_axes: Sequence[str] = ("dp", "fsdp"),
                 zero_axis: "str | None" = None, device: Any = None):
        super().__init__(mesh, batch_axes=batch_axes, zero_axis=zero_axis,
                         device=device)
        self.rules = tuple(rules)

    def param_specs(self, params: Any, *, count_hits: bool = False) -> Any:
        return match_partition_rules(self.rules, params,
                                     count_hits=count_hits)

    def _opt_base_specs(self, opt_state: Any, *,
                        count_hits: bool = False) -> Any:
        return match_partition_rules(self.rules, opt_state,
                                     count_hits=count_hits)

    def describe(self) -> "dict[str, Any]":
        out = super().describe()
        out["n_rules"] = len(self.rules)
        return out


# -- the collectives of a step ------------------------------------------------

def _flat_groups(tensors: "list[torch.Tensor]"):
    """``[(flat, views)]``: the tensors concatenated per dtype into one
    flat buffer each, with the list of tensors each one came from."""
    by_dtype: "dict[torch.dtype, list[torch.Tensor]]" = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    return [(torch.cat([t.reshape(-1) for t in ts]), ts)
            for ts in by_dtype.values()]


def _grad_buffers(params: "list[torch.nn.Parameter]"):
    """``[(flat, params, views)]``: one zeroed flat buffer per dtype, and
    a view of it shaped like each parameter, for its gradient."""
    by_dtype: "dict[torch.dtype, list[torch.nn.Parameter]]" = {}
    for p in params:
        by_dtype.setdefault(p.dtype, []).append(p)
    out = []
    for ps in by_dtype.values():
        flat = torch.zeros(sum(p.numel() for p in ps), dtype=ps[0].dtype,
                           device=ps[0].device)
        views, offset = [], 0
        for p in ps:
            views.append(flat[offset:offset + p.numel()].view_as(p))
            offset += p.numel()
        out.append((flat, ps, views))
    return out


def _copy_back(flat: torch.Tensor, targets: "list[torch.Tensor]") -> None:
    offset = 0
    for t in targets:
        n = t.numel()
        t.copy_(flat[offset:offset + n].view_as(t))
        offset += n


class _Sharded:
    """One parameter whose optimizer state lives split along ``dim`` over
    the mesh axes ``axes`` (one axis, or a tuple of them flattened in
    order: ``index`` is this rank's place among their ``n`` ranks)."""

    def __init__(self, name: str, param: torch.nn.Parameter,
                 axes: "tuple[str, ...]", dim: int, n: int, index: int):
        self.name, self.param, self.dim, self.n = name, param, dim, n
        self.axes = axes
        self.index = index
        full = param.shape[dim]
        self.rows = full // n
        moved = param.detach().movedim(dim, 0)
        self.moved_shape = (self.rows,) + tuple(moved.shape[1:])
        self.numel = param.numel() // n
        shard = moved[index * self.rows:(index + 1) * self.rows]
        #: this rank's slice, the parameter its optimizer steps
        self.owned = torch.nn.Parameter(
            shard.movedim(0, dim).contiguous().clone())

    def reload(self) -> None:
        """This rank's slice taken again from the whole parameter."""
        rows = self.param.detach().movedim(self.dim, 0)
        self.owned.detach().copy_(
            rows[self.index * self.rows:(self.index + 1) * self.rows]
            .movedim(0, self.dim))

    def grad_columns(self) -> torch.Tensor:
        """The full gradient as [n, numel/n]: row r is rank r's shard."""
        g = self.param.grad
        if g is None:
            g = torch.zeros_like(self.param)
        return g.movedim(self.dim, 0).reshape(self.n, self.numel)

    def set_grad(self, shard: torch.Tensor) -> None:
        self.owned.grad = shard.view(self.moved_shape).movedim(0, self.dim)

    def owned_flat(self) -> torch.Tensor:
        return self.owned.detach().movedim(self.dim, 0).reshape(-1)

    def write_gathered(self, block: torch.Tensor) -> None:
        """``block`` [n, numel/n]: every rank's updated shard."""
        full = block.reshape((self.n * self.rows,) + self.moved_shape[1:])
        self.param.detach().copy_(full.movedim(0, self.dim))


class _ShardBucket:
    """The sharded parameters of one step that share their shard axes and
    the axes their gradient is summed over besides: one reduce-scatter
    (or, over ``pp``, where every rank holds the whole gradient, this
    rank's rows), one all-reduce over ``rest`` and one all-gather."""

    def __init__(self, partitioner: "Partitioner", axes: "tuple[str, ...]",
                 rest: "tuple[str, ...]"):
        self.axes, self.rest = axes, rest
        self.items: "list[_Sharded]" = []
        #: every rank holds the whole gradient: no sum over ``axes``
        self.copy = axes[0] in _COPY_AXES
        self.group = partitioner._data_group(axes)
        self.rest_group = partitioner._data_group(rest)


class ShardedOptimizer:
    """The update of a step across ranks, with its collectives.

    ``step()`` (called where the train step calls ``optimizer.step()``,
    after the backward):

    1. the gradients of parameters held whole (or as a layer's slice):
       one all-reduce per set of ranks holding the same tensor, in place
       on a flat buffer per dtype that the backward accumulated into
       (each ``p.grad`` is a view of it, bound by :meth:`zero_grad`);
    2. the gradients of parameters whose state is sharded: per set of
       shard axes, one reduce-scatter of a flat buffer (rank r receives
       the sum of its shard's rows; over ``pp``, whose ranks hold the
       whole gradient already, its rows are taken), an all-reduce over
       the remaining axes where there are any;
    3. every gradient divided by the partitioner's
       :attr:`~Partitioner.grad_terms`, then the wrapped optimizer's
       step: the whole parameters in place, the sharded ones on this
       rank's slices;
    4. one all-gather per set of shard axes of the updated slices into
       every rank's whole parameters.

    Which ranks' gradients are summed is the module docstring's rule:
    those holding the same slice, over every axis but ``tp`` and ``pp``.
    A rule's ``tp`` or ``ep`` entry is the layers' placement (a slice
    they hold, or a parameter they hold whole, replicated over that
    axis), never an optimizer shard; its fsdp (dp, pp) entries shard the
    state of whatever the rank holds, a layer's slice included.

    All of it is tensor work on the step's stream, so a CUDA graph of the
    step captures the collectives with it. With one loss term and nothing
    sharded only step 3 runs: the plain optimizer step. The wrapped
    optimizer is the one given when nothing is sharded; otherwise one of
    its class with its ``defaults`` over the owned tensors (one parameter
    group required).
    """

    def __init__(self, partitioner: Partitioner, model: torch.nn.Module,
                 optimizer: torch.optim.Optimizer, specs: "dict[str, P]",
                 split: "dict[str, str] | None" = None):
        split = split or {}
        self.model = model
        named = [(n, p) for n, p in model.named_parameters()
                 if p.requires_grad]
        self._mesh = partitioner.mesh
        self._n = partitioner.grad_terms
        terms = partitioner._term_axes()
        whole: "dict[tuple[str, ...], list[torch.nn.Parameter]]" = {}
        buckets: "dict[tuple, _ShardBucket]" = {}
        for name, p in named:
            axes = [(d, a) for d, part in enumerate(specs.get(name, P()))
                    for a in _parts(part)
                    if a is not None and a not in _LAYER_AXES
                    and partitioner._axis_size(a) > 1]
            # the ranks holding this rank's tensor whose losses are terms
            reduce = tuple(a for a in terms if a != split.get(name))
            if not axes:
                whole.setdefault(reduce, []).append(p)
                continue
            if len({d for d, _ in axes}) > 1:
                raise ValueError(
                    f"param {name!r} spec {specs[name]!r} shards its state on "
                    "two dims: split one dim over a tuple of axes instead")
            shard = tuple(a for _, a in axes)
            if len(shard) > 1 and any(a in _COPY_AXES for a in shard):
                raise ValueError(
                    f"param {name!r} spec {specs[name]!r}: a state shard over "
                    f"{[a for a in shard if a in _COPY_AXES]} takes that axis "
                    "alone")
            n, index = 1, 0
            for a in shard:
                n *= partitioner._axis_size(a)
                index = index * partitioner._axis_size(a) + self._mesh.coordinate(a)
            rest = tuple(a for a in reduce if a not in shard)
            bucket = buckets.get((shard, rest))
            if bucket is None:
                bucket = buckets[(shard, rest)] = _ShardBucket(
                    partitioner, shard, rest)
            bucket.items.append(_Sharded(name, p, shard, axes[0][0], n, index))
        live = partitioner._group(None) is not None and self._n > 1
        #: (group or None, flat, params, views): the whole parameters'
        #: gradient buffers, all-reduced in place and divided
        self._grad_flats = [
            (partitioner._data_group(reduce), flat, ps, views)
            for reduce, params in whole.items()
            for flat, ps, views in (_grad_buffers(params) if live else [])]
        self._buckets = list(buckets.values())
        self.sharded: "list[_Sharded]" = [
            s for b in self._buckets for s in b.items]
        if self.sharded:
            if len(optimizer.param_groups) != 1:
                raise ValueError(
                    "a sharded optimizer state takes an optimizer with one "
                    f"parameter group, got {len(optimizer.param_groups)}")
            owned = {id(s.param): s.owned for s in self.sharded}
            accepted = inspect.signature(type(optimizer)).parameters
            optimizer = type(optimizer)(
                [owned.get(id(p), p) for _, p in named],
                **{k: v for k, v in optimizer.param_groups[0].items()
                   if k != "params" and k in accepted})
        self.optimizer = optimizer

    @property
    def param_groups(self):
        """The wrapped optimizer's groups (what ``optimizer_settings`` and
        ``require_capturable`` read)."""
        return self.optimizer.param_groups

    def zero_grad(self, set_to_none: bool = True) -> None:
        self.model.zero_grad(set_to_none=set_to_none)
        for _, flat, params, views in self._grad_flats:
            flat.zero_()
            for p, v in zip(params, views):
                p.grad = v  # the backward accumulates into the buffer
        for s in self.sharded:
            s.owned.grad = None

    @torch.no_grad()
    def step(self) -> None:
        import torch.distributed as dist

        for b in self._buckets:
            if b.group is None:
                raise MeshShapeError(
                    f"optimizer state sharded {b.items[0].n} ways on "
                    f"{b.axes!r} needs a process group of "
                    f"{self._mesh.size} ranks: run the step under "
                    "TorchRunner")
        for group, flat, params, views in self._grad_flats:
            for p, v in zip(params, views):
                if p.grad is None:
                    v.zero_()
                    p.grad = v
                elif p.grad is not v:  # set outside zero_grad: take it in
                    v.copy_(p.grad)
                    p.grad = v
            if group is not None:
                dist.all_reduce(flat, group=group)
            flat.div_(self._n)
        for b in self._buckets:
            cols = torch.cat([s.grad_columns() for s in b.items], dim=1)
            if b.copy:
                shard = cols[b.items[0].index].contiguous()
            else:
                shard = torch.empty(cols.shape[1], dtype=cols.dtype,
                                    device=cols.device)
                dist.reduce_scatter_tensor(shard, cols.reshape(-1),
                                           group=b.group)
            if b.rest_group is not None:
                dist.all_reduce(shard, group=b.rest_group)
            if self._n > 1:
                shard.div_(self._n)
            offset = 0
            for s in b.items:
                s.set_grad(shard[offset:offset + s.numel])
                offset += s.numel
        self.optimizer.step()
        for b in self._buckets:
            mine = torch.cat([s.owned_flat() for s in b.items])
            n = b.items[0].n
            gathered = torch.empty(n * mine.numel(), dtype=mine.dtype,
                                   device=mine.device)
            dist.all_gather_into_tensor(gathered, mine, group=b.group)
            block = gathered.view(n, mine.numel())
            offset = 0
            for s in b.items:
                s.write_gathered(block[:, offset:offset + s.numel])
                offset += s.numel

    def reload_shards(self) -> None:
        """Take each owned slice again from the module's parameters, after
        they were written from outside the step (a checkpoint restore)."""
        for s in self.sharded:
            s.reload()

    def state_by_name(self) -> "dict[str, dict]":
        """Parameter name -> its optimizer state (the live tensors). The
        state of a parameter sharded across ranks is a DTensor over this
        rank's slice, placed on the mesh, so a checkpoint of it reshards
        to any world size or layout."""
        from torch.distributed.tensor import DTensor

        shards = {s.name: s for s in self.sharded}
        owned = {n: p for n, p in self.model.named_parameters()
                 if p.requires_grad}
        owned.update({s.name: s.owned for s in self.sharded})
        out: "dict[str, dict]" = {}
        for name, p in owned.items():
            st = self.optimizer.state.get(p)
            if not st:
                continue
            s = shards.get(name)
            entry = {}
            for key, v in st.items():
                if (s is not None and isinstance(v, torch.Tensor)
                        and v.shape == s.owned.shape):
                    spec = [None] * s.param.dim()
                    spec[s.dim] = s.axes[0] if len(s.axes) == 1 else s.axes
                    v = DTensor.from_local(
                        v, self._mesh.device_mesh,
                        spec_placements(P(*spec), self._mesh),
                        run_check=False, shape=s.param.shape,
                        stride=s.param.stride())
                entry[key] = v
            out[name] = entry
        return out


class LocalDevicePartitioner:
    """A batch split over the devices that one process drives: the port's
    counterpart of the reference's ``DataParallelPartitioner(
    data_parallel_mesh(local_devices))``, which a
    :class:`~sparkdl_torch.transformers._inference.BatchedRunner` takes as
    ``partitioner=`` (and builds over ``cuda:0`` ... ``cuda:n-1`` itself
    when ``data_parallel`` resolves on).

    No process group: the runner keeps one replica of its apply function
    per device, and each batch's rows are cut into ``data_axis_size``
    contiguous shards, shard ``i`` on ``devices[i]``, the outputs put back
    together in order. A device may repeat: ``["cpu"] * n`` stands in for
    ``n`` cards on the CPU, and ``["cuda:0", "cuda:0"]`` runs two
    replicas, each with its own stream and graphs, on one card."""

    mesh = None
    batch_axes = ("dp",)

    def __init__(self, devices: "Sequence[Any]"):
        devices = [resolve_device(d) for d in devices]
        if not devices:
            raise ValueError("LocalDevicePartitioner needs at least one device")
        #: the devices, ``cuda`` given its index (the current card)
        self.devices = tuple(
            torch.device("cuda", torch.cuda.current_device())
            if d.type == "cuda" and d.index is None else d for d in devices)

    @property
    def device(self) -> torch.device:
        """The first device: where the runner's own ``apply_fn`` runs."""
        return self.devices[0]

    @property
    def data_axis_size(self) -> int:
        return len(self.devices)

    def split(self, arrays: Any) -> "list[Any]":
        """``arrays`` (a tree of arrays or tensors with a leading batch dim
        that ``data_axis_size`` divides) as one tree of contiguous rows per
        device, in device order."""
        n = self.data_axis_size
        rows = {int(leaf.shape[0]) for _, leaf in tree_path_names(arrays)}
        if len(rows) != 1 or next(iter(rows)) % n:
            raise MeshShapeError(
                f"batch leading dims {sorted(rows)} do not split {n} ways "
                f"over {[str(d) for d in self.devices]}")
        m = next(iter(rows)) // n
        return [tree_map(lambda a, i=i: a[i * m:(i + 1) * m], arrays)
                for i in range(n)]

    @staticmethod
    def merge(parts: "list[Any]") -> Any:
        """The per-device host outputs (arrays, or tuples of arrays) back
        into one, rows in device order."""
        import numpy as np

        if isinstance(parts[0], (tuple, list)):
            return tuple(np.concatenate(col) for col in zip(*parts))
        return np.concatenate(parts)

    def shard_batch(self, arrays: Any, *, check: bool = True,
                    local: bool = False) -> "list[Any]":
        """:meth:`split`, each shard's leaves as tensors on its device."""
        del check, local
        return [tree_map(lambda a, d=d: torch.as_tensor(a).to(d), part)
                for part, d in zip(self.split(arrays), self.devices)]

    def describe(self) -> "dict[str, Any]":
        return {"kind": type(self).__name__,
                "devices": [str(d) for d in self.devices],
                "batch_axes": list(self.batch_axes),
                "data_axis_size": self.data_axis_size}
