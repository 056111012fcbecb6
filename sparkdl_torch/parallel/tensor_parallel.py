"""Tensor parallelism: Megatron's column- and row-parallel layers, the
port of ``sparkdl_tpu.parallel.tensor_parallel``.

The reference annotates its kernels with sharding metadata and lets
GSPMD insert the collectives. The port runs one process per card, so
each layer holds this rank's slice of the weight and writes its one
collective out, as Megatron does on NCCL:

- :class:`ColumnParallelDense`: the weight split on its OUTPUT dim, this
  rank's ``[out/tp, in]`` rows and bias slice; the output stays split
  over ``tp``, with no communication in the forward.
- :class:`RowParallelDense`: the weight split on its INPUT dim, this
  rank's ``[out, in/tp]`` columns; the partial products are all-reduced
  over ``tp``, and the replicated bias is added once, after the reduce.

Both compute in their input's dtype (a float32 weight is cast at the op,
as ``models/common.linear`` casts it for a model with a lower compute
dtype).

``ColumnParallelDense -> activation -> RowParallelDense`` (:class:`TPMlpBlock`)
costs one all-reduce in the forward and one in the backward. The two
are the conjugate pair of ``autograd.Function`` s below: identity
forward and all-reduce backward at a column layer's input
(:func:`copy_to_tp`), all-reduce forward and identity backward at a row
layer's output (:func:`reduce_from_tp`). Column layers that read one
input (an attention's q, k and v) share one :func:`copy_to_tp`
(:func:`shared_input`), so one all-reduce sums their parts of the
input's gradient. Everything downstream of a row layer is the same on
every ``tp`` rank, and so is its loss, counted once.

The layers are ``nn.Linear`` s with local shapes (their state-dict keys
are ``weight`` and ``bias``); a rank loads its slice of a whole state
dict with ``models/convert.py``'s :func:`~sparkdl_torch.models.convert.shard_state_dict`.
The reference's ``constrain_dim``, ``param_shardings`` and
``init_sharded`` are GSPMD machinery with no counterpart here: where a
parameter lives is the partitioner's business (``partition/rules.py``),
and which slice a rank holds is fixed when its layers are built.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn as nn
import torch.nn.functional as F

from sparkdl_torch.ops._dispatch import resolve_device
from sparkdl_torch.parallel.collectives import (
    AxisGroup,
    _all_reduce,
    axis_group,
)
from sparkdl_torch.runtime.mesh import Mesh, current_mesh

__all__ = [
    "ColumnParallelDense",
    "RowParallelDense",
    "TPMlpBlock",
    "copy_to_tp",
    "reduce_from_tp",
    "tp_size",
    "dense_pair",
    "shared_input",
    "split_params",
]


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ag):
        ctx.ag = ag
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.ag), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ag):
        return _all_reduce(x, ag)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_tp(x: torch.Tensor, ag: AxisGroup) -> torch.Tensor:
    """Identity forward; the gradient all-reduced over the ``tp`` peers
    (each rank's column slice contributes its part of dL/dx)."""
    return _CopyToTP.apply(x, ag) if ag.size > 1 else x


def reduce_from_tp(x: torch.Tensor, ag: AxisGroup) -> torch.Tensor:
    """All-reduce forward over the ``tp`` peers; identity backward."""
    return _ReduceFromTP.apply(x, ag) if ag.size > 1 else x


def tp_size(mesh: "Mesh | None" = None, tp_axis: str = "tp") -> int:
    """Ways ``mesh`` (default the ambient one) splits ``tp_axis`` (1 with
    no mesh, or no such axis)."""
    mesh = mesh if mesh is not None else current_mesh()
    if mesh is None or tp_axis not in mesh.axis_names:
        return 1
    return int(mesh.shape[tp_axis])


def _split(n: int, parts: int, what: str) -> int:
    if n % parts:
        raise ValueError(f"{what} {n} is not divisible by the {parts}-way tp axis")
    return n // parts


def _as(t: "torch.Tensor | None", like: torch.Tensor) -> "torch.Tensor | None":
    return None if t is None else t.to(like.dtype)


class _TPLinear(nn.Linear):
    """An ``nn.Linear`` holding this rank's slice, on ``device`` (the
    card unless the caller asks for ``"cpu"``); its axis group is
    resolved at the first forward, when every rank takes part."""

    #: the weight dim split over ``tp`` (0: rows, 1: columns)
    split_dim = 0

    def __init__(self, in_features: int, out_features: int, *, bias: bool,
                 tp_axis: str, mesh: "Mesh | None", device, dtype):
        mesh = mesh if mesh is not None else current_mesh()
        tp = tp_size(mesh, tp_axis)
        local = [out_features, in_features]
        local[self.split_dim] = _split(local[self.split_dim], tp,
                                       ("out", "in")[self.split_dim] + " features")
        super().__init__(local[1], local[0], bias=bias,
                         device=resolve_device(device), dtype=dtype)
        self.mesh, self.tp_axis, self.tp = mesh, tp_axis, tp
        self._ag: "AxisGroup | None" = None

    def split_params(self) -> "dict[str, int]":
        """``{parameter name: the dim split over tp}`` of this layer."""
        out = {"weight": self.split_dim}
        if self.bias is not None and self.split_dim == 0:
            out["bias"] = 0
        return out

    def axis(self) -> AxisGroup:
        if self._ag is None:
            self._ag = axis_group(self.tp_axis, self.mesh)
        return self._ag


class ColumnParallelDense(_TPLinear):
    """``y[..., out/tp] = x @ W_slice.T + b_slice``: this rank's
    ``[out/tp, in]`` rows of the weight; the output stays split.

    ``copy_input=False`` leaves out the layer's own :func:`copy_to_tp`:
    for layers that read one input (q, k and v), the caller applies it
    once with :func:`shared_input`, and one all-reduce in the backward
    sums their three parts of dL/dx."""

    split_dim = 0

    def __init__(self, in_features: int, features: int, *, tp_axis: str = "tp",
                 use_bias: bool = True, copy_input: bool = True,
                 mesh: "Mesh | None" = None, device="cuda", dtype=torch.float32):
        super().__init__(in_features, features, bias=use_bias, tp_axis=tp_axis,
                         mesh=mesh, device=device, dtype=dtype)
        self.copy_input = copy_input

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.copy_input:
            x = copy_to_tp(x, self.axis())
        return F.linear(x, self.weight.to(x.dtype), _as(self.bias, x))


class RowParallelDense(_TPLinear):
    """``y = allreduce(x[..., in/tp] @ W_slice.T) + b``: this rank's
    ``[out, in/tp]`` columns of the weight; the replicated bias is added
    once, after the reduce."""

    split_dim = 1

    def __init__(self, in_features: int, features: int, *, tp_axis: str = "tp",
                 use_bias: bool = True, mesh: "Mesh | None" = None,
                 device="cuda", dtype=torch.float32):
        super().__init__(in_features, features, bias=use_bias, tp_axis=tp_axis,
                         mesh=mesh, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = reduce_from_tp(F.linear(x, self.weight.to(x.dtype)), self.axis())
        return y if self.bias is None else y + self.bias.to(y.dtype)


def dense_pair(mesh: "Mesh | None", *, device="cuda", dtype=torch.float32):
    """(column, row) constructors ``(in_features, out_features) ->
    layer`` for a model's Megatron pairs: plain ``nn.Linear`` s where
    ``mesh`` (default the ambient one) has no ``tp`` split, else
    :class:`ColumnParallelDense` and :class:`RowParallelDense`. The
    column constructor takes ``copy_input=`` too (ignored by a plain
    layer)."""
    kw = dict(device=resolve_device(device), dtype=dtype)
    if tp_size(mesh) == 1:
        return (lambda i, o, copy_input=True: nn.Linear(i, o, **kw),
                lambda i, o: nn.Linear(i, o, **kw))
    return (lambda i, o, copy_input=True: ColumnParallelDense(
                i, o, copy_input=copy_input, mesh=mesh, **kw),
            lambda i, o: RowParallelDense(i, o, mesh=mesh, **kw))


def shared_input(x: torch.Tensor, layer: nn.Module) -> torch.Tensor:
    """``x`` as the one input of column-parallel layers built with
    ``copy_input=False`` (``layer`` one of them): :func:`copy_to_tp`
    applied once, so their gradients of ``x`` are all-reduced together.
    ``x`` itself where ``layer`` is a plain ``nn.Linear``."""
    if isinstance(layer, ColumnParallelDense):
        return copy_to_tp(x, layer.axis())
    return x


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")  # flax's nn.gelu default


class TPMlpBlock(nn.Module):
    """Column-parallel up-projection, activation, row-parallel down: one
    all-reduce per block (the Megatron MLP). Parameters ``up.*`` and
    ``down.*``, as the reference names them."""

    def __init__(self, in_features: int, hidden_features: int, out_features: int,
                 *, tp_axis: str = "tp",
                 activation: Callable[[torch.Tensor], torch.Tensor] = _gelu_tanh,
                 mesh: "Mesh | None" = None, device="cuda", dtype=torch.float32):
        super().__init__()
        kw = dict(tp_axis=tp_axis, mesh=mesh, device=device, dtype=dtype)
        self.up = ColumnParallelDense(in_features, hidden_features, **kw)
        self.down = RowParallelDense(hidden_features, out_features, **kw)
        self.activation = activation

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down(self.activation(self.up(x)))


def split_params(model: nn.Module) -> "dict[str, tuple[str, int, Mesh]]":
    """``{state-dict name: (axis, dim, mesh)}`` for every parameter of
    ``model`` that its layers hold as this rank's slice (of a
    tensor-parallel layer over ``tp``, or an expert stack over ``ep``) of
    ``mesh``; the rest are whole."""
    out: "dict[str, tuple[str, int, Mesh]]" = {}
    for prefix, mod in model.named_modules():
        fn = getattr(mod, "split_params", None)
        if fn is None or getattr(mod, "tp", 1) == 1 and getattr(mod, "ep", 1) == 1:
            continue
        axis = getattr(mod, "tp_axis", None) or getattr(mod, "ep_axis")
        for name, dim in fn().items():
            out[f"{prefix}.{name}" if prefix else name] = (axis, dim, mod.mesh)
    return out
