"""A frozen TF graph rebuilt as torch ops on the card (no TF at run time).

The port of ``sparkdl_tpu/graph/tf2jax.py``. The reference rebuilds a
frozen GraphDef as JAX ops that jit onto the TPU; here a
:class:`~sparkdl_torch.graph.tfgraph.TFGraph` (read from a GraphDef on the
host by graph/reader.py, or written in code) becomes a
:class:`TranslatedGraph`, a callable that walks the nodes with torch ops on
its device. Convolutions and matrix products go to cuDNN and cuBLAS, as
XLA took them in the JAX package; no kernel of the port is involved. This
module imports neither TensorFlow nor protobuf.

There is no fallback: an op or attr outside the surface below raises
:class:`GraphTranslationError` naming the node, the op and the attr, when
the graph is translated or at its first call. The reference's
``call_tf`` path would run the graph in host TF, which hides the card,
and the card's machine has no TF.

Layout: TF graphs are NHWC with HWIO kernels. A convolution or a pooling
runs on the NHWC tensor viewed as NCHW in channels_last memory (a
permute, no copy), and SAME padding that is uneven (TF puts the extra row
and column after) is applied in the graph's own layout before it, so the
layout survives; NCHW graphs run as they are.

Static values: ``Const`` values stay numpy, and ops whose inputs are all
static (``Shape -> StridedSlice -> Pack -> Reshape`` chains) run in numpy,
so shape math never reads the device. Constants that an op takes as a
tensor are put on the device once, when the graph is translated; a value
computed from shapes is put there the first time it takes each value, and
every copy is kept while the graph lives (a CUDA graph captured for one
batch size holds its own copies' addresses). A graph without
``If``/``While`` therefore does no host/device copy and no host read in a
call once it has seen its batch sizes, and a runner can capture it as a
CUDA graph (:attr:`TranslatedGraph.host_sync` is False). ``If``/``While``
read their predicate to the host each time, so such a graph runs eagerly.

``f32_precision``: ``"highest"`` keeps float32 contractions float32
whatever the process's TF32 flags are (cuBLAS and cuDNN alike; the flags
are restored after the call). The flags are the process's own, so while
any "highest" call runs, every other thread's float32 products (the zoo,
a ServingEngine) run without TF32 too, and a CUDA graph captured then
keeps that choice. ``"default"`` gives MatMul, BatchMatMul, Einsum,
Conv2D and DepthwiseConv2dNative bfloat16 operands with float32
accumulation and a float32 result: the card's counterpart of the TPU's
single bf16 pass (the zoo's policy, runtime/dtypes.py).
"""

from __future__ import annotations

import contextlib
import functools
import math
import threading
from typing import Any, Callable, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from sparkdl_torch.graph import utils as tfx
from sparkdl_torch.graph.tfgraph import TFGraph
from sparkdl_torch.ops._dispatch import resolve_device


class GraphTranslationError(ValueError):
    """An op (or attr combination) outside the translation surface."""


PRECISIONS = ("highest", "default")


def check_precision(f32_precision: str) -> None:
    if f32_precision not in PRECISIONS:
        raise ValueError(
            f"f32_precision must be 'highest' or 'default', got {f32_precision!r}")


# --------------------------------------------------------------------------
# attrs, dtypes and static values
# --------------------------------------------------------------------------


def _attr(node, name, default=None):
    return node.attrs.get(name, default)


def _outside(node, what: str) -> GraphTranslationError:
    return GraphTranslationError(
        f"node {node.name!r} ({node.op}): {what} is outside the translation "
        "surface")


def torch_dtype(dt) -> torch.dtype:
    """The torch dtype of a TFGraph dtype value (numpy dtype or torch)."""
    if isinstance(dt, torch.dtype):
        return dt
    if dt is None or np.dtype(dt) == np.dtype(object):
        raise GraphTranslationError(f"unsupported tensor dtype {dt}")
    return torch.from_numpy(np.empty(0, np.dtype(dt))).dtype


def _to_tensor(value, device: torch.device) -> torch.Tensor:
    arr = np.asarray(value)
    if arr.dtype == np.dtype(object):
        raise GraphTranslationError("a string tensor cannot go on the device")
    if arr.dtype.name == "bfloat16":  # ml_dtypes, as TF's make_ndarray gives it
        return torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16).to(device)
    if not arr.flags.c_contiguous:  # (np.ascontiguousarray would make 0-d 1-d)
        arr = arr.copy()
    return torch.from_numpy(arr).to(device)


def _is_static(x) -> bool:
    return isinstance(x, (np.ndarray, np.generic, int, float, bool))


def _static(x, node, what) -> np.ndarray:
    if not _is_static(x):
        raise GraphTranslationError(
            f"node {node.name!r} ({node.op}): {what} must be statically "
            "known (a Const or shape-derived value); a device tensor "
            "cannot drive shapes")
    return np.asarray(x)


# --------------------------------------------------------------------------
# f32 precision: TF32 off for the call, restored after (process flags)
# --------------------------------------------------------------------------

_TF32_LOCK = threading.Lock()
_TF32_DEPTH = [0]
_TF32_SAVED: list = []


@contextlib.contextmanager
def _float32_contractions():
    """TF32 off for cuBLAS and cuDNN while any "highest" call runs in the
    process (a depth count, so overlapping calls from several threads
    keep it off until the last one ends), then the flags as they were."""
    with _TF32_LOCK:
        if _TF32_DEPTH[0] == 0:
            _TF32_SAVED[:] = [torch.backends.cuda.matmul.allow_tf32,
                              torch.backends.cudnn.allow_tf32]
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        _TF32_DEPTH[0] += 1
    try:
        yield
    finally:
        with _TF32_LOCK:
            _TF32_DEPTH[0] -= 1
            if _TF32_DEPTH[0] == 0:
                (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32) = _TF32_SAVED


# --------------------------------------------------------------------------
# the two namespaces of dual-mode ops: numpy (static) and torch (device)
# --------------------------------------------------------------------------


def _index_with_flips(x: torch.Tensor, idx: tuple) -> torch.Tensor:
    """``x[idx]`` for a numpy-style index tuple (ints, slices, None,
    Ellipsis); torch has no negative slice steps, so those dims are
    flipped first and sliced forwards."""
    consumed = sum(1 for i in idx if i is not None and i is not Ellipsis)
    full: list = []
    for i in idx:
        if i is Ellipsis:
            full.extend([slice(None)] * (x.dim() - consumed))
        else:
            full.append(i)
    dim, flips, out = 0, [], []
    for i in full:
        if i is None:
            out.append(None)
            continue
        if isinstance(i, slice) and i.step is not None and i.step < 0:
            n, step = x.shape[dim], -i.step
            picked = range(n)[i]
            flips.append(dim)
            if len(picked) == 0:
                out.append(slice(0, 0))
            else:
                j0 = n - 1 - picked[0]
                out.append(slice(j0, j0 + step * (len(picked) - 1) + 1, step))
        else:
            out.append(i)
        dim += 1
    if flips:
        x = torch.flip(x, flips)
    return x[tuple(out)]


class _Torch:
    """numpy's names over torch, for the dual-mode translators."""

    add = staticmethod(torch.add)
    subtract = staticmethod(torch.sub)
    multiply = staticmethod(torch.mul)
    divide = staticmethod(torch.true_divide)
    maximum = staticmethod(torch.maximum)
    minimum = staticmethod(torch.minimum)
    power = staticmethod(torch.pow)
    square = staticmethod(torch.square)
    greater = staticmethod(torch.gt)
    greater_equal = staticmethod(torch.ge)
    less = staticmethod(torch.lt)
    less_equal = staticmethod(torch.le)
    equal = staticmethod(torch.eq)
    not_equal = staticmethod(torch.ne)
    logical_and = staticmethod(torch.logical_and)
    logical_or = staticmethod(torch.logical_or)
    arctan2 = staticmethod(torch.atan2)
    mod = staticmethod(torch.remainder)  # the divisor's sign, as np.mod and TF FloorMod
    zeros_like = staticmethod(torch.zeros_like)
    ones_like = staticmethod(torch.ones_like)

    @staticmethod
    def floor_divide(a, b):
        return torch.div(a, b, rounding_mode="floor")

    @staticmethod
    def reshape(x, shape):
        return x.reshape(shape)

    @staticmethod
    def squeeze(x, axis=None):
        return x.squeeze() if axis is None else x.squeeze(axis)

    @staticmethod
    def expand_dims(x, axis):
        return x.unsqueeze(axis)

    @staticmethod
    def concatenate(xs, axis):
        return torch.cat(list(xs), dim=axis)

    @staticmethod
    def stack(xs, axis):
        return torch.stack(list(xs), dim=axis)

    @staticmethod
    def unstack(x, axis):
        return tuple(torch.unbind(x, dim=axis))

    @staticmethod
    def transpose(x, perm):
        return x.permute(perm)

    @staticmethod
    def pad(x, pads, value):
        flat = [v for lo_hi in reversed(pads) for v in lo_hi]
        return F.pad(x, flat, value=float(value))

    @staticmethod
    def index(x, idx):
        return _index_with_flips(x, idx)

    @staticmethod
    def take(params, indices, axis):
        idx = indices.long()
        out = params.index_select(axis, idx.reshape(-1))
        return out.reshape(params.shape[:axis] + idx.shape + params.shape[axis + 1:])

    @staticmethod
    def tile(x, reps):
        return x.repeat(reps)

    @staticmethod
    def full(shape, value):
        return value.reshape(()).expand(shape).contiguous()

    @staticmethod
    def broadcast_to(x, shape):
        return x.expand(shape)

    @staticmethod
    def cast(x, dt):
        return x.to(torch_dtype(dt))


class _Numpy:
    """The static side of the dual-mode translators."""

    def __getattr__(self, name):
        return getattr(np, name)

    @staticmethod
    def unstack(x, axis):
        parts = np.split(x, x.shape[axis], axis=axis)
        return tuple(np.squeeze(p, axis=axis) for p in parts)

    @staticmethod
    def pad(x, pads, value):
        return np.pad(x, pads, constant_values=value)

    @staticmethod
    def index(x, idx):
        return np.asarray(x)[idx]

    @staticmethod
    def cast(x, dt):
        return np.asarray(x).astype(dt)


_TORCH, _NUMPY = _Torch(), _Numpy()

# --------------------------------------------------------------------------
# translators: fn(xp, ctx, node, *inputs) -> value | tuple(values)
# xp is numpy for all-static inputs of dual-mode ops, else torch's
# namespace; ctx is the TranslatedGraph (device, precision, caches).
# --------------------------------------------------------------------------

_TRANSLATORS: dict[str, Callable] = {}
_DUAL_MODE: set[str] = set()
#: argument positions that stay numpy (must be static) in torch mode
_STATIC_ARGS: dict[str, tuple] = {}


def _op(name, dual: bool = False, static: tuple = ()):
    def wrap(fn):
        _TRANSLATORS[name] = fn
        if dual:
            _DUAL_MODE.add(name)
        if static:
            _STATIC_ARGS[name] = static
        return fn

    return wrap


def _register():
    # -- passthrough -----------------------------------------------------
    for op in ("Identity", "StopGradient", "Snapshot", "PreventGradient",
               "CheckNumerics", "EnsureShape", "PlaceholderWithDefault"):
        _op(op, dual=True)(lambda xp, ctx, node, x, *rest: x)

    # -- unary elementwise ----------------------------------------------
    unary = {
        "Relu": torch.relu,
        "Relu6": lambda x: torch.clamp(x, 0, 6),
        "Elu": F.elu, "Selu": F.selu, "Sigmoid": torch.sigmoid,
        "Tanh": torch.tanh, "Softplus": F.softplus, "Softsign": F.softsign,
        "Exp": torch.exp, "Log": torch.log, "Log1p": torch.log1p,
        "Sqrt": torch.sqrt, "Rsqrt": torch.rsqrt, "Square": torch.square,
        "Neg": torch.neg, "Abs": torch.abs, "Sign": torch.sign,
        "Floor": torch.floor, "Ceil": torch.ceil,
        "Round": torch.round, "Rint": torch.round,  # both half to even, as TF
        "Erf": torch.erf, "Reciprocal": torch.reciprocal,
        "LogicalNot": torch.logical_not,
        "Sin": torch.sin, "Cos": torch.cos, "Tan": torch.tan,
        "Asin": torch.asin, "Acos": torch.acos, "Atan": torch.atan,
        "Sinh": torch.sinh, "Cosh": torch.cosh, "Expm1": torch.expm1,
        "IsFinite": torch.isfinite, "IsNan": torch.isnan, "IsInf": torch.isinf,
    }
    for op, fn in unary.items():
        _op(op)(lambda xp, ctx, node, x, _fn=fn: _fn(x))

    _op("LeakyRelu")(
        lambda xp, ctx, node, x: F.leaky_relu(x, _attr(node, "alpha", 0.2)))
    _op("Softmax")(lambda xp, ctx, node, x: torch.softmax(x, dim=-1))
    _op("LogSoftmax")(lambda xp, ctx, node, x: torch.log_softmax(x, dim=-1))

    # -- binary elementwise (numpy-compatible broadcasting) --------------
    binary = {
        "Add": "add", "AddV2": "add", "Sub": "subtract", "Mul": "multiply",
        "Div": "divide", "RealDiv": "divide", "FloorDiv": "floor_divide",
        "FloorMod": "mod", "Maximum": "maximum", "Minimum": "minimum",
        "Pow": "power", "Greater": "greater", "GreaterEqual": "greater_equal",
        "Less": "less", "LessEqual": "less_equal", "Equal": "equal",
        "NotEqual": "not_equal", "LogicalAnd": "logical_and",
        "LogicalOr": "logical_or", "Atan2": "arctan2",
    }
    for op, name in binary.items():
        _op(op, dual=True)(
            lambda xp, ctx, node, a, b, _n=name: getattr(xp, _n)(a, b))
    _op("SquaredDifference", dual=True)(
        lambda xp, ctx, node, a, b: xp.square(xp.subtract(a, b)))
    _op("AddN", dual=True)(
        lambda xp, ctx, node, *xs: functools.reduce(xp.add, xs))

    def _cumulative(node, x, axis, cum_fn, init):
        """TF cumsum/cumprod semantics incl. exclusive/reverse attrs:
        reverse accumulates from the end (flip, scan, flip back);
        exclusive shifts the inclusive scan one step, seeded with the
        identity element, in the flipped orientation ([b+c, c, 0])."""
        exclusive = _attr(node, "exclusive", False)
        reverse = _attr(node, "reverse", False)
        if reverse:
            x = torch.flip(x, (axis,))
        out = cum_fn(x, dim=axis, dtype=x.dtype)  # torch widens ints to int64
        if exclusive:
            seed = torch.full_like(out.narrow(axis, 0, 1), init)
            out = torch.cat([seed, out.narrow(axis, 0, x.shape[axis] - 1)], dim=axis)
        if reverse:
            out = torch.flip(out, (axis,))
        return out

    @_op("Cumsum", static=(1,))
    def _cumsum(xp, ctx, node, x, axis):
        return _cumulative(node, x, int(_static(axis, node, "axis")), torch.cumsum, 0)

    @_op("Cumprod", static=(1,))
    def _cumprod(xp, ctx, node, x, axis):
        return _cumulative(node, x, int(_static(axis, node, "axis")), torch.cumprod, 1)

    @_op("OneHot", static=(1,))
    def _onehot(xp, ctx, node, indices, depth, on_value, off_value):
        depth = int(_static(depth, node, "depth"))
        axis = _attr(node, "axis", -1)
        # a comparison, not F.one_hot: out-of-range indices give all-off
        # rows, as in TF; where(), not arithmetic: exact for every dtype
        hot = indices.long().unsqueeze(-1) == torch.arange(depth, device=indices.device)
        if axis != -1:
            hot = torch.movedim(hot, -1, axis)
        return torch.where(hot, on_value, off_value)

    @_op("TopKV2", static=(1,))
    def _topk(xp, ctx, node, x, k):
        values, indices = torch.topk(x, int(_static(k, node, "k")), dim=-1)
        return values, indices.to(torch.int32)

    @_op("Select")
    def _select_v1(xp, ctx, node, c, a, b):
        # TF Select (v1) broadcasts a rank-1 condition along the LEADING
        # axis of higher-rank operands; torch broadcasts trailing axes,
        # so reshape cond to (-1, 1, ..., 1) for that case.
        nd = max(a.dim(), b.dim())
        if c.dim() == 1 and nd > 1:
            c = c.reshape((-1,) + (1,) * (nd - 1))
        return torch.where(c, a, b)

    _op("SelectV2")(lambda xp, ctx, node, c, a, b: torch.where(c, a, b))
    _op("ClipByValue")(
        lambda xp, ctx, node, x, lo, hi: torch.minimum(torch.maximum(x, lo), hi))

    # -- casts -----------------------------------------------------------
    @_op("Cast", dual=True)
    def _cast(xp, ctx, node, x):
        dt = _attr(node, "DstT")
        if xp is _NUMPY and isinstance(dt, torch.dtype):  # numpy has no bfloat16
            return _to_tensor(x, ctx.device).to(dt)
        return xp.cast(x, dt)  # float -> int truncates toward zero, as TF

    # -- contractions ------------------------------------------------------
    @_op("MatMul")
    def _matmul(xp, ctx, node, a, b):
        if _attr(node, "transpose_a", False):
            a = a.mT
        if _attr(node, "transpose_b", False):
            b = b.mT
        return ctx.contract(torch.matmul, a, b)

    for op in ("BatchMatMul", "BatchMatMulV2", "BatchMatMulV3"):
        @_op(op)
        def _bmm(xp, ctx, node, a, b):
            if _attr(node, "adj_x", False):
                a = a.mT
            if _attr(node, "adj_y", False):
                b = b.mT
            return ctx.contract(torch.matmul, a, b)

    @_op("Einsum")
    def _einsum(xp, ctx, node, *xs):
        eq = _attr(node, "equation")
        return ctx.contract(lambda *ops: torch.einsum(eq, *ops), *xs)

    # -- conv / bn / bias ------------------------------------------------
    @_op("Conv2D")
    def _conv2d(xp, ctx, node, x, kernel):
        return _conv(ctx, node, x, kernel, depthwise=False)

    @_op("DepthwiseConv2dNative")
    def _dwconv(xp, ctx, node, x, kernel):
        return _conv(ctx, node, x, kernel, depthwise=True)

    for op in ("FusedBatchNorm", "FusedBatchNormV2", "FusedBatchNormV3"):
        @_op(op)
        def _fbn(xp, ctx, node, x, scale, offset, mean, var):
            if _attr(node, "is_training", True):
                raise GraphTranslationError(
                    f"node {node.name!r} ({node.op}): is_training=True — "
                    "freeze the graph for inference first")
            eps = _attr(node, "epsilon", 1e-3)
            nchw = _layout(node) == "NCHW"

            def fold(scale, offset, mean, var):
                inv = torch.rsqrt(var + eps) * scale
                shift = offset - mean * inv
                if nchw:
                    return inv.reshape(-1, 1, 1), shift.reshape(-1, 1, 1)
                return inv, shift

            inv, shift = ctx.derived((scale, offset, mean, var), ("bn", eps, nchw), fold)
            return x * inv + shift

    @_op("BiasAdd")
    def _bias(xp, ctx, node, x, b):
        if _layout(node) == "NCHW":
            return x + b.reshape(1, -1, *([1] * (x.dim() - 2)))
        return x + b

    # -- pooling ---------------------------------------------------------
    _op("MaxPool")(lambda xp, ctx, node, x: _pool(ctx, node, x, "max"))
    _op("AvgPool")(lambda xp, ctx, node, x: _pool(ctx, node, x, "avg"))

    # -- reductions ------------------------------------------------------
    def _over_dims(fn):
        """A one-dim reduction applied over several dims, last first."""
        def reduce(x, dims, keepdim):
            for d in sorted((d % x.dim() for d in dims), reverse=True):
                x = fn(x, dim=d, keepdim=keepdim)
            return x
        return reduce

    reductions = {
        "Mean": lambda x, dims, keepdim: x.mean(dim=dims, keepdim=keepdim),
        "Sum": lambda x, dims, keepdim: x.sum(dim=dims, keepdim=keepdim, dtype=x.dtype),
        "Max": lambda x, dims, keepdim: x.amax(dim=dims, keepdim=keepdim),
        "Min": lambda x, dims, keepdim: x.amin(dim=dims, keepdim=keepdim),
        "Prod": _over_dims(lambda x, dim, keepdim: torch.prod(x, dim, keepdim, dtype=x.dtype)),
        "All": _over_dims(torch.all),
        "Any": _over_dims(torch.any),
    }
    for op, fn in reductions.items():
        @_op(op, static=(1,))
        def _reduce(xp, ctx, node, x, axes, _fn=fn):
            axes = _static(axes, node, "reduction axes")
            # axis=() is a no-op reduction in TF (identity): do NOT
            # collapse an empty list to "all axes"
            dims = tuple(int(a) for a in np.atleast_1d(axes))
            if not dims:
                return x
            return _fn(x, dims, bool(_attr(node, "keep_dims", False)))

    for op, fn in (("ArgMax", torch.argmax), ("ArgMin", torch.argmin)):
        @_op(op, static=(1,))
        def _arg(xp, ctx, node, x, axis, _fn=fn):
            axis = int(_static(axis, node, "axis"))
            # the first of equal values, as TF; the dtype from the attr
            return _fn(x, dim=axis).to(torch_dtype(_attr(node, "output_type", np.int64)))

    # -- shape surgery ---------------------------------------------------
    @_op("Shape", dual=True)
    def _shape(xp, ctx, node, x):
        return np.asarray(tuple(np.shape(x)), _attr(node, "out_type", np.int32))

    @_op("Rank", dual=True)
    def _rank(xp, ctx, node, x):
        return np.asarray(len(np.shape(x)), np.int32)

    @_op("Size", dual=True)
    def _size(xp, ctx, node, x):
        return np.asarray(math.prod(np.shape(x)), _attr(node, "out_type", np.int32))

    @_op("Reshape", dual=True, static=(1,))
    def _reshape(xp, ctx, node, x, shape):
        shape = _static(shape, node, "shape")
        return xp.reshape(x, tuple(int(s) for s in shape))

    @_op("Squeeze", dual=True)
    def _squeeze(xp, ctx, node, x):
        dims = _attr(node, "squeeze_dims") or _attr(node, "axis")
        return xp.squeeze(x, axis=tuple(dims) if dims else None)

    @_op("ExpandDims", dual=True, static=(1,))
    def _expand(xp, ctx, node, x, axis):
        return xp.expand_dims(x, int(_static(axis, node, "axis")))

    @_op("ConcatV2", dual=True, static=(-1,))
    def _concat(xp, ctx, node, *xs):
        return xp.concatenate(xs[:-1], axis=int(_static(xs[-1], node, "concat axis")))

    @_op("Concat", dual=True, static=(0,))
    def _concat_v1(xp, ctx, node, axis, *xs):
        return xp.concatenate(xs, axis=int(_static(axis, node, "axis")))

    @_op("Pack", dual=True)
    def _pack(xp, ctx, node, *xs):
        return xp.stack(xs, axis=_attr(node, "axis", 0))

    @_op("Unpack", dual=True)
    def _unpack(xp, ctx, node, x):
        return xp.unstack(x, _attr(node, "axis", 0))

    @_op("Split", static=(0,))
    def _split(xp, ctx, node, axis, x):
        axis = int(_static(axis, node, "axis"))
        n = _attr(node, "num_split")
        return tuple(torch.split(x, x.shape[axis] // n, dim=axis))

    @_op("SplitV", static=(1, 2))
    def _splitv(xp, ctx, node, x, sizes, axis):
        sizes = [int(s) for s in _static(sizes, node, "split sizes")]
        axis = int(_static(axis, node, "axis"))
        if -1 in sizes:  # one size may be inferred
            sizes[sizes.index(-1)] = x.shape[axis] - (sum(sizes) + 1)
        return tuple(torch.split(x, sizes, dim=axis))

    @_op("Transpose", dual=True, static=(1,))
    def _transpose(xp, ctx, node, x, perm):
        return xp.transpose(x, tuple(int(p) for p in _static(perm, node, "perm")))

    for op in ("Pad", "PadV2"):
        @_op(op, dual=True, static=(1, 2))
        def _pad(xp, ctx, node, x, pads, *rest):
            pads = _static(pads, node, "paddings")
            value = _static(rest[0], node, "pad value")[()] if rest else 0
            return xp.pad(x, [(int(a), int(b)) for a, b in pads], value)

    @_op("Slice", dual=True, static=(1, 2))
    def _slice(xp, ctx, node, x, begin, size):
        begin = _static(begin, node, "begin")
        size = _static(size, node, "size")
        idx = tuple(
            slice(int(b), None if int(s) == -1 else int(b) + int(s))
            for b, s in zip(begin, size))
        return xp.index(x, idx)

    @_op("StridedSlice", dual=True, static=(1, 2, 3))
    def _strided(xp, ctx, node, x, begin, end, strides):
        begin = _static(begin, node, "begin")
        end = _static(end, node, "end")
        strides = _static(strides, node, "strides")
        bm = _attr(node, "begin_mask", 0)
        em = _attr(node, "end_mask", 0)
        ell = _attr(node, "ellipsis_mask", 0)
        na = _attr(node, "new_axis_mask", 0)
        sa = _attr(node, "shrink_axis_mask", 0)
        # The sparse spec maps 1:1 onto a numpy index tuple: mask bit i
        # selects how position i of the spec is interpreted; begin/end/
        # strides values at ellipsis/new-axis positions are ignored (TF
        # ignores them too).
        idx = []
        for i in range(len(begin)):
            if ell & (1 << i):
                idx.append(Ellipsis)
            elif na & (1 << i):
                idx.append(None)
            elif sa & (1 << i):
                idx.append(int(begin[i]))
            else:
                b = None if bm & (1 << i) else int(begin[i])
                e = None if em & (1 << i) else int(end[i])
                idx.append(slice(b, e, int(strides[i])))
        return xp.index(x, tuple(idx))

    @_op("GatherV2", dual=True, static=(2,))
    def _gather(xp, ctx, node, params, indices, axis):
        axis = int(_static(axis, node, "axis"))
        bd = int(_attr(node, "batch_dims", 0))
        if bd < 0:
            bd += np.ndim(indices)
        if axis < 0:
            axis += np.ndim(params)
        if bd == 0:
            return xp.take(params, indices, axis=axis)
        if xp is _NUMPY:  # static gathers in shape math are tiny: a loop
            def bd_gather(p, i, a, b):
                if b == 0:
                    return np.take(p, i, axis=a)
                return np.stack([bd_gather(pp, ii, a - 1, b - 1) for pp, ii in zip(p, i)])
            return bd_gather(np.asarray(params), np.asarray(indices), axis, bd)
        return _batched_gather(params, indices.long(), axis, bd)

    @_op("Tile", dual=True, static=(1,))
    def _tile(xp, ctx, node, x, multiples):
        return xp.tile(x, tuple(int(m) for m in _static(multiples, node, "multiples")))

    @_op("Fill", dual=True, static=(0,))
    def _fill(xp, ctx, node, dims, value):
        return xp.full(tuple(int(d) for d in _static(dims, node, "dims")), value)

    @_op("Range", dual=True, static=(0, 1, 2))
    def _range(xp, ctx, node, start, limit, delta):
        # dtypes follow the operands (float ranges stay float, like TF)
        return np.arange(_static(start, node, "start")[()],
                         _static(limit, node, "limit")[()],
                         _static(delta, node, "delta")[()])

    _op("ZerosLike", dual=True)(lambda xp, ctx, node, x: xp.zeros_like(x))
    _op("OnesLike", dual=True)(lambda xp, ctx, node, x: xp.ones_like(x))

    @_op("BroadcastTo", dual=True, static=(1,))
    def _broadcast_to(xp, ctx, node, x, shape):
        return xp.broadcast_to(x, tuple(int(s) for s in _static(shape, node, "shape")))

    # -- functional control flow: the predicate is read to the host ------
    for op in ("If", "StatelessIf"):
        @_op(op)
        def _if(xp, ctx, node, cond, *args):
            branch = "then_branch" if _truth(cond) else "else_branch"
            return _one_or_tuple(ctx.function(node, _attr(node, branch))(*args))

    for op in ("While", "StatelessWhile"):
        @_op(op)
        def _while(xp, ctx, node, *args):
            cond_fn = ctx.function(node, _attr(node, "cond"))
            body_fn = ctx.function(node, _attr(node, "body"))
            carry = tuple(args)
            while _truth(cond_fn(*carry)[0]):
                carry = tuple(body_fn(*carry))
            return _one_or_tuple(carry)

    # -- image resize (the reference's in-graph decode/resize, 2.10) -----
    @_op("ResizeBilinear", static=(1,))
    def _resize_bilinear(xp, ctx, node, x, size):
        h, w = _resize_size(node, size)
        xf = x.float()
        if _attr(node, "half_pixel_centers", False):
            out = F.interpolate(xf.permute(0, 3, 1, 2), size=(h, w), mode="bilinear",
                                align_corners=False, antialias=False)
            return out.permute(0, 2, 3, 1)
        # TF1 legacy convention (the default in frozen TF1 graphs): src =
        # dst * (in/out), no half-pixel shift; interpolate explicitly
        y0, y1, wy, x0, x1, wx = ctx.cached(
            ("legacy_bilinear", h, w, x.shape[1], x.shape[2]),
            lambda: _legacy_weights(h, w, x.shape[1], x.shape[2], x.device))
        top, bot = xf.index_select(1, y0), xf.index_select(1, y1)
        rows = top + (bot - top) * wy
        left, right = rows.index_select(2, x0), rows.index_select(2, x1)
        return left + (right - left) * wx

    @_op("ResizeNearestNeighbor", static=(1,))
    def _resize_nn(xp, ctx, node, x, size):
        if not _attr(node, "half_pixel_centers", False):
            raise _outside(node, "half_pixel_centers=False (legacy nearest)")
        h, w = _resize_size(node, size)
        out = F.interpolate(x.float().permute(0, 3, 1, 2), size=(h, w),
                            mode="nearest-exact")
        return out.permute(0, 2, 3, 1).to(x.dtype)


def _truth(value) -> bool:
    """A predicate's value on the host (a device read for a tensor)."""
    if isinstance(value, torch.Tensor):
        return bool(value.reshape(()).item())
    return bool(np.asarray(value).reshape(()))


def _one_or_tuple(out):
    out = tuple(out)
    return out if len(out) > 1 else out[0]


def _resize_size(node, size) -> tuple[int, int]:
    if _attr(node, "align_corners", False):
        raise _outside(node, "align_corners=True")
    size = _static(size, node, "size")
    return int(size[0]), int(size[1])


def _legacy_weights(h, w, in_h, in_w, device):
    def axis_weights(out_n, in_n):
        src = np.arange(out_n, dtype=np.float64) * (in_n / out_n)
        lo = np.clip(np.floor(src).astype(np.int64), 0, in_n - 1)
        hi = np.minimum(lo + 1, in_n - 1)
        frac = (src - lo).astype(np.float32)
        return lo, hi, frac

    y0, y1, wy = axis_weights(h, in_h)
    x0, x1, wx = axis_weights(w, in_w)
    t = functools.partial(_to_tensor, device=device)
    return (t(y0), t(y1), t(wy[None, :, None, None]),
            t(x0), t(x1), t(wx[None, None, :, None]))


def _batched_gather(params, indices, axis, bd):
    """GatherV2 with ``bd`` leading batch dims: one index_select over the
    batch-flattened params, each batch's indices offset into its block."""
    batch = params.shape[:bd]
    n = math.prod(batch)
    p = params.reshape((n,) + params.shape[bd:])
    i = indices.reshape((n,) + indices.shape[bd:])
    k_dim = 1 + axis - bd
    k = p.shape[k_dim]
    p = torch.movedim(p, k_dim, 1)                 # [N, K, A..., C...]
    rest = p.shape[2:]
    offsets = (torch.arange(n, device=i.device) * k).reshape((n,) + (1,) * (i.dim() - 1))
    flat = p.reshape((n * k,) + rest).index_select(0, (i + offsets).reshape(-1))
    n_i, n_a = i.dim() - 1, axis - bd
    out = flat.reshape((n,) + i.shape[1:] + rest)  # [N, I..., A..., C...]
    perm = ([0] + list(range(1 + n_i, 1 + n_i + n_a)) + list(range(1, 1 + n_i))
            + list(range(1 + n_i + n_a, out.dim())))
    out = out.permute(perm)
    return out.reshape(tuple(batch) + tuple(out.shape[1:]))


def _layout(node) -> str:
    fmt = _attr(node, "data_format", "NHWC")
    if fmt not in ("NHWC", "NCHW"):
        raise _outside(node, f"data_format={fmt!r}")
    return fmt


def _same_pad(n: int, k: int, s: int, d: int = 1) -> tuple[int, int]:
    """TF SAME padding of one spatial dim: the extra cell goes after."""
    out = -(-n // s)
    total = max((out - 1) * s + (k - 1) * d + 1 - n, 0)
    return total // 2, total - total // 2


def _spatial(node, name: str, fmt: str, default) -> tuple[int, int]:
    """An NHWC/NCHW 4-vector attr's (h, w); its N and C entries must be 1."""
    v = _attr(node, name, default)
    hw, nc = ((2, 3), (0, 1)) if fmt == "NCHW" else ((1, 2), (0, 3))
    if len(v) != 4 or any(v[i] != 1 for i in nc):
        raise _outside(node, f"{name}={v} (batch or channel entries other than 1)")
    return int(v[hw[0]]), int(v[hw[1]])


def _pad_in_layout(x, fmt, top, bottom, left, right, value=0.0):
    """Pad H and W of an NHWC or NCHW tensor in its own layout."""
    if fmt == "NCHW":
        return F.pad(x, (left, right, top, bottom), value=value)
    return F.pad(x, (0, 0, left, right, top, bottom), value=value)


def _conv(ctx, node, x, kernel, depthwise: bool):
    fmt = _layout(node)
    nchw = fmt == "NCHW"
    stride = _spatial(node, "strides", fmt, [1, 1, 1, 1])
    dil = _spatial(node, "dilations", fmt, [1, 1, 1, 1])
    kh, kw = kernel.shape[0], kernel.shape[1]
    h, w = (x.shape[2], x.shape[3]) if nchw else (x.shape[1], x.shape[2])
    padding = _attr(node, "padding", "VALID")
    if padding == "SAME":
        (top, bottom), (left, right) = (_same_pad(h, kh, stride[0], dil[0]),
                                        _same_pad(w, kw, stride[1], dil[1]))
    elif padding == "VALID":
        top = bottom = left = right = 0
    elif padding == "EXPLICIT":
        ep = _attr(node, "explicit_paddings", [])
        # explicit_paddings follows the data_format's dim order
        top, bottom, left, right = ep[4:8] if nchw else ep[2:6]
    else:
        raise _outside(node, f"padding={padding!r}")
    channels = x.shape[1] if nchw else x.shape[3]
    if depthwise:  # [H, W, C, M] -> [C*M, 1, H, W]: output c*M + m, as TF
        groups = channels
        weight = ctx.derived((kernel,), ("dw", nchw), lambda k: _memory(
            k.reshape(kh, kw, -1).permute(2, 0, 1).unsqueeze(1), nchw))
    else:  # HWIO -> OIHW; a kernel of fewer input channels is a grouped conv
        groups = channels // kernel.shape[2]
        weight = ctx.derived((kernel,), ("conv", nchw),
                             lambda k: _memory(k.permute(3, 2, 0, 1), nchw))
    if top == bottom and left == right:
        pad = (top, left)
    else:
        x, pad = _pad_in_layout(x, fmt, top, bottom, left, right), (0, 0)
    xin = x if nchw else x.permute(0, 3, 1, 2)
    y = ctx.contract(
        lambda a, b: F.conv2d(a, b, None, stride, pad, dil, groups), xin, weight)
    return y if nchw else y.permute(0, 2, 3, 1)


def _memory(w: torch.Tensor, nchw: bool) -> torch.Tensor:
    """A conv weight laid out for its input: channels_last for NHWC graphs
    (their inputs are channels_last views), contiguous for NCHW ones."""
    if nchw:
        return w.contiguous()
    return w.contiguous(memory_format=torch.channels_last)


def _pool(ctx, node, x, kind: str):
    fmt = _layout(node)
    nchw = fmt == "NCHW"
    kernel = _spatial(node, "ksize", fmt, [1, 1, 1, 1])
    stride = _spatial(node, "strides", fmt, [1, 1, 1, 1])
    padding = _attr(node, "padding", "VALID")
    h, w = (x.shape[2], x.shape[3]) if nchw else (x.shape[1], x.shape[2])
    if padding == "SAME":
        (top, bottom), (left, right) = (_same_pad(h, kernel[0], stride[0]),
                                        _same_pad(w, kernel[1], stride[1]))
    elif padding == "VALID":
        top = bottom = left = right = 0
    else:
        raise _outside(node, f"padding={padding!r}")
    pads = (top, bottom, left, right)
    view = (lambda t: t) if nchw else (lambda t: t.permute(0, 3, 1, 2))
    back = (lambda t: t) if nchw else (lambda t: t.permute(0, 2, 3, 1))
    if kind == "max":
        if any(pads):  # -inf: a pad cell never wins
            fill = (float("-inf") if x.is_floating_point()
                    else torch.iinfo(x.dtype).min)
            x = _pad_in_layout(x, fmt, *pads, value=fill)
        return back(F.max_pool2d(view(x), kernel, stride))
    if not any(pads):
        return back(F.avg_pool2d(view(x), kernel, stride))
    # TF divides by the count of real cells in each window
    sums = F.avg_pool2d(view(_pad_in_layout(x, fmt, *pads)), kernel, stride,
                        divisor_override=1)
    counts = ctx.cached(("avg_count", h, w, kernel, stride, pads, x.dtype, x.device),
                        lambda: F.avg_pool2d(
                            F.pad(torch.ones((1, 1, h, w), dtype=x.dtype, device=x.device),
                                  (left, right, top, bottom)),
                            kernel, stride, divisor_override=1))
    return back(sums / counts)


_register()


# --------------------------------------------------------------------------
# graph walking
# --------------------------------------------------------------------------

_STRUCTURAL = frozenset({"Const", "Placeholder", "NoOp"})


def _as_tf_graph(graph, output_names) -> TFGraph:
    if isinstance(graph, TFGraph):
        return graph
    from sparkdl_torch.graph.reader import read_graph_def

    return read_graph_def(graph, output_names)


def _untranslatable(graph: TFGraph, output_names) -> list:
    """(where, op) of every reachable node outside the surface, library
    bodies included (If/While branches can hide an op too)."""
    missing, seen = [], set()

    def scan(g, nodes, where):
        for n in nodes:
            if n.op not in _STRUCTURAL and n.op not in _TRANSLATORS:
                missing.append((where + n.name, n.op))
        for fname in g.referenced_functions(nodes):
            fn = g.library[fname]
            if id(fn) not in seen:
                seen.add(id(fn))
                scan(fn.graph, fn.graph.nodes, f"{where}{fname}/")

    scan(graph, graph.reachable(output_names), "")
    return missing


def untranslatable_ops(graph, output_names=None) -> "list[str]":
    """Ops that the translator does NOT cover (empty list == fully
    translatable). Const/Placeholder/NoOp are structural and always fine.
    With ``output_names``, only the output-feeding subgraph is scanned, so
    unpruned graphs carrying dead nodes still translate. ``graph`` is a
    TFGraph or a GraphDef (read first, which needs TF; call sites are
    inlined there, so an op hiding inside a tf.function surfaces here)."""
    graph = _as_tf_graph(graph, output_names)
    return sorted({op for _, op in _untranslatable(graph, output_names)})


class TranslatedGraph:
    """``f(*inputs) -> tuple(tensors)``: the graph as torch ops on
    :attr:`device`, inputs and outputs in the given tensor-name order.

    Inputs may be tensors on the device or numpy arrays (copied there).
    :attr:`host_sync` is True when the graph holds ``If``/``While`` (each
    call reads their predicates to the host, so it cannot be captured as a
    CUDA graph); the transformers then run it eagerly.
    """

    def __init__(self, graph: TFGraph, input_names: Sequence[str],
                 output_names: Sequence[str], device, f32_precision: str):
        check_precision(f32_precision)
        self.graph = graph
        self.device = resolve_device(device)
        self.f32_precision = f32_precision
        missing = _untranslatable(graph, output_names)
        if missing:
            raise GraphTranslationError(
                "graph has ops outside the translation surface: "
                + ", ".join(f"node {w!r} ({op})" for w, op in missing))
        self._in_ops = [tfx.op_name(graph.resolve(n)) for n in input_names]
        outs = [graph.resolve(o) for o in output_names]
        self._out_refs = [(tfx.op_name(o), tfx.output_index(o)) for o in outs]
        roots = [name for name, _ in self._out_refs]
        nodes = graph.reachable(roots)
        for name in self._in_ops + roots:
            if name not in graph.by_name:
                raise GraphTranslationError(f"missing node {name!r}")
        self._order = [n for n in nodes if n.name not in self._in_ops]
        # nodes whose value is a constant: Consts, and dual-mode ops over
        # constants only (numpy runs them); their device copies are made
        # once and never compared again
        self._consts = {n.name for n in nodes if n.op == "Const"}
        self._const_refs = set(self._consts)
        for n in self._order:
            if n.op in _DUAL_MODE and all(
                    tfx.op_name(i) in self._const_refs for i in n.inputs):
                self._const_refs.add(n.name)
        # every device tensor this graph makes for itself (constants,
        # values derived from them or from shapes); see cached()
        self._cache: dict = {}
        self._subs: dict = {}
        self._static_pos = {
            n.name: {p if p >= 0 else p + len(n.inputs) for p in _STATIC_ARGS.get(n.op, ())}
            for n in self._order}
        self.host_sync = False
        for n in self._order:
            if n.op in ("If", "StatelessIf", "While", "StatelessWhile"):
                self.host_sync = True
                for key in ("then_branch", "else_branch", "cond", "body"):
                    if key in n.attrs:
                        self.function(n, n.attrs[key])
        self._upload_constants()

    def _upload_constants(self) -> None:
        """Put every Const that some op takes as a tensor on the device
        now (those only shape math reads stay numpy)."""
        for n in self._order:
            if n.name in self._const_refs:
                continue
            for pos, ref in enumerate(n.inputs):
                if tfx.op_name(ref) in self._consts and pos not in self._static_pos[n.name]:
                    value = self.graph.by_name[tfx.op_name(ref)].attrs["value"]
                    if value is not None and value.dtype != np.dtype(object):
                        self._device_value(value, tfx.tensor_name(ref))

    # -- what the translators call ---------------------------------------
    def function(self, node, fname: str) -> "TranslatedGraph":
        """The translated library function ``fname`` (If/While bodies)."""
        sub = self._subs.get(fname)
        if sub is None:
            fn = self.graph.library.get(fname)
            if fn is None:
                raise GraphTranslationError(
                    f"node {node.name!r} ({node.op}): function {fname!r} is "
                    "not in the graph's function library")
            sub = TranslatedGraph(fn.graph, fn.inputs, fn.outputs, self.device,
                                  self.f32_precision)
            self._subs[fname] = sub
        return sub

    def contract(self, fn, *operands):
        """A matrix product or convolution at this graph's f32 precision:
        "default" casts float32 operands to bfloat16 (constants once) and
        returns float32."""
        if self.f32_precision == "highest" or not all(
                t.dtype == torch.float32 for t in operands):
            return fn(*operands)
        low = [self.derived((t,), "bf16", lambda t: t.to(torch.bfloat16)) for t in operands]
        return fn(*low).float()

    def cached(self, key, fn):
        """``fn()``, computed once per ``key`` and kept while the graph
        lives: a CUDA graph captured over this graph holds the addresses
        of these tensors, so none is ever dropped or replaced. Tensors
        made here count as constants for :meth:`derived`."""
        out = self._cache.get(key)
        if out is None:
            out = self._cache[key] = fn()
            for t in (out if isinstance(out, tuple) else (out,)):
                if isinstance(t, torch.Tensor):
                    self._cache[("const", id(t))] = t  # (holds t, so its id stays its own)
        return out

    def derived(self, tensors: tuple, tag, fn):
        """``fn(*tensors)``, computed once when every tensor is one that
        :meth:`cached` keeps (a weight's layout, bf16 copy, BN fold)."""
        if not all(("const", id(t)) in self._cache for t in tensors):
            return fn(*tensors)
        return self.cached((tag,) + tuple(id(t) for t in tensors), lambda: fn(*tensors))

    def _device_value(self, value, ref: str) -> torch.Tensor:
        """The device copy of a static value: a Const's (or a value folded
        from Consts only) keyed by its tensor name, a value computed from
        shapes by its name and bytes, so each value it takes keeps its own
        copy."""
        arr = np.asarray(value)
        key = ("value", ref)
        if tfx.op_name(ref) not in self._const_refs:
            key += (arr.dtype.str, arr.shape, arr.tobytes())
        return self.cached(key, lambda: _to_tensor(arr, self.device))

    def _input(self, value) -> torch.Tensor:
        if isinstance(value, torch.Tensor):
            if value.device.type != self.device.type or (
                    self.device.index is not None and value.device.index != self.device.index):
                raise ValueError(
                    f"input on {value.device}, but the graph runs on {self.device}")
            return value
        return _to_tensor(value, self.device)

    # -- running -----------------------------------------------------------
    def __call__(self, *inputs) -> tuple:
        if len(inputs) != len(self._in_ops):
            raise TypeError(f"expected {len(self._in_ops)} inputs, got {len(inputs)}")
        if self.f32_precision == "highest":
            with _float32_contractions():
                return self._run(inputs)
        return self._run(inputs)

    def _run(self, inputs) -> tuple:
        env: dict[str, Any] = {name: (self._input(v),) for name, v in zip(self._in_ops, inputs)}
        for node in self._order:
            name = node.name
            if node.op == "Const":
                env[name] = (node.attrs["value"],)
                continue
            if node.op == "Placeholder":
                raise GraphTranslationError(f"placeholder {name!r} is not in input_names")
            if node.op == "NoOp":
                env[name] = ()
                continue
            ins = [env[tfx.op_name(i)][tfx.output_index(i)] for i in node.inputs]
            translator = _TRANSLATORS[node.op]
            try:
                if node.op in _DUAL_MODE and all(_is_static(i) for i in ins):
                    out = translator(_NUMPY, self, node, *ins)
                else:
                    keep = self._static_pos[name]
                    ins = [x if k in keep or not _is_static(x)
                           else self._device_value(x, tfx.tensor_name(node.inputs[k]))
                           for k, x in enumerate(ins)]
                    out = translator(_TORCH, self, node, *ins)
            except GraphTranslationError:
                raise
            except Exception as e:
                e.add_note(f"while running node {name!r} ({node.op}) of a "
                           "translated TF graph")
                raise
            env[name] = out if isinstance(out, tuple) else (out,)
        outs = []
        for name, idx in self._out_refs:
            v = env[name][idx]
            outs.append(self._device_value(v, f"{name}:{idx}") if _is_static(v) else v)
        return tuple(outs)


def translate_graph(graph, input_names: Sequence[str], output_names: Sequence[str],
                    device="cuda", f32_precision: str = "highest") -> TranslatedGraph:
    """The graph (a :class:`TFGraph`, or a GraphDef, read on the host
    first) as a :class:`TranslatedGraph` on ``device`` (``cuda`` unless
    the caller passes ``device="cpu"``; ``cuda`` raises without CUDA)."""
    check_precision(f32_precision)
    return TranslatedGraph(_as_tf_graph(graph, output_names), input_names,
                           output_names, device, f32_precision)


#: the reference's name; it takes a TFGraph as well
translate_graph_def = translate_graph
