"""The fused 1x1-conv GEMM with BatchNorm-training epilogues, as one
hand-written CUDA kernel.

An NHWC 1x1 convolution is the GEMM ``[B·H·W, Cin] @ [Cin, Cout]``.
:func:`gemm_bn_stats` computes ``y = act(scale·x + shift) @ w + bias``, the
previous BatchNorm's normalize (and ReLU) fused into the operand load, and
from the float32 accumulator the per-channel ``Σy`` and ``Σy²`` this
layer's BatchNorm needs, so neither the normalized input nor a stats pass
over y costs a trip through device memory. :func:`conv1x1_bn_stats` is the
layer-level form over NHWC tensors, returning y and its biased batch
moments.

On CUDA tensors the forward launches ``csrc/fused_gemm_bn.cu`` (the GEMM
and a fixed-order reduce of its per-tile stats); on CPU tensors it runs
:func:`gemm_bn_stats_reference`, the plain PyTorch version. The backward
is PyTorch ops on both devices (as the JAX package's ``_bwd_rule`` is
plain jnp): the stats' cotangents fold into ``dY' = dy + dΣ + 2y·dΣ²``,
and scale and shift get gradients, so a chain of layers backpropagates
through the previous BatchNorm's batch moments. Where the previous
BatchNorm's moments are x's own batch moments, given as such
(``x_moments``), the backward's tail instead runs ``ops/bn_train.py``'s
backward pair (its kernels on CUDA): dx in closed form with the moments'
terms included.
"""

from __future__ import annotations

import ctypes

import torch

from sparkdl_torch.ops._dispatch import (
    count_launches,
    load_library,
    note_launch,
    on_cuda,
    stream_handle,
)
from sparkdl_torch.ops.bn_train import affine, bn_train_backward

_DTYPES = (torch.float32, torch.bfloat16)


def _prologue(x, scale, shift, relu_in):
    """act(scale·x + shift) in float32, back in x's type."""
    if scale is not None:
        a = (x.float() * scale + shift).to(x.dtype)
        return torch.relu(a) if relu_in else a
    return torch.relu(x) if relu_in else x


def gemm_bn_stats_reference(x, w, scale=None, shift=None, bias=None, *,
                            relu_in=False):
    """The plain version: the prologue, a float32 matmul, the bias, and
    the stats of the float32 y. Returns (y in x's type, Σy, Σy²)."""
    y = _prologue(x, scale, shift, relu_in).float() @ w.float()
    if bias is not None:
        y = y + bias
    return y.to(x.dtype), y.sum(0), (y * y).sum(0)


def _check(x, w, scale, shift, bias):
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"gemm_bn_stats takes x [M, K] and w [K, N], got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if min(x.shape[0], x.shape[1], w.shape[1]) < 1:
        raise ValueError(f"gemm_bn_stats needs M, K, N >= 1, got x "
                         f"{tuple(x.shape)}, w {tuple(w.shape)}")
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise TypeError(f"x and w must both be float32 or both bfloat16, got "
                        f"{x.dtype}, {w.dtype}")
    if (scale is None) != (shift is None):
        raise ValueError("scale and shift come together (the previous BN)")
    k, n = w.shape
    for name, t, size in (("scale", scale, k), ("shift", shift, k),
                          ("bias", bias, n)):
        if t is not None and (t.dtype != torch.float32
                              or tuple(t.shape) != (size,)):
            raise ValueError(f"{name} must be float32 [{size}], got "
                             f"{t.dtype} {tuple(t.shape)}")


def _forward(x, w, scale, shift, bias, relu_in):
    operands = [t for t in (x, w, scale, shift, bias) if t is not None]
    if not on_cuda(*operands):
        return gemm_bn_stats_reference(x, w, scale, shift, bias,
                                       relu_in=relu_in)
    if not x.is_contiguous():
        raise ValueError("gemm_bn_stats kernel needs x [M, K] contiguous")
    scale, shift, bias = (None if t is None else t.contiguous()
                          for t in (scale, shift, bias))
    m, k = x.shape
    n = w.shape[1]
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    stats = torch.empty((2, n), dtype=torch.float32, device=x.device)
    lib = _lib()
    partial = torch.empty((lib.gemm_bn_tiles(m), 2, n), dtype=torch.float32,
                          device=x.device)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(x.device):
        rc = lib.gemm_bn_stats(
            x.data_ptr(), w.data_ptr(), ptr(scale), ptr(shift), ptr(bias),
            y.data_ptr(), partial.data_ptr(), stats.data_ptr(),
            int(x.dtype == torch.bfloat16), m, k, n, w.stride(0), w.stride(1),
            int(bool(relu_in)), stream_handle())
    if rc != 0:
        raise RuntimeError(f"gemm_bn_stats kernel launch failed: cudaError {rc}")
    note_launch(gemm_bn_stats)
    return y, stats[0], stats[1]


class _GemmBnStats(torch.autograd.Function):
    """Forward: the kernel (or the plain version on the CPU). Backward:
    the JAX package's ``_bwd_rule`` in PyTorch ops; with ``x_moments``,
    its tail through the BatchNorm backward pair."""

    @staticmethod
    def forward(ctx, x, w, scale, shift, bias, relu_in, x_moments):
        y, ysum, ysq = _forward(x, w, scale, shift, bias, relu_in)
        ctx.save_for_backward(x, w, scale, shift, bias, y)
        ctx.relu_in, ctx.x_moments = relu_in, x_moments
        ctx.set_materialize_grads(False)  # a stat nobody reads folds in nothing
        return y, ysum, ysq

    @staticmethod
    def backward(ctx, dy, dsum, dsq):
        x, w, scale, shift, bias, y = ctx.saved_tensors
        lp = x.dtype
        # the stats' cotangents fold into one adjusted dY'
        dyp = torch.zeros_like(y) if dy is None else dy
        if dsum is not None or dsq is not None:
            dyp = dyp.float()
            if dsum is not None:
                dyp = dyp + dsum.float()[None, :]
            if dsq is not None:
                dyp = dyp + 2.0 * y.float() * dsq.float()[None, :]
            dyp = dyp.to(lp)
        pre = None
        if scale is not None:
            pre = (x.float() * scale[None, :] + shift[None, :]).to(lp)
            a = torch.relu(pre) if ctx.relu_in else pre
        else:
            a = torch.relu(x) if ctx.relu_in else x
        dw = (a.float().t() @ dyp.float()).to(w.dtype)
        dbias = dyp.float().sum(0) if bias is not None else None
        da = (dyp.float() @ w.float().t()).to(lp)
        if ctx.x_moments is not None:
            mean, var, eps = ctx.x_moments
            (dx,), ((dscale, dshift),), _ = bn_train_backward(
                da, [(x, scale, shift, mean, var)], eps, relu=ctx.relu_in,
                fma_mask=True, scale_grads=True)
            return dx, dw, dscale, dshift, dbias, None, None
        gate = pre if pre is not None else x
        dpre = torch.where(gate > 0, da, 0.0).to(lp) if ctx.relu_in else da
        dscale = dshift = None
        if scale is not None:
            dscale = (dpre.float() * x.float()).sum(0)
            dshift = dpre.float().sum(0)
            dx = (dpre * scale[None, :].to(lp)).to(x.dtype)
        else:
            dx = dpre.to(x.dtype)
        return dx, dw, dscale, dshift, dbias, None, None


def gemm_bn_stats(x, w, scale=None, shift=None, bias=None, *, relu_in=False,
                  x_moments=None):
    """``y = act(scale·x + shift) @ w + bias`` and its per-channel
    ``(Σy, Σy²)``: x ``[M, K]`` and w ``[K, N]`` (float32 or bfloat16; w by
    strides), scale and shift float32 ``[K]`` (both or neither), bias
    float32 ``[N]`` or None, ``act`` ReLU when ``relu_in``. Returns (y
    ``[M, N]`` in x's type, Σy, Σy² in float32), differentiable in x, w,
    scale, shift and bias.

    ``x_moments``: ``(mean, var, eps)`` where scale and shift are the
    BatchNorm affine over x's own biased batch moments (float32 ``[K]``,
    not differentiable): the backward then gives x the whole BatchNorm's
    derivative, the moments' terms included, and scale and shift their
    gradients with the moments held.

    On CUDA tensors the forward launches the kernel on the current stream
    (x contiguous); ``gemm_bn_stats.launches`` counts the launches. On CPU
    tensors it runs :func:`gemm_bn_stats_reference`.
    """
    _check(x, w, scale, shift, bias)
    if x_moments is not None and scale is None:
        raise ValueError("x_moments are the moments of scale and shift's BatchNorm")
    inputs = (x, w, scale, shift, bias)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in inputs):
        return _GemmBnStats.apply(*inputs, bool(relu_in), x_moments)
    return _forward(*inputs, bool(relu_in))


count_launches(gemm_bn_stats, "launches")


def _prev_bn_affine(prev_bn):
    mean, var, gamma, beta, eps = prev_bn
    scale, shift = affine(gamma, beta, mean, var, eps)
    return scale.float(), shift.float()


def _kernel_2d(w):
    if w.dim() == 4:
        if tuple(w.shape[:2]) != (1, 1):
            raise ValueError(f"not a 1x1 kernel: {tuple(w.shape)}")
        w = w[0, 0]
    return w


def conv1x1_bn_stats(x, w, bias=None, *, prev_bn=None, relu_in=False,
                     stride=1, x_moments=False):
    """Fused NHWC 1x1 conv with BN-training epilogues.

    ``x``: ``[B, H, W, Cin]`` (the RAW pre-normalize activation when
    ``prev_bn`` is given). ``w``: ``[1, 1, Cin, Cout]`` or ``[Cin, Cout]``.
    ``prev_bn`` = (mean, var, gamma, beta, eps) of the BN that normalizes
    x; its normalize (and ReLU when ``relu_in``) runs inside the kernel.
    With ``x_moments``, that mean and var are x's own biased batch
    moments (as ``bn_train.batch_moments`` gives them), passed on as
    ``gemm_bn_stats``'s ``x_moments``: they are taken as constants, and
    the backward adds their terms to x's gradient in closed form.
    Returns ``(y, batch_mean, batch_var)``: y ``[B, H', W', Cout]`` and
    the biased batch moments this layer's BN needs, from the float32
    accumulator. A stride-2 input is copied to contiguous rows first.
    """
    w = _kernel_2d(w)
    if stride != 1:
        x = x[:, ::stride, ::stride, :]
    b, h, wd, cin = x.shape
    scale = shift = moments = None
    if prev_bn is not None:
        if x_moments:
            mean, var, gamma, beta, eps = prev_bn
            prev_bn = (mean.detach(), var.detach(), gamma, beta, eps)
            moments = (prev_bn[0], prev_bn[1], eps)
        scale, shift = _prev_bn_affine(prev_bn)
    y, ysum, ysq = gemm_bn_stats(x.reshape(b * h * wd, cin), w, scale, shift,
                                 bias, relu_in=relu_in, x_moments=moments)
    m = b * h * wd
    mean_y = ysum / m
    var_y = torch.clamp(ysq / m - mean_y * mean_y, min=0.0)
    return y.reshape(b, h, wd, w.shape[1]), mean_y, var_y


def reference_conv1x1_bn_stats(x, w, bias=None, *, prev_bn=None,
                               relu_in=False, stride=1):
    """The plain version of :func:`conv1x1_bn_stats`, as the JAX package's
    oracle writes it: normalize and ReLU in float32, the product in x's
    type with float32 accumulation, moments of the float32 y."""
    w = _kernel_2d(w)
    if stride != 1:
        x = x[:, ::stride, ::stride, :]
    a = x.float()
    if prev_bn is not None:
        scale, shift = _prev_bn_affine(prev_bn)
        a = a * scale + shift
    if relu_in:
        a = torch.relu(a)
    y = a.to(x.dtype).float() @ w.float()
    if bias is not None:
        y = y + bias
    m = y.shape[0] * y.shape[1] * y.shape[2]
    mean_y = y.sum((0, 1, 2)) / m
    var_y = torch.clamp((y * y).sum((0, 1, 2)) / m - mean_y * mean_y, min=0.0)
    return y.to(x.dtype), mean_y, var_y


def _lib():
    lib = load_library("fused_gemm_bn")
    if lib.gemm_bn_stats.argtypes is None:
        vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.gemm_bn_tiles.argtypes = [i]
        lib.gemm_bn_tiles.restype = i
        lib.gemm_bn_stats.argtypes = [vp] * 8 + [i] * 4 + [ll, ll, i, vp]
        lib.gemm_bn_stats.restype = i
    return lib
