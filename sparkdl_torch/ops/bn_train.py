"""BatchNorm in training, forward and backward, as hand-written CUDA
kernels over NHWC activations viewed as ``[M, C]`` (``csrc/bn_train.cu``).

The fused ResNet50 train step (``models/resnet_fused.py``) normalizes 53
activations a step. Eagerly, each BatchNorm's multiply, add, ReLU,
residual add, moments and every one of their backwards is its own pass
over the activation. Here a BatchNorm costs one pass forward (and one for
its moments where no fused GEMM gave them) and two backward:

- :func:`batch_moments` — the biased batch moments of y, Flax's
  ``E[y²] − E[y]²`` clamped at 0, in one read;
- :func:`bn_train` — ``z = act(Σ_j BN_j(y_j) + r)``: one BatchNorm or two
  (a bottleneck's close adds the shortcut's), a residual, ReLU, in one
  read of each input and one write. It is differentiable in each y_j,
  gamma_j, beta_j and r, and takes the moments as y_j's own batch
  moments: its backward includes their terms in closed form, so nothing
  flows back through them;
- :func:`bn_train_backward` — that backward: a reduce pass (``Σg`` and
  ``Σg·(y_j − mean_j)``, with ``g = dz·[u > 0]`` recomputed from the
  inputs) and a pass that writes each dy_j and the residual's gradient.
  The fused GEMM's backward runs it for the BatchNorm it applies in its
  operand load (``ops/fused_gemm_bn.py``).

Reductions over M run in a fixed order (two stages, no atomics), so a
step gives the same bits run to run, eagerly or as a CUDA graph.

On CUDA tensors each function launches its kernels on the current stream;
on CPU (and meta) tensors it runs its plain PyTorch version, the same
arithmetic in PyTorch ops: the forward is the eager chain's own multiply
then add in float32, rounded once to the activation's type. Each
kernel wrapper's ``launches`` counts its calls (a call launches the same
kernels every time: moments 2, apply 1, backward 3).
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

_DTYPES = (torch.float32, torch.bfloat16)


def _check_rows(name, *ys):
    y0 = ys[0]
    if y0.dim() != 2 or min(y0.shape) < 1:
        raise ValueError(f"{name} takes [M, C] tensors with M, C >= 1, got "
                         f"{tuple(y0.shape)}")
    if y0.dtype not in _DTYPES:
        raise TypeError(f"{name} takes float32 or bfloat16, got {y0.dtype}")
    for y in ys[1:]:
        if y is not None and (y.shape != y0.shape or y.dtype != y0.dtype):
            raise ValueError(f"{name}: every [M, C] tensor must be {y0.dtype} "
                             f"{tuple(y0.shape)}, got {y.dtype} {tuple(y.shape)}")


def _check_channels(name, c, *vecs):
    for t in vecs:
        if t.dtype != torch.float32 or tuple(t.shape) != (c,):
            raise ValueError(f"{name}: per-channel tensors must be float32 "
                             f"[{c}], got {t.dtype} {tuple(t.shape)}")


def affine(gamma, beta, mean, var, eps):
    """The BatchNorm as one affine, ``(gamma·rsqrt(var + eps), beta −
    mean·scale)``: the eager chain's formula (``models.common.bn_scale_shift``)."""
    scale = gamma * torch.rsqrt(var + eps)
    return scale, beta - mean * scale


# -- plain versions -------------------------------------------------------------


def batch_moments_reference(y):
    """The plain :func:`batch_moments`."""
    yf = y.float()
    mean = yf.mean(0)
    return mean, torch.clamp((yf * yf).mean(0) - mean * mean, min=0.0)


def _pre_act(terms, residual):
    """``Σ_j (y_j·s_j + t_j) + r`` in float32, each op rounded on its own."""
    u = None
    for y, s, t, *_ in terms:
        a = y.float() * s + t
        u = a if u is None else u + a
    return u if residual is None else u + residual.float()


def bn_train_apply_reference(terms, residual=None, *, relu=True):
    """The plain forward of :func:`bn_train`; ``terms`` are ``(y, scale,
    shift)``."""
    u = _pre_act(terms, residual)
    return (torch.relu(u) if relu else u).to(terms[0][0].dtype)


def bn_train_backward_reference(dz, terms, eps, residual=None, *, relu=True,
                                fma_mask=False, scale_grads=False):
    """The plain :func:`bn_train_backward`, in float32."""
    g = dz.float()
    if relu:
        if fma_mask:  # the sign of fmaf(y, s, t): exact in float64
            y, s, t, *_ = terms[0]
            u = y.double() * s.double() + t.double()
        else:
            u = _pre_act(terms, residual)
        g = torch.where(u > 0, g, 0.0)
    m = g.shape[0]
    s0 = g.sum(0)
    dys, grads = [], []
    for y, s, _, mean, var in terms:
        d = y.float() - mean
        sj = (g * d).sum(0)
        dys.append((s * g - (s * s0) / m - d * ((s * sj / (var + eps)) / m))
                   .to(y.dtype))
        grads.append((sj + mean * s0 if scale_grads
                      else sj * torch.rsqrt(var + eps), s0))
    dr = None if residual is None else g.to(residual.dtype)
    return dys, grads, dr


# -- kernels --------------------------------------------------------------------


def _ptr(t):
    return None if t is None else t.data_ptr()


def _kernel_rows(name, *ys):
    """The [M, C] tensors as the kernels take them: contiguous, 16-byte
    rows."""
    y0 = ys[0]
    per16 = 16 // y0.element_size()
    if y0.shape[1] % per16:
        raise ValueError(f"{name} kernel takes C a multiple of {per16} for "
                         f"{y0.dtype}, got {y0.shape[1]}")
    out = [None if y is None else y.contiguous() for y in ys]
    if any(y is not None and y.data_ptr() % 16 for y in out):
        raise ValueError(f"{name} kernel takes 16-byte aligned tensors")
    return out


def _vecs(*ts):
    return [None if t is None else t.contiguous() for t in ts]


def batch_moments(y):
    """The biased batch moments ``(mean, var)`` of ``y`` ``[M, C]``
    (float32 or bfloat16) over its rows, float32 ``[C]`` each, not
    differentiable (a BatchNorm built on them takes them as y's own, as
    :func:`bn_train` does). ``batch_moments.launches`` counts its calls
    on CUDA tensors (two kernels each)."""
    _check_rows("batch_moments", y)
    if not on_cuda(y):
        with torch.no_grad():
            return batch_moments_reference(y)
    (y,) = _kernel_rows("batch_moments", y)
    m, c = y.shape
    lib = _lib()
    bf16 = int(y.dtype == torch.bfloat16)
    out = torch.empty((2, c), dtype=torch.float32, device=y.device)
    partial = torch.empty((lib.bn_train_tiles(m, c, bf16), 2, c),
                          dtype=torch.float32, device=y.device)
    with torch.cuda.device(y.device):
        rc = lib.bn_train_moments(y.data_ptr(), partial.data_ptr(), out.data_ptr(),
                                  bf16, m, c, stream_handle())
    if rc != 0:
        raise RuntimeError(f"bn_train moments launch failed: cudaError {rc}")
    note_launch(batch_moments)
    return out[0], out[1]


def bn_train_apply(terms, residual=None, relu=True):
    """``act(Σ_j (y_j·s_j + t_j) + r)`` over one or two ``(y, scale,
    shift)`` terms, computed in float32 and returned in y's type: the
    forward of :func:`bn_train` once the affines are known.
    ``bn_train_apply.launches`` counts its launches on CUDA tensors."""
    if not on_cuda(*(x for term in terms for x in term),
                   *([] if residual is None else [residual])):
        return bn_train_apply_reference(terms, residual, relu=relu)
    (y0, s0, t0), (y1, s1, t1) = terms[0], (terms + [(None,) * 3])[1]
    y0, y1, residual = _kernel_rows("bn_train", y0, y1, residual)
    s0, t0, s1, t1 = _vecs(s0, t0, s1, t1)
    m, c = y0.shape
    z = torch.empty_like(y0)
    with torch.cuda.device(y0.device):
        rc = _lib().bn_train_apply(
            y0.data_ptr(), s0.data_ptr(), t0.data_ptr(), _ptr(y1), _ptr(s1), _ptr(t1),
            _ptr(residual), z.data_ptr(), int(bool(relu)),
            int(y0.dtype == torch.bfloat16), m, c, stream_handle())
    if rc != 0:
        raise RuntimeError(f"bn_train apply launch failed: cudaError {rc}")
    note_launch(bn_train_apply)
    return z


def bn_train_backward(dz, terms, eps, residual=None, *, relu=True,
                      fma_mask=False, scale_grads=False):
    """The backward of ``z = act(Σ_j (y_j·s_j + t_j) + r)`` where s_j and
    t_j are BatchNorm ``j``'s affine over y_j's own batch moments.

    ``terms`` are ``(y, scale, shift, mean, var)`` for one or two
    BatchNorms (y ``[M, C]`` like ``dz``, the rest float32 ``[C]``);
    ``residual`` is r (needed for the ReLU's mask) or None. ``fma_mask``
    takes u as ``fmaf(y, s, t)``, the fused GEMM's operand load (one
    BatchNorm, no residual). Returns ``(dys, grads, dr)``: the whole
    derivative in each y_j, the moments' terms included; per BatchNorm
    ``(dgamma, dbeta)``, or with ``scale_grads`` ``(dscale, dshift)``
    (the gradient of the affine itself, with mean and var held); and dr,
    None without a residual. ``bn_train_backward.launches`` counts its
    calls on CUDA tensors (three kernels each).
    """
    if len(terms) not in (1, 2) or (fma_mask and (len(terms) > 1
                                                  or residual is not None)):
        raise ValueError("bn_train_backward takes one or two BatchNorms; the "
                         "fma mask one BatchNorm without a residual")
    ys = [term[0] for term in terms]
    _check_rows("bn_train_backward", dz, *ys, residual)
    c = dz.shape[1]
    for term in terms:
        _check_channels("bn_train_backward", c, *term[1:])
    if not on_cuda(dz, *(x for term in terms for x in term),
                   *([] if residual is None else [residual])):
        return bn_train_backward_reference(dz, terms, eps, residual, relu=relu,
                                           fma_mask=fma_mask,
                                           scale_grads=scale_grads)
    dz, *ys, residual = _kernel_rows("bn_train_backward", dz, *ys, residual)
    params = [_vecs(*term[1:]) for term in terms]
    (s1, t1, mean1, var1), y1 = (params + [[None] * 4])[1], (ys + [None])[1]
    s0, t0, mean0, var0 = params[0]
    m = dz.shape[0]
    j = len(terms)
    dys = [torch.empty_like(y) for y in ys]
    dr = None if residual is None else torch.empty_like(residual)
    lib = _lib()
    bf16 = int(dz.dtype == torch.bfloat16)
    f32 = dict(dtype=torch.float32, device=dz.device)
    partial = torch.empty((lib.bn_train_tiles(m, c, bf16), 1 + j, c), **f32)
    coef = torch.empty((j, 2, c), **f32)
    grads = torch.empty((j, 2, c), **f32)
    with torch.cuda.device(dz.device):
        rc = lib.bn_train_backward(
            dz.data_ptr(), ys[0].data_ptr(), s0.data_ptr(), t0.data_ptr(),
            mean0.data_ptr(), var0.data_ptr(), dys[0].data_ptr(),
            _ptr(y1), _ptr(s1), _ptr(t1), _ptr(mean1), _ptr(var1),
            _ptr(dys[1] if j > 1 else None), _ptr(residual), _ptr(dr), float(eps),
            int(bool(relu)), int(bool(fma_mask)), int(bool(scale_grads)),
            partial.data_ptr(), coef.data_ptr(), grads.data_ptr(), bf16, m, c,
            stream_handle())
    if rc != 0:
        raise RuntimeError(f"bn_train backward launch failed: cudaError {rc}")
    note_launch(bn_train_backward)
    return dys, [(grads[i, 0], grads[i, 1]) for i in range(j)], dr


class _BnTrain(torch.autograd.Function):
    """Forward: the apply kernel (or its plain version). Backward: the
    closed-form pair, returning nothing for the moments."""

    @staticmethod
    def forward(ctx, relu, eps, residual, *flat):
        terms = [flat[i:i + 5] for i in range(0, len(flat), 5)]
        saved = []
        for y, gamma, beta, mean, var in terms:
            saved += [y, *affine(gamma, beta, mean, var, eps), mean, var]
        ctx.relu, ctx.eps = relu, eps
        ctx.save_for_backward(residual, *saved)
        return bn_train_apply([tuple(saved[i:i + 3]) for i in range(0, len(saved), 5)],
                              residual, relu)

    @staticmethod
    def backward(ctx, dz):
        residual, *saved = ctx.saved_tensors
        terms = [tuple(saved[i:i + 5]) for i in range(0, len(saved), 5)]
        dys, grads, dr = bn_train_backward(dz, terms, ctx.eps, residual,
                                           relu=ctx.relu)
        out = [None, None, dr]
        for dy, (dgamma, dbeta) in zip(dys, grads):
            out += [dy, dgamma, dbeta, None, None]
        return tuple(out)


def bn_train(terms, eps, *, residual=None, relu=True):
    """``z = act(Σ_j BN_j(y_j) + residual)`` in training.

    ``terms``: one or two ``(y, gamma, beta, mean, var)``: y ``[M, C]``
    (float32 or bfloat16, all alike), the rest float32 ``[C]``, mean and
    var y's biased batch moments (from :func:`batch_moments` or the fused
    GEMM). ``residual``: ``[M, C]`` like y, or None; ``act`` ReLU when
    ``relu``. Computes in float32 and returns z in y's type,
    differentiable in each y, gamma and beta and in the residual (the
    moments' terms are in y's gradient; the moments themselves get none):
    :func:`bn_train_apply` forward, :func:`bn_train_backward` backward.
    """
    if len(terms) not in (1, 2):
        raise ValueError(f"bn_train takes one or two BatchNorms, got {len(terms)}")
    ys = [term[0] for term in terms]
    _check_rows("bn_train", *ys, residual)
    for term in terms:
        _check_channels("bn_train", ys[0].shape[1], *term[1:])
    flat = [x for term in terms for x in term]
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (residual, *flat)):
        return _BnTrain.apply(bool(relu), float(eps), residual, *flat)
    return bn_train_apply([(y, *affine(g, b, m, v, eps)) for y, g, b, m, v in terms],
                          residual, relu)


count_launches(batch_moments, "launches")
count_launches(bn_train_apply, "launches")
count_launches(bn_train_backward, "launches")


def _lib():
    lib = load_library("bn_train")
    if lib.bn_train_apply.argtypes is None:
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.bn_train_tiles.argtypes = [i, i, i]
        lib.bn_train_tiles.restype = i
        lib.bn_train_moments.argtypes = [vp, vp, vp, i, i, i, vp]
        lib.bn_train_moments.restype = i
        lib.bn_train_apply.argtypes = [vp] * 8 + [i] * 4 + [vp]
        lib.bn_train_apply.restype = i
        lib.bn_train_backward.argtypes = ([vp] * 15 + [f] + [i] * 3 + [vp] * 3
                                          + [i] * 3 + [vp])
        lib.bn_train_backward.restype = i
    return lib
