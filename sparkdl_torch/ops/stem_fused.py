"""The InceptionV3 stem as one hand-written CUDA kernel.

The stem is conv 3x3/2 VALID 3->32, conv 3x3 VALID 32->32, conv 3x3 SAME
32->64 (each conv-BN-ReLU) and a 3x3/2 max-pool: [B, 299, 299, 3] pixels
in, [B, 73, 73, 64] features out. With BatchNorm and the 'tf' preprocess
folded into the weights (:func:`fold_stem_params` after
``ops/fold.py``), it eats raw [0, 255] pixels.

:func:`inception_stem_fused` launches ``csrc/stem_fused.cu`` on CUDA
tensors and runs :func:`stem_reference`, the plain PyTorch version, on
CPU tensors. The kernel's design and its bound are in the source's
header note.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from sparkdl_torch.ops._dispatch import load_library, on_cuda, stream_handle

_PARAM_SHAPES = {
    "k1": (3, 3, 3, 32), "s1": (32,), "b1": (32,),
    "k2": (3, 3, 32, 32), "s2": (32,), "b2": (32,),
    "k3": (3, 3, 32, 64), "s3": (64,), "b3": (64,),
}
_PARAM_ORDER = ("k1", "s1", "b1", "k2", "s2", "b2", "k3", "s3", "b3")
MIN_SIZE = 11  # smallest S with a pooled output (Rp >= 1)


def stem_out_size(s: int) -> int:
    """Pooled output side Rp for an S x S input (73 at S = 299)."""
    h2 = (s - 3) // 2 + 1 - 2
    return (h2 - 3) // 2 + 1


def fold_stem_params(state_dict: dict, eps: float = 1e-3) -> dict:
    """Extract conv000-002 + bn000-002 and fold BN into (scale, bias).

    The zoo stem is bias-free conv + BatchNorm(use_scale=False), so
    y = relu(conv(x) * s + b) with s = 1/sqrt(var+eps), b = bias - mean*s.
    Works on plain or ``fold_tf_preprocess``'ed weights. Kernels come out
    HWIO, float32, on the weights' device.
    """
    out = {}
    for i, name in enumerate(("000", "001", "002"), start=1):
        k = state_dict[f"conv{name}.weight"].float()  # OIHW
        mean = state_dict[f"bn{name}.running_mean"].float()
        var = state_dict[f"bn{name}.running_var"].float()
        bias = state_dict[f"bn{name}.bias"].float()
        s = 1.0 / torch.sqrt(var + eps)
        out[f"k{i}"] = k.permute(2, 3, 1, 0).contiguous()
        out[f"s{i}"] = s.contiguous()
        out[f"b{i}"] = (bias - mean * s).contiguous()
    return out


def stem_reference(x: torch.Tensor, folded: dict,
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The plain version: the model's own stem math on the folded params
    (conv-BN-ReLU x3 + max-pool) as PyTorch convolutions. NHWC in and out."""
    h = x.to(torch.float32).permute(0, 3, 1, 2)

    def cbr(h, i, stride, padding):
        w = folded[f"k{i}"].permute(3, 2, 0, 1)  # HWIO -> OIHW
        y = F.conv2d(h, w, stride=stride, padding=padding)
        s = folded[f"s{i}"].view(1, -1, 1, 1)
        b = folded[f"b{i}"].view(1, -1, 1, 1)
        return torch.relu(y * s + b)

    h = cbr(h, 1, 2, 0)
    h = cbr(h, 2, 1, 0)
    h = cbr(h, 3, 1, 1)  # SAME at stride 1 with an odd kernel is symmetric
    h = F.max_pool2d(h, 3, 2)
    return h.permute(0, 2, 3, 1).to(dtype)


def _check(x: torch.Tensor, folded: dict, dtype: torch.dtype) -> None:
    if x.dim() != 4 or x.shape[3] != 3 or x.shape[1] != x.shape[2]:
        raise ValueError(f"stem expects NHWC [B, S, S, 3] pixels, got {tuple(x.shape)}")
    if x.shape[1] < MIN_SIZE:
        raise ValueError(f"stem needs S >= {MIN_SIZE}, got S={x.shape[1]}")
    if x.dtype not in (torch.uint8, torch.float32):
        raise TypeError(f"stem pixels must be uint8 or float32, got {x.dtype}")
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"stem output must be float32 or bfloat16, got {dtype}")
    for name, shape in _PARAM_SHAPES.items():
        p = folded[name]
        if tuple(p.shape) != shape or p.dtype != torch.float32:
            raise ValueError(
                f"folded[{name!r}] must be float32 {shape}, got "
                f"{p.dtype} {tuple(p.shape)}"
            )


def inception_stem_fused(x: torch.Tensor, folded: dict, *,
                         dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """NHWC pixels [B, S, S, 3] (uint8 or float32, [0, 255]) -> stem
    features [B, Rp, Rp, 64] in ``dtype`` (float32 or bfloat16).

    ``folded`` from :func:`fold_stem_params`. On CUDA tensors this launches
    the kernel on the current stream (``inception_stem_fused.launches``
    counts the launches); on CPU tensors it runs :func:`stem_reference`.
    """
    _check(x, folded, dtype)
    params = [folded[k] for k in _PARAM_ORDER]
    if not on_cuda(x, *params):
        return stem_reference(x, folded, dtype)
    for t in (x, *params):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("stem kernel needs contiguous, 16-byte aligned tensors")
    b, s = x.shape[0], x.shape[1]
    rp = stem_out_size(s)
    out = torch.empty((b, rp, rp, 64), dtype=dtype, device=x.device)
    if b == 0:
        return out
    fn = _entry()
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), int(x.dtype == torch.uint8),
                *(p.data_ptr() for p in params), out.data_ptr(),
                int(dtype == torch.bfloat16), b, s, stream_handle())
    if rc != 0:
        raise RuntimeError(f"stem_fused kernel launch failed: cudaError {rc}")
    inception_stem_fused.launches += 1
    return out


inception_stem_fused.launches = 0


def _entry():
    fn = load_library("stem_fused").stem_fused
    if fn.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, i] + [vp] * 9 + [vp, i, i, i, vp]
        fn.restype = ctypes.c_int
    return fn
