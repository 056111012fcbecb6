"""Flash decode — one query over a dense KV cache — as one hand-written
CUDA kernel.

:func:`flash_decode` is a decode step of cached attention: the query of
position ``idx`` against cache columns ``[start[b], idx]`` of
``ck``/``cv`` ``[B, L, H, D]``. ``idx`` is a host int (the lockstep
cache's write position), so no step reads it back from the device;
``start`` ([B] int32, default 0) is each row's first valid column for
left-padded prompts.

On CUDA tensors it launches ``csrc/flash_decode.cu``; on CPU tensors it
runs :func:`reference_decode`, the plain PyTorch version. The kernel's
design and its bound are in the source's header note.
"""

from __future__ import annotations

import ctypes
import math

import torch

from sparkdl_torch.ops._dispatch import (
    count_launches,
    load_library,
    note_launch,
    on_cuda,
    refuse_grad,
    stream_handle,
)
from sparkdl_torch.ops.flash_attention import MAX_HEAD_DIM, NEG_INF

_DTYPES = (torch.float32, torch.bfloat16)


def reference_decode(q, ck, cv, idx, start=None):
    """The plain version: the dense masked single-query path. Columns
    after ``idx`` or before ``start[b]`` get the -1e30 sentinel."""
    lmax, d = ck.shape[1], ck.shape[3]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), ck.float()) / math.sqrt(d)
    cols = torch.arange(lmax, device=q.device)
    keep = (cols <= idx)[None, :]
    if start is not None:
        keep = keep & (cols[None, :] >= start.to(cols.dtype)[:, None])
    s = torch.where(keep[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p.float(), cv.float()).to(q.dtype)


def _check(q, ck, cv, idx, start):
    if isinstance(idx, torch.Tensor):
        raise TypeError("flash_decode takes idx as a host int, not a tensor")
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(
            f"flash_decode is single-query: q must be [B, 1, H, D], got "
            f"{tuple(q.shape)}")
    b, _, h, d = q.shape
    if ck.shape != cv.shape or ck.dim() != 4 or ck.shape[0] != b \
            or ck.shape[2:] != (h, d):
        raise ValueError(
            f"ck and cv must be [B, L, H, D] matching q {tuple(q.shape)}, got "
            f"{tuple(ck.shape)}, {tuple(cv.shape)}")
    if not 0 <= idx < ck.shape[1]:
        raise ValueError(f"idx {idx} outside the cache [0, {ck.shape[1]})")
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"head dim D must be in [1, {MAX_HEAD_DIM}], got {d}")
    if q.dtype not in _DTYPES or ck.dtype != q.dtype or cv.dtype != q.dtype:
        raise TypeError(
            f"q, ck, cv must all be float32 or all bfloat16, got {q.dtype}, "
            f"{ck.dtype}, {cv.dtype}")
    if start is not None and (start.dtype != torch.int32
                              or tuple(start.shape) != (b,)):
        raise ValueError(f"start must be int32 [B] = ({b},), got "
                         f"{start.dtype} {tuple(start.shape)}")


def flash_decode(q, ck, cv, idx, *, start=None):
    """One decode step: q ``[B, 1, H, D]`` (the query of position
    ``idx``), ck/cv ``[B, L, H, D]`` with columns ``<= idx`` written,
    ``idx`` a host int, ``start`` int32 ``[B]`` or None. Returns
    ``softmax(q·K[start:idx+1]ᵀ/√D)·V[start:idx+1]`` as ``[B, 1, H, D]``
    in q's type.

    On CUDA tensors this launches the kernel on the current stream,
    reading the cache in place by strides (last dim contiguous);
    ``flash_decode.launches`` counts the launches. On CPU tensors it runs
    :func:`reference_decode`. Forward only: raises where an input
    requires grad under grad mode.
    """
    _check(q, ck, cv, idx, start)
    refuse_grad("flash_decode", q, ck, cv)
    idx = int(idx)
    operands = (q, ck, cv) if start is None else (q, ck, cv, start)
    if not on_cuda(*operands):
        return reference_decode(q, ck, cv, idx, start)
    if any(t.stride(-1) != 1 for t in (q, ck, cv)) or (
            start is not None and not start.is_contiguous()):
        raise ValueError("flash_decode kernel needs the last dim of q, ck, cv "
                         "and start contiguous (stride 1)")
    b, _, h, d = q.shape
    out = torch.empty((b, 1, h, d), dtype=q.dtype, device=q.device)
    if b and h:
        fn = _entry()
        with torch.cuda.device(q.device):
            rc = fn(q.data_ptr(), ck.data_ptr(), cv.data_ptr(),
                    None if start is None else start.data_ptr(),
                    out.data_ptr(), int(q.dtype == torch.bfloat16),
                    b, ck.shape[1], h, d, idx, q.stride(0), q.stride(2),
                    *ck.stride()[:3], *cv.stride()[:3],
                    1.0 / math.sqrt(d), stream_handle())
        if rc != 0:
            raise RuntimeError(f"flash_decode kernel launch failed: cudaError {rc}")
        note_launch(flash_decode)
    return out


count_launches(flash_decode, "launches")


def _entry():
    fn = load_library("flash_decode").flash_decode
    if fn.argtypes is None:
        vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [vp] * 5 + [i] * 6 + [ll] * 8 + [ctypes.c_float, vp]
        fn.restype = ctypes.c_int
    return fn
