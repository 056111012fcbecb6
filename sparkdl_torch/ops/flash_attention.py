"""Flash attention forward as one hand-written CUDA kernel.

:func:`flash_attention` computes ``softmax(q·kᵀ·scale)·v`` over
``[B, L, H, D]`` tensors with an optional ``[B, Lk]`` key mask, causal
masking with a static ``q_offset`` (a cached prefill puts its Lq queries
at global positions ``[q_offset, q_offset + Lq)`` against Lk keys at
``[0, Lk)``), and optionally the float32 logsumexp ``[B, H, Lq]``. Masked
scores are the -1e30 sentinel, not -inf, so a query row whose keys are all
masked (a left-pad row) comes out as the uniform average of the value
rows: finite, never NaN.

On CUDA tensors it launches ``csrc/flash_attention.cu``; on CPU tensors it
runs :func:`flash_attention_reference`, the plain PyTorch version. The
kernel's design and its bound are in the source's header note. Forward
only: the backward kernels come with training.
"""

from __future__ import annotations

import ctypes
import math

import torch

from sparkdl_torch.ops._dispatch import load_library, on_cuda, stream_handle

NEG_INF = -1e30  # the masked-score sentinel of both versions
MAX_HEAD_DIM = 128
_DTYPES = (torch.float32, torch.bfloat16)


def _keep_mask(b, lq, lk, kv_mask, causal, q_offset, device):
    """[B, 1, Lq, Lk] bool: True where a query row may attend a key."""
    keep = torch.ones((b, 1, lq, lk), dtype=torch.bool, device=device)
    if kv_mask is not None:
        keep = keep & kv_mask[:, None, None, :]
    if causal:
        q_pos = q_offset + torch.arange(lq, device=device)
        k_pos = torch.arange(lk, device=device)
        keep = keep & (k_pos[None, :] <= q_pos[:, None])
    return keep


def flash_attention_reference(q, k, v, kv_mask=None, *, causal=False,
                              scale=None, q_offset=0, return_lse=False):
    """The plain version: masked-softmax einsum in float32, probabilities
    dropped to v's type before the PV product (as the kernel does)."""
    b, lq, _, d = q.shape
    lk = k.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    s = torch.where(_keep_mask(b, lq, lk, kv_mask, causal, q_offset, q.device),
                    s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    o = o.to(q.dtype)
    return (o, torch.logsumexp(s, dim=-1)) if return_lse else o


def _check(q, k, v, kv_mask, q_offset):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(
            f"flash_attention takes [B, L, H, D] tensors, got q "
            f"{tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    b, _, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != (h, d):
        raise ValueError(
            f"k and v must be [B, Lk, H, D] matching q {tuple(q.shape)}, got "
            f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if k.shape[1] < 1:
        raise ValueError("flash_attention needs at least one key")
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"head dim D must be in [1, {MAX_HEAD_DIM}], got {d}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"q, k, v must all be float32 or all bfloat16, got {q.dtype}, "
            f"{k.dtype}, {v.dtype}")
    if kv_mask is not None and (kv_mask.dtype != torch.bool
                                or tuple(kv_mask.shape) != (b, k.shape[1])):
        raise ValueError(
            f"kv_mask must be bool [B, Lk] = {(b, k.shape[1])}, got "
            f"{kv_mask.dtype} {tuple(kv_mask.shape)}")
    if q_offset < 0:
        raise ValueError(f"q_offset must be >= 0, got {q_offset}")


def flash_attention(q, k, v, kv_mask=None, *, causal=False, scale=None,
                    q_offset=0, return_lse=False):
    """Fused attention over ``[B, L, H, D]``: q ``[B, Lq, H, D]``, k and v
    ``[B, Lk, H, D]`` (float32 or bfloat16, D <= 128), kv_mask bool
    ``[B, Lk]`` (False = excluded) or None. Returns o ``[B, Lq, H, D]`` in
    q's type, and with ``return_lse`` also the float32 logsumexp
    ``[B, H, Lq]``.

    On CUDA tensors this launches the kernel on the current stream,
    reading q, k, v in place by strides (their last dim contiguous);
    ``flash_attention.launches`` counts the launches. On CPU tensors it runs
    :func:`flash_attention_reference`.
    """
    q_offset = int(q_offset)
    _check(q, k, v, kv_mask, q_offset)
    b, lq, h, d = q.shape
    lk = k.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    operands = (q, k, v) if kv_mask is None else (q, k, v, kv_mask)
    if not on_cuda(*operands):
        return flash_attention_reference(
            q, k, v, kv_mask, causal=causal, scale=scale, q_offset=q_offset,
            return_lse=return_lse)
    if any(t.stride(-1) != 1 for t in operands):
        raise ValueError("flash_attention kernel needs the last dim of q, k, "
                         "v and kv_mask contiguous (stride 1)")
    out = torch.empty((b, lq, h, d), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, h, lq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if b and lq and h:
        fn = _entry()
        with torch.cuda.device(q.device):
            rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    None if kv_mask is None else kv_mask.data_ptr(),
                    out.data_ptr(), None if lse is None else lse.data_ptr(),
                    int(q.dtype == torch.bfloat16), b, lq, lk, h, d,
                    *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                    0 if kv_mask is None else kv_mask.stride(0),
                    float(scale), int(bool(causal)), q_offset, stream_handle())
        if rc != 0:
            raise RuntimeError(
                f"flash_attention kernel launch failed: cudaError {rc}")
        flash_attention.launches += 1
    return (out, lse) if return_lse else out


flash_attention.launches = 0


def _entry():
    fn = load_library("flash_attention").flash_attention_fwd
    if fn.argtypes is None:
        vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = ([vp] * 6 + [i] * 6 + [ll] * 10
                       + [ctypes.c_float, i, i, vp])
        fn.restype = ctypes.c_int
    return fn
