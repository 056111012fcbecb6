"""Flash attention, forward and backward, as hand-written CUDA kernels.

:func:`flash_attention` computes ``softmax(q·kᵀ·scale)·v`` over
``[B, L, H, D]`` tensors with an optional ``[B, Lk]`` key mask, causal
masking with a static ``q_offset`` (a cached prefill puts its Lq queries
at global positions ``[q_offset, q_offset + Lq)`` against Lk keys at
``[0, Lk)``), and optionally the float32 logsumexp ``[B, H, Lq]``. Masked
scores are the -1e30 sentinel, not -inf, so a query row whose keys are all
masked (a left-pad row) comes out as the uniform average of the value
rows: finite, never NaN.

On CUDA tensors it launches ``csrc/flash_attention.cu``; on CPU tensors it
runs :func:`flash_attention_reference`, the plain PyTorch version. Where a
gradient is wanted, it runs under :class:`_FlashAttention`, whose backward
is :func:`flash_attention_bwd`: the two kernels of
``csrc/flash_attention_bwd.cu`` (dq; dk and dv) on CUDA tensors,
:func:`flash_attention_bwd_reference` on CPU tensors. The kernels' design
and bounds are in the sources' header notes.
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
    stream_handle,
)

NEG_INF = -1e30  # the masked-score sentinel of both versions
DEAD_LSE = -1e29  # an lse at or below this: the query row has no valid key
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


def flash_attention_bwd_reference(q, k, v, kv_mask, o, lse, do, *,
                                  causal=False, scale=None, q_offset=0):
    """The plain version of the backward, as the explicit formula:
    ``p = exp(s - lse)`` rebuilt from the forward's float32 logsumexp,
    ``dv = pᵀ·dO``, ``ds = p·(dO·vᵀ - delta)·scale`` with
    ``delta = rowsum(dO·o)``, ``dq = ds·k``, ``dk = dsᵀ·q``. A query row
    with no valid key (lse <= -1e29) has ``p = 1/Lk`` and ``ds = 0``: what
    autograd through :func:`flash_attention_reference` gives it. Returns
    (dq, dk, dv) in the operands' types."""
    b, lq, _, d = q.shape
    lk = k.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    keep = _keep_mask(b, lq, lk, kv_mask, causal, q_offset, q.device)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    s = torch.where(keep, s, NEG_INF)
    dead = (lse <= DEAD_LSE)[..., None]
    p = torch.where(dead, 1.0 / lk, torch.exp(s - lse[..., None]))
    dof = do.float()
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(v.dtype).float(), dof)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, v.float())
    ds = torch.where(keep, p * (dp - _delta(o, do)[..., None]) * scale, 0.0)
    ds = ds.to(q.dtype).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _delta(o, do):
    """rowsum(dO·o) in float32, [B, H, Lq] contiguous."""
    return (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()


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


def _strides_ok(*tensors):
    if any(t.stride(-1) != 1 for t in tensors):
        raise ValueError("flash_attention kernels need the last dim of q, k, "
                         "v and kv_mask contiguous (stride 1)")


def _forward(q, k, v, kv_mask, causal, scale, q_offset, return_lse):
    b, lq, h, d = q.shape
    lk = k.shape[1]
    operands = (q, k, v) if kv_mask is None else (q, k, v, kv_mask)
    if not on_cuda(*operands):
        return flash_attention_reference(
            q, k, v, kv_mask, causal=causal, scale=scale, q_offset=q_offset,
            return_lse=return_lse)
    _strides_ok(*operands)
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
        note_launch(flash_attention)
    return (out, lse) if return_lse else out


class _FlashAttention(torch.autograd.Function):
    """The forward kernel (with lse) and, as its backward,
    :func:`flash_attention_bwd`; q, k, v, o and lse are saved."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, causal, scale, q_offset):
        o, lse = _forward(q, k, v, kv_mask, causal, scale, q_offset, True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.kv_mask, ctx.causal, ctx.scale, ctx.q_offset = (
            kv_mask, causal, scale, q_offset)
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(
            q, k, v, ctx.kv_mask, o, lse, do, causal=ctx.causal,
            scale=ctx.scale, q_offset=ctx.q_offset)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, kv_mask=None, *, causal=False, scale=None,
                    q_offset=0, return_lse=False):
    """Fused attention over ``[B, L, H, D]``: q ``[B, Lq, H, D]``, k and v
    ``[B, Lk, H, D]`` (float32 or bfloat16, D <= 128), kv_mask bool
    ``[B, Lk]`` (False = excluded) or None. Returns o ``[B, Lq, H, D]`` in
    q's type, and with ``return_lse`` also the float32 logsumexp
    ``[B, H, Lq]`` (not differentiable).

    On CUDA tensors this launches the kernel on the current stream,
    reading q, k, v in place by strides (their last dim contiguous);
    ``flash_attention.launches`` counts the launches. On CPU tensors it runs
    :func:`flash_attention_reference`. Differentiable in q, k and v on both:
    with grad mode on and an input that requires grad, the call runs under
    :class:`_FlashAttention`, whose backward is :func:`flash_attention_bwd`.
    """
    q_offset = int(q_offset)
    _check(q, k, v, kv_mask, q_offset)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    scale = float(scale)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        o, lse = _FlashAttention.apply(q, k, v, kv_mask, bool(causal), scale,
                                       q_offset)
        return (o, lse) if return_lse else o
    return _forward(q, k, v, kv_mask, causal, scale, q_offset, return_lse)


count_launches(flash_attention, "launches")


def flash_attention_bwd(q, k, v, kv_mask, o, lse, do, *, causal=False,
                        scale=None, q_offset=0):
    """The backward of :func:`flash_attention`: (dq, dk, dv) from the
    forward's inputs, its output ``o`` and float32 ``lse`` ``[B, H, Lq]``,
    and the output's cotangent ``do`` ``[B, Lq, H, D]``.

    On CUDA tensors it computes ``delta = rowsum(dO·o)`` (a PyTorch
    reduction, as the JAX package does it outside its kernels), then
    launches the dq kernel and the dk/dv kernel on the current stream,
    counted in ``flash_attention_bwd.launches_dq`` and ``.launches_dkv``.
    On CPU tensors it runs :func:`flash_attention_bwd_reference`.
    """
    q_offset = int(q_offset)
    _check(q, k, v, kv_mask, q_offset)
    b, lq, h, d = q.shape
    lk = k.shape[1]
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"o and do must be {tuple(q.shape)}, got "
                         f"{tuple(o.shape)}, {tuple(do.shape)}")
    if tuple(lse.shape) != (b, h, lq) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be float32 [B, H, Lq] = {(b, h, lq)}, got "
                         f"{lse.dtype} {tuple(lse.shape)}")
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    operands = (q, k, v, o, lse, do) + (() if kv_mask is None else (kv_mask,))
    if not on_cuda(*operands):
        return flash_attention_bwd_reference(
            q, k, v, kv_mask, o, lse, do, causal=causal, scale=scale,
            q_offset=q_offset)
    _strides_ok(q, k, v, *(() if kv_mask is None else (kv_mask,)))
    if do.dtype != q.dtype:
        raise TypeError(f"do must be {q.dtype}, got {do.dtype}")
    if do.stride(-1) != 1:
        do = do.contiguous()
    delta = _delta(o, do)
    lse = lse.contiguous()
    dq = torch.empty((b, lq, h, d), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, lk, h, d), dtype=k.dtype, device=q.device)
    dv = torch.empty((b, lk, h, d), dtype=v.dtype, device=q.device)
    if not (b and lq and h):
        return dq, dk.zero_(), dv.zero_()
    fn = _bwd_entry()
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            None if kv_mask is None else kv_mask.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            int(q.dtype == torch.bfloat16), b, lq, lk, h, d,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *do.stride()[:3], 0 if kv_mask is None else kv_mask.stride(0),
            float(scale), int(bool(causal)), q_offset)
    for which, counter in ((0, "launches_dq"), (1, "launches_dkv")):
        with torch.cuda.device(q.device):
            rc = fn(which, *args, stream_handle())
        if rc != 0:
            raise RuntimeError(f"flash_attention_bwd kernel {counter[9:]} "
                               f"launch failed: cudaError {rc}")
        note_launch(flash_attention_bwd, counter)
    return dq, dk, dv


count_launches(flash_attention_bwd, "launches_dq", "launches_dkv")


def _entry():
    fn = load_library("flash_attention").flash_attention_fwd
    if fn.argtypes is None:
        vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = ([vp] * 6 + [i] * 6 + [ll] * 10
                       + [ctypes.c_float, i, i, vp])
        fn.restype = ctypes.c_int
    return fn


def _bwd_entry():
    fn = load_library("flash_attention_bwd").flash_attention_bwd
    if fn.argtypes is None:
        vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = ([i] + [vp] * 10 + [i] * 6 + [ll] * 13
                       + [ctypes.c_float, i, i, vp])
        fn.restype = ctypes.c_int
    return fn
