"""Ring attention: exact attention over sequences split on the ``sp``
axis, the port of ``sparkdl_tpu.parallel.ring_attention``.

Each ``sp`` peer holds one contiguous block of the sequence's Q/K/V.
The K/V blocks travel around the ring (``batch_isend_irecv`` to the next
peer, ``sp - 1`` hops, each one posted before the fold of the block in
hand so that the transfer overlaps it) while every peer folds each
visiting block into an online softmax (:func:`_block_attend`: running
max and denominator in float32, masked scores at the -1e30 sentinel,
causal masking by global query and key offsets). The backward is an
``autograd.Function`` of its own: it recomputes each block's
probabilities from the saved max and denominator, and sends the K/V
blocks with their dK/dV accumulators the other way round the ring, so
that after ``sp`` hops each accumulator is back with its block's owner.

:func:`allgather_self_attention` is the small-``sp`` schedule: gather
every peer's K/V once and run the dense masked softmax for the local
queries over the whole key sequence, the single-device ``"full"`` path's
operations on a block of its rows. :func:`ring_attention` takes the
global tensors, as the reference's ``shard_map`` form does.

No kernel here: the reference writes none of this in Pallas either.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from sparkdl_torch.ops.flash_attention import NEG_INF
from sparkdl_torch.parallel.collectives import (
    AxisGroup,
    _chunk,
    all_gather,
    axis_group,
    gather_replicated,
    split_replicated,
)
from sparkdl_torch.runtime.mesh import Mesh, current_mesh

__all__ = [
    "ring_self_attention",
    "allgather_self_attention",
    "ring_attention",
]


def _scores(q, k, *, q_offset, k_offset, causal, scale, kv_mask):
    """float32 [B, H, Lq, Lk] scores of one block, masked at -1e30."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        q_pos = q_offset + torch.arange(q.shape[1], device=q.device)
        k_pos = k_offset + torch.arange(k.shape[1], device=q.device)
        s = torch.where((q_pos[:, None] >= k_pos[None, :])[None, None], s,
                        NEG_INF)
    if kv_mask is not None:
        s = torch.where(kv_mask[:, None, None, :].bool(), s, NEG_INF)
    return s


def _block_attend(q, k, v, o, m, l, *, q_offset, k_offset, causal, scale,
                  kv_mask=None):
    """Fold one visiting K/V block into the running (o, m, l).

    q: [B, Lq, H, D]; k, v: [B, Lk, H, D]; o: [B, Lq, H, D] float32,
    unnormalised; m, l: [B, H, Lq] float32 running max and denominator;
    kv_mask: optional [B, Lk] bool, False keys masked out. A block whose
    keys are all masked for a query (a shard in its causal future) adds
    exp(-1e30 - m) = 0 once the row has seen a real key: the ring visits
    a peer's own block first, whose diagonal every query sees.
    """
    s = _scores(q, k, q_offset=q_offset, k_offset=k_offset, causal=causal,
                scale=scale, kv_mask=kv_mask)
    m_new = torch.maximum(m, s.amax(dim=-1))
    correction = torch.exp(m - m_new)
    p = torch.exp(s - m_new[..., None])
    l_new = l * correction + p.sum(dim=-1)
    pv = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    o_new = o * correction.transpose(1, 2)[..., None] + pv
    return o_new, m_new, l_new


def _rotate(tensors, ag: AxisGroup, to: int, frm: int):
    """Post the sends of ``tensors`` to global rank ``to`` and the
    receives of their likes from ``frm``, over ``ag``'s group; returns
    (received buffers, requests)."""
    import torch.distributed as dist

    recv = [torch.empty_like(t) for t in tensors]
    ops = ([dist.P2POp(dist.isend, t.contiguous(), to, ag.group) for t in tensors]
           + [dist.P2POp(dist.irecv, r, frm, ag.group) for r in recv])
    return recv, dist.batch_isend_irecv(ops)


def _wait(requests) -> None:
    for r in requests:
        r.wait()


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, kv_mask, ag, ring, causal, scale):
        # ring: (previous, next) global ranks on the axis, None at size 1
        b, lq, h, d = q.shape
        lk = k.shape[1]
        o = torch.zeros((b, lq, h, d), dtype=torch.float32, device=q.device)
        m = torch.full((b, h, lq), NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros((b, h, lq), dtype=torch.float32, device=q.device)
        block = [k, v] + ([kv_mask.to(torch.uint8)] if kv_mask is not None else [])
        for hop in range(ag.size):
            pending = None
            if hop < ag.size - 1:  # the next block travels while this one folds
                pending = _rotate(block, ag, ring[1], ring[0])
            owner = (ag.index - hop) % ag.size
            o, m, l = _block_attend(
                q, block[0], block[1], o, m, l, q_offset=ag.index * lq,
                k_offset=owner * lk, causal=causal, scale=scale,
                kv_mask=block[2] if kv_mask is not None else None)
            if pending is not None:
                _wait(pending[1])
                block = pending[0]
        out = (o / l.clamp_min(1e-30).transpose(1, 2)[..., None]).to(q.dtype)
        ctx.save_for_backward(q, k, v, kv_mask, out, m, l)
        ctx.ag, ctx.ring, ctx.causal, ctx.scale = ag, ring, causal, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, kv_mask, out, m, l = ctx.saved_tensors
        ag, ring, causal, scale = ctx.ag, ctx.ring, ctx.causal, ctx.scale
        lq, lk = q.shape[1], k.shape[1]
        do = dout.float()
        delta = (do * out.float()).sum(dim=-1).transpose(1, 2)  # [B, H, Lq]
        denom = l.clamp_min(1e-30)[..., None]
        qf = q.float()
        dq = torch.zeros_like(qf)
        block = [k, v] + ([kv_mask.to(torch.uint8)] if kv_mask is not None else [])
        acc = [torch.zeros(k.shape, dtype=torch.float32, device=k.device),
               torch.zeros(v.shape, dtype=torch.float32, device=v.device)]
        # the blocks go the other way round: at hop i this peer holds the
        # block of peer index + i, with that block's dK/dV accumulators
        for hop in range(ag.size):
            pending = None
            if hop < ag.size - 1:
                pending = _rotate(block, ag, ring[0], ring[1])
            owner = (ag.index + hop) % ag.size
            s = _scores(q, block[0], q_offset=ag.index * lq, k_offset=owner * lk,
                        causal=causal, scale=scale,
                        kv_mask=block[2] if kv_mask is not None else None)
            p = torch.exp(s - m[..., None]) / denom
            acc[1] = acc[1] + torch.einsum("bhqk,bqhd->bkhd", p, do)
            dp = torch.einsum("bqhd,bkhd->bhqk", do, block[1].float())
            ds = p * (dp - delta[..., None])
            dq = dq + torch.einsum("bhqk,bkhd->bqhd", ds, block[0].float()) * scale
            acc[0] = acc[0] + torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
            if ag.size > 1:  # the accumulators move on; the last hop takes them home
                moved, reqs = _rotate(acc, ag, ring[0], ring[1])
                _wait(reqs)
                acc = moved
            if pending is not None:
                _wait(pending[1])
                block = pending[0]
        return (dq.to(q.dtype), acc[0].to(k.dtype), acc[1].to(v.dtype),
                None, None, None, None, None)


def _ring_attention_local(q, k, v, kv_mask=None, *, axis_name: str,
                          mesh: "Mesh | None", causal: bool, scale: Optional[float]):
    """The per-peer body: q/k/v are this peer's [B, L/sp, H, D] blocks,
    ``kv_mask`` its [B, L/sp] key mask, which rides the ring with its
    block. The ring's peers are ``mesh.ring_neighbours(axis_name)``."""
    mesh = mesh if mesh is not None else current_mesh()
    ag = axis_group(axis_name, mesh)
    ring = mesh.ring_neighbours(axis_name) if ag.size > 1 else None
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return _RingAttention.apply(q, k, v, kv_mask, ag, ring, causal, scale)


def ring_self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        kv_mask: Optional[torch.Tensor] = None, *,
                        axis_name: str = "sp", causal: bool = False,
                        scale: Optional[float] = None,
                        mesh: "Mesh | None" = None) -> torch.Tensor:
    """Ring attention on this peer's [B, L/sp, H, D] blocks (the sequence
    split contiguously over ``axis_name`` of ``mesh``, default the ambient
    mesh); ``kv_mask``: [B, L/sp] bool, False = a padded key."""
    return _ring_attention_local(q, k, v, kv_mask, axis_name=axis_name, mesh=mesh,
                                 causal=causal, scale=scale)


def allgather_self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             kv_mask: Optional[torch.Tensor] = None, *,
                             axis_name: str = "sp", causal: bool = False,
                             mesh: "Mesh | None" = None) -> torch.Tensor:
    """All-gather attention on this peer's [B, L/sp, H, D] blocks: every
    peer's K/V (and key mask) gathered once, then the dense masked
    softmax of the local queries over the whole key sequence, scaled by
    division and masked with the global causal offsets. Each query row's
    operations are then the single-device ``"full"`` path's, which is
    what makes the two agree bit for bit where the products round the
    same at both row counts (ROADMAP C15). Memory is O(L) gathered keys
    per peer, so the ring stays the long-context schedule."""
    ag = axis_group(axis_name, mesh)
    lq = q.shape[1]
    kg, vg = all_gather(k, ag, 1), all_gather(v, ag, 1)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kg.float()) / math.sqrt(
        q.shape[-1])
    if causal:
        q_pos = ag.index * lq + torch.arange(lq, device=q.device)
        k_pos = torch.arange(kg.shape[1], device=q.device)
        s = torch.where((k_pos[None, :] <= q_pos[:, None])[None, None], s, NEG_INF)
    if kv_mask is not None:
        mg = all_gather(kv_mask.to(torch.uint8), ag, 1).bool()
        s = torch.where(mg[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(vg.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, vg)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mesh: "Mesh | None" = None, *,
                   kv_mask: Optional[torch.Tensor] = None,
                   axis_name: str = "sp", causal: bool = False,
                   scale: Optional[float] = None,
                   batch_axes: Sequence[str] = ("dp", "fsdp")) -> torch.Tensor:
    """Ring attention on global [B, L, H, D] tensors that every rank of
    ``mesh`` holds: each rank takes its batch shard (over ``batch_axes``)
    and its sequence shard (over ``axis_name``), runs the ring, and the
    result is gathered back into the global [B, L, H, D] on every rank.
    ``kv_mask``: optional [B, L] bool. Differentiable: every rank gets the
    whole gradient of the (same) global loss."""
    sp = axis_group(axis_name, mesh)
    batch = axis_group(tuple(batch_axes), mesh)
    parts = [split_replicated(split_replicated(t, batch, 0), sp, 1)
             for t in (q, k, v)]
    mask = None
    if kv_mask is not None:
        mask = _chunk(_chunk(kv_mask, batch, 0), sp, 1)
    out = _ring_attention_local(*parts, mask, axis_name=axis_name, mesh=mesh,
                                causal=causal, scale=scale)
    return gather_replicated(gather_replicated(out, sp, 1), batch, 0)
