"""Decoder-only (GPT-style) language models: the port of
``sparkdl_tpu.models.gpt``'s lockstep generation path.

Same configuration, parameter names (through :func:`gpt_flax_to_torch`
in ``models/convert.py``) and numerics as the JAX module: RoPE or learned
positions, pre-LayerNorm blocks with a tanh-GELU MLP, a weight-tied LM
head with float32 logits, and attention dispatched on
``GPTConfig.attn_impl``:

- ``"full"``: the dense masked softmax (einsum), uncached and cached;
- ``"flash"``: the uncached forward and the cached prefill go through
  ``ops/flash_attention`` (the prefill over the written prefix only, with
  the causal mask offset by the cache position), and with
  ``flash_decode=True`` every single-token cached step goes through
  ``ops/flash_decode``.

The KV cache is a dict of preallocated buffers ``k``/``v``
``[layers, B, max_len, H, D]`` written in place, and ``idx``: a host int
(the number of positions written) on the lockstep path, so no step reads
anything back from the device, or (``init_cache(per_slot=True)``, the
continuous-batching engine of ``serving/continuous.py``) an int32 ``[B]``
tensor on the device, every row at its own depth. A per-slot step writes
its L columns at ``[idx[b], idx[b] + L)`` of each row, dropping the ones
past the buffer, and attends with the dense masked path under a per-row
causal mask. :func:`init_block_pool`, :func:`quantize_kv` and
:func:`dequantize_kv` are the paged pool's storage. ``train=True``
applies ``config.dropout`` at the reference's sites (the embeddings, the
attention probabilities of the uncached ``full`` path, and the attention
and MLP outputs before their residual adds), with masks from an explicit
``torch.Generator`` (``generator=``).

Model parallelism (``parallel/``), as the reference's config asks for it:

- ``"ring"``: the uncached forward's attention over a sequence split
  on the ``sp_axis`` of the mesh, by ``sp_mode``: ``"ring"`` rotates the
  K/V blocks (exact up to float summation order), ``"allgather"``
  gathers them once and runs the ``"full"`` path's operations on the
  local queries. Positions default to the shard's global ones (its
  ``sp`` index times its length, onward), which the ring's causal
  offsets assume; the cached paths run the dense masked path.
  :func:`sp_prefill` runs a prompt so, split over ``sp``, and returns an
  :func:`init_cache`-shaped cache that :func:`generate_from_cache`
  decodes from on every rank.
- ``return_kv=True``: an uncached forward also returns its post-RoPE K/V
  stacked over layers (``{"k", "v", "idx"}``).
- ``num_experts > 0``: every layer with ``layer_idx % moe_every ==
  moe_every - 1`` runs ``parallel.MoEMlpBlock`` (``moe_k``,
  ``moe_capacity_factor``; its experts split over ``ep``) in place of
  the dense MLP, on every path, the graphed ``generate`` included.
- A mesh (``mesh=``, default the ambient ``mesh_context``) whose ``tp``
  axis is larger than 1 builds q/k/v and ``up`` column-parallel and
  ``out_proj`` and ``down`` row-parallel: each rank holds
  ``num_heads/tp`` heads, and its KV cache those heads only.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from sparkdl_torch.models.bert import Dropout
from sparkdl_torch.ops._dispatch import resolve_device
from sparkdl_torch.ops.flash_attention import NEG_INF, flash_attention
from sparkdl_torch.ops.flash_decode import flash_decode
from sparkdl_torch.parallel.collectives import axis_group, gather_replicated
from sparkdl_torch.parallel.expert_parallel import MoEMlpBlock
from sparkdl_torch.parallel.ring_attention import (
    allgather_self_attention,
    ring_self_attention,
)
from sparkdl_torch.parallel.tensor_parallel import dense_pair, shared_input, tp_size
from sparkdl_torch.runtime.mesh import Mesh, current_mesh, mesh_context


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    vocab_size: int = 50257
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_seq_len: int = 1024
    #: "rope" (default) or "learned" (GPT-2-style position table)
    positions: str = "rope"
    rope_base: float = 10000.0
    layer_norm_eps: float = 1e-5
    dropout: float = 0.0
    #: "full" | "flash" (hand-written CUDA kernels) | "ring" (split over
    #: ``sp_axis``: the uncached forward only)
    attn_impl: str = "full"
    #: the ops/flash_decode kernel for the single-token cached step
    flash_decode: bool = False
    sp_axis: str = "sp"
    #: the ring's collective schedule: "ring" (K/V blocks rotate, online
    #: softmax) or "allgather" (K/V gathered once, the full path's ops)
    sp_mode: str = "ring"
    #: 0 = dense MLPs; >0 = mixture of experts on every moe_every-th layer
    num_experts: int = 0
    moe_every: int = 2
    moe_k: int = 2
    moe_capacity_factor: float = 2.0
    dtype: Any = torch.float32

    def __post_init__(self):
        if self.sp_mode not in ("ring", "allgather"):
            raise ValueError(
                f"unknown sp_mode {self.sp_mode!r}: expected 'ring' or "
                "'allgather'"
            )

    @classmethod
    def tiny(cls, **kw) -> "GPTConfig":
        """Test-sized config (oracle/unit tests)."""
        defaults = dict(
            vocab_size=128, hidden_size=32, num_layers=2, num_heads=2,
            intermediate_size=64, max_seq_len=64, dropout=0.0,
        )
        defaults.update(kw)
        return cls(**defaults)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               base: float = 10000.0) -> torch.Tensor:
    """Rotary position embedding. x: [B, L, H, D]; positions: [B, L]."""
    half = x.shape[-1] // 2
    freqs = base ** (-torch.arange(half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions[:, :, None].to(torch.float32) * freqs  # [B, L, half]
    cos = torch.cos(ang)[:, :, None, :].to(x.dtype)
    sin = torch.sin(ang)[:, :, None, :].to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def init_cache(config: GPTConfig, batch: int, max_len: int,
               per_slot: bool = False, *, device="cuda",
               num_heads: Optional[int] = None) -> dict:
    """Zeroed KV cache for :func:`generate` / incremental decode:
    ``k``/``v`` ``[num_layers, B, max_len, H, D]`` on ``device`` and
    ``idx``, the number of positions written: a host int 0, or with
    ``per_slot=True`` an int32 ``[B]`` tensor of zeros on ``device``
    (continuous batching: every row, a serving slot, decodes at its own
    depth). Forward calls write their keys/values in place and advance
    ``idx`` (the tensor in place). ``num_heads``: the heads a rank
    holds, ``config.num_heads / tp`` under tensor parallelism
    (``GPTLMHeadModel.local_heads``); default all of them."""
    hd = config.hidden_size // config.num_heads
    heads = config.num_heads if num_heads is None else num_heads
    shape = (config.num_layers, batch, max_len, heads, hd)
    dev = resolve_device(device)
    return {
        "k": torch.zeros(shape, dtype=config.dtype, device=dev),
        "v": torch.zeros(shape, dtype=config.dtype, device=dev),
        "idx": (torch.zeros((batch,), dtype=torch.int32, device=dev)
                if per_slot else 0),
    }


#: the paged pool's compressed storage layouts (``serving.kv_blocks``)
_POOL_STORE = {"bf16": torch.bfloat16, "int8": torch.int8}


def init_block_pool(config: GPTConfig, n_blocks: int, block_size: int,
                    dtype: str = "fp32", *, device="cuda") -> dict:
    """Zeroed block-paged KV pool for continuous serving: ``k``/``v``
    ``[num_layers, n_blocks, block_size, H, D]`` on ``device``, shared by
    every slot through per-slot block tables (the bookkeeping lives in
    ``serving.kv_blocks.KVBlockPool``).

    ``dtype`` is the storage layout: ``"fp32"`` stores at the model's
    compute dtype (``config.dtype``); ``"bf16"`` stores bfloat16;
    ``"int8"`` stores int8 codes plus one float32 scale per written
    column (``k_scale``/``v_scale``, ``[num_layers, n_blocks,
    block_size]``; :func:`quantize_kv`). Compute always runs at
    ``config.dtype``: only the resident pool is compressed."""
    hd = config.hidden_size // config.num_heads
    shape = (config.num_layers, n_blocks, block_size, config.num_heads, hd)
    if dtype == "fp32":
        store = config.dtype
    elif dtype in _POOL_STORE:
        store = _POOL_STORE[dtype]
    else:
        raise ValueError(
            f"unknown KV pool dtype {dtype!r} (fp32 | bf16 | int8)")
    dev = resolve_device(device)
    pool = {"k": torch.zeros(shape, dtype=store, device=dev),
            "v": torch.zeros(shape, dtype=store, device=dev)}
    if dtype == "int8":
        pool["k_scale"] = torch.zeros(shape[:3], dtype=torch.float32,
                                      device=dev)
        pool["v_scale"] = torch.zeros(shape[:3], dtype=torch.float32,
                                      device=dev)
    return pool


def quantize_kv(x: torch.Tensor) -> "tuple[torch.Tensor, torch.Tensor]":
    """Symmetric per-column int8 quantization of K/V columns ``[..., H,
    D]``: returns (int8 codes, float32 scales ``[...]``). The absmax maps
    to ±127, so quantizing a dequantized column gives back the same codes
    and scale (a copy-on-write block re-installs bit-identical to its
    donor); ``torch.round`` rounds half to even, as the reference's
    ``jnp.round`` does. Zero columns get a tiny floor scale."""
    amax = x.abs().amax(dim=(-2, -1))
    scale = (amax.clamp_min(1e-30) / 127.0).to(torch.float32)
    q = torch.round(x.to(torch.float32) / scale[..., None, None])
    return q.clamp(-127, 127).to(torch.int8), scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                  dtype=torch.float32) -> torch.Tensor:
    """Inverse of :func:`quantize_kv`: int8 ``[..., H, D]`` columns and
    their per-column scales back to ``dtype``."""
    return (q.to(torch.float32) * scale[..., None, None]).to(dtype)


def write_columns(buf: torch.Tensor, new: torch.Tensor,
                  idx: torch.Tensor) -> None:
    """Per-row in-place write of ``new`` [B, L, ...] at columns ``[idx[b],
    idx[b] + L)`` of ``buf`` [B, W, ...], dropping the columns at or past
    W (the reference's ``mode="drop"`` scatter: a torch index out of
    range is a device-side assert on CUDA). A dropped column is written
    back with the value it holds: its index is taken modulo W, which
    keeps a row's L targets distinct (L <= W), so every column of the
    write is touched once and only the kept ones change."""
    b, l = new.shape[:2]
    w = buf.shape[1]
    if l > w:
        raise ValueError(f"{l} new columns do not fit a buffer of {w}")
    cols = idx.to(torch.long)[:, None] + torch.arange(l, device=buf.device)
    keep = (cols < w).view(b, l, *([1] * (new.dim() - 2)))
    cols = cols % w
    rows = torch.arange(b, device=buf.device)[:, None].expand(b, l)
    buf[rows, cols] = torch.where(keep, new.to(buf.dtype), buf[rows, cols])


def _default_positions(idx, b: int, l: int, device) -> torch.Tensor:
    """[B, L] positions counting from the cache depth: a host int shared
    by every row, or each row's own (a per-slot ``[B]`` tensor)."""
    ar = torch.arange(l, device=device)
    if isinstance(idx, torch.Tensor):
        return idx.to(torch.long)[:, None] + ar[None, :]
    return (idx + ar).expand(b, l)


def first_valid_column(key_valid: torch.Tensor) -> torch.Tensor:
    """int32 [B]: each row's first True column of a left-padded [B, L]
    key-validity mask (the ``start`` of ``ops/flash_decode``)."""
    return torch.argmax(key_valid.to(torch.int32), dim=1).to(torch.int32)


def _dense_attention(q, k, v, keep, dropout=None):
    """softmax(q·kᵀ/√D) over [B, L, H, D] with ``keep`` broadcast to
    [B, H, Lq, Lk]; masked scores are the -1e30 sentinel. ``dropout``,
    where given, is applied to the probabilities."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(
        q.shape[-1])
    s = torch.where(keep, s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    if dropout is not None:
        p = dropout(p)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def _ring_positions(mesh, axis: str, b: int, l: int, device) -> torch.Tensor:
    """[B, L] global positions of this rank's shard of a sequence split
    contiguously over ``axis``."""
    ag = axis_group(axis, mesh)
    return (ag.index * l + torch.arange(l, device=device)).expand(b, l)


class GPTAttention(nn.Module):
    def __init__(self, config: GPTConfig, layer_idx: int, device=None,
                 mesh: "Mesh | None" = None):
        super().__init__()
        self.config = config
        self.layer_idx = layer_idx
        self.mesh = mesh
        h = config.hidden_size
        self.heads = config.num_heads // tp_size(mesh)
        column, row = dense_pair(mesh, device=device, dtype=config.dtype)
        # q, k and v read one input: one gradient all-reduce for the three
        self.q_proj = column(h, h, copy_input=False)
        self.k_proj = column(h, h, copy_input=False)
        self.v_proj = column(h, h, copy_input=False)
        self.out_proj = row(h, h)
        self.dropout = Dropout(config.dropout)

    def qkv(self, x, positions: Optional[torch.Tensor] = None, idx=0):
        """q, k, v ``[B, L, heads, D]`` of ``x``; under RoPE rotated at
        ``positions`` [B, L] (default: counting from the cache depth
        ``idx``)."""
        c = self.config
        nh = self.heads
        hd = c.hidden_size // c.num_heads
        b, l = x.shape[0], x.shape[1]
        xs = shared_input(x, self.q_proj)
        q, k, v = (p(xs).view(b, l, nh, hd)
                   for p in (self.q_proj, self.k_proj, self.v_proj))
        if c.positions == "rope":
            if positions is None:
                positions = _default_positions(idx, b, l, x.device)
            q = apply_rope(q, positions, c.rope_base)
            k = apply_rope(k, positions, c.rope_base)
        return q, k, v

    @staticmethod
    def attend_rows(q, ck, cv, q_pos, attention_mask=None):
        """The dense masked path with a per-row causal mask: queries ``q``
        [B, L, heads, D] at buffer columns ``q_pos`` [B, L] attend over
        every column of ``ck``/``cv`` [B, W, heads, D] at or before their
        own (``attention_mask`` [B, W]: False = masked)."""
        k_pos = torch.arange(ck.shape[1], device=q.device)
        keep = (k_pos[None, None, :] <= q_pos[:, :, None])[:, None]
        if attention_mask is not None:
            keep = keep & attention_mask[:, None, None, :]
        return _dense_attention(q, ck, cv, keep)

    def forward(self, x, *, cache: Optional[dict] = None,
                positions: Optional[torch.Tensor] = None,
                attention_mask: Optional[torch.Tensor] = None,
                start: Optional[torch.Tensor] = None,
                kv_sink: Optional[list] = None,
                train: bool = False, generator=None):
        c = self.config
        nh = self.heads
        hd = c.hidden_size // c.num_heads
        b, l = x.shape[0], x.shape[1]
        idx = cache["idx"] if cache is not None else 0
        per_slot = isinstance(idx, torch.Tensor)
        q, k, v = self.qkv(x, positions, idx)

        if per_slot:
            # every row at its own depth: write this call's L columns at
            # [idx[b], idx[b] + L) (past the buffer: dropped), then the
            # dense masked path with a per-row causal mask; L=1 decodes,
            # L=k verifies a speculative span
            ck, cv = cache["k"][self.layer_idx], cache["v"][self.layer_idx]
            write_columns(ck, k, idx)
            write_columns(cv, v, idx)
            q_pos = idx.to(torch.long)[:, None] + torch.arange(
                l, device=x.device)
            ctx = self.attend_rows(q, ck, cv, q_pos, attention_mask)
        elif cache is not None:
            ck, cv = cache["k"][self.layer_idx], cache["v"][self.layer_idx]
            max_len = ck.shape[1]
            if idx + l > max_len:
                raise ValueError(
                    f"KV cache overflow: idx {idx} + {l} new tokens > cache "
                    f"max_len {max_len}"
                )
            # in place: the step writes only its own L columns
            ck[:, idx:idx + l] = k.to(c.dtype)
            cv[:, idx:idx + l] = v.to(c.dtype)
            if c.attn_impl == "flash" and l == 1 and c.flash_decode:
                ctx = flash_decode(q, ck, cv, idx, start=start)
            elif c.attn_impl == "flash" and l > 1:
                # prefill over the written prefix only; queries sit at
                # global positions [idx, idx + L)
                end = idx + l
                kv_mask = (attention_mask[:, :end]
                           if attention_mask is not None else None)
                ctx = flash_attention(q, ck[:, :end], cv[:, :end], kv_mask,
                                      causal=True, q_offset=idx)
            else:
                q_pos = idx + torch.arange(l, device=x.device)
                k_pos = torch.arange(max_len, device=x.device)
                keep = (k_pos[None, :] <= q_pos[:, None])[None, None]
                if attention_mask is not None:
                    keep = keep & attention_mask[:, None, None, :]
                ctx = _dense_attention(q, ck, cv, keep)
        else:
            if kv_sink is not None:  # return_kv: this call's post-RoPE K/V
                kv_sink.append((k.to(c.dtype), v.to(c.dtype)))
            if attention_mask is not None and c.attn_impl != "full":
                raise ValueError(
                    "attention_mask on the uncached forward requires "
                    f"attn_impl='full' (got {c.attn_impl!r}); the flash/"
                    "ring kernels take ragged batches only through the "
                    "KV-cached generate() path"
                )
            if c.attn_impl == "flash":
                ctx = flash_attention(q, k, v, causal=True)
            elif c.attn_impl == "ring":
                attend = (allgather_self_attention if c.sp_mode == "allgather"
                          else ring_self_attention)
                ctx = attend(q, k, v, axis_name=c.sp_axis, causal=True,
                             mesh=self.mesh)
            else:
                keep = torch.ones((l, l), dtype=torch.bool,
                                  device=x.device).tril()[None, None]
                if attention_mask is not None:
                    keep = keep & attention_mask[:, None, None, :].bool()
                ctx = _dense_attention(q, k, v, keep, lambda p: self.dropout(
                    p, train=train, generator=generator))
        return self.out_proj(ctx.reshape(b, l, nh * hd))


class GPTBlock(nn.Module):
    def __init__(self, config: GPTConfig, layer_idx: int, device=None,
                 mesh: "Mesh | None" = None):
        super().__init__()
        c = config
        kw = dict(device=device, dtype=c.dtype)
        self.ln_1 = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps, **kw)
        self.attn = GPTAttention(c, layer_idx, device=device, mesh=mesh)
        self.ln_2 = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps, **kw)
        if c.num_experts > 0 and layer_idx % c.moe_every == c.moe_every - 1:
            self.moe_mlp = MoEMlpBlock(
                c.hidden_size, c.num_experts, c.intermediate_size, k=c.moe_k,
                capacity_factor=c.moe_capacity_factor, mesh=mesh, **kw)
        else:
            column, row = dense_pair(mesh, device=device, dtype=c.dtype)
            self.up = column(c.hidden_size, c.intermediate_size)
            self.down = row(c.intermediate_size, c.hidden_size)
        self.dropout = Dropout(c.dropout)

    def mlp(self, h):
        """The block's feed-forward half on ``ln_2``'s output."""
        if hasattr(self, "moe_mlp"):
            return self.moe_mlp(h)
        return self.down(F.gelu(self.up(h), approximate="tanh"))

    @staticmethod
    def forward_shards(blocks, xs, attend, *, train: bool = False,
                       generator=None):
        """The block's residual structure over row shards: ``xs[s]``
        through ``blocks[s]`` (one layer, a module per shard's device).
        ``attend`` maps the shards' ``ln_1`` outputs to their attention
        outputs (``out_proj`` applied) all at once, so K/V can pass
        between shards."""
        drop = dict(train=train, generator=generator)
        hs = attend([blk.ln_1(x) for blk, x in zip(blocks, xs)])
        xs = [x + blk.dropout(h, **drop) for blk, x, h in zip(blocks, xs, hs)]
        return [x + blk.dropout(blk.mlp(blk.ln_2(x)), **drop)
                for blk, x in zip(blocks, xs)]

    def forward(self, x, *, train: bool = False, generator=None, **attn_kw):
        drop = dict(train=train, generator=generator)
        return self.forward_shards(
            [self], [x], lambda hs: [self.attn(hs[0], **drop, **attn_kw)],
            **drop)[0]


class GPTLMHeadModel(nn.Module):
    """Decoder LM. ``forward(input_ids, cache=None)`` -> (logits, cache).

    Without a cache: the full causal forward. With a cache from
    :func:`init_cache`: writes K/V at ``cache['idx']`` in place, advances
    ``idx`` and returns the same cache. A per-slot cache (``idx`` a [B]
    tensor) decodes every row at its own depth, always on the dense
    masked path, whatever ``attn_impl`` says. ``positions``: optional [B, L]
    token positions (RoPE or the learned table); under ``attn_impl="ring"``
    the uncached forward defaults them to the shard's global positions.
    ``attention_mask``: optional key validity (False = masked), [B, L] on
    the uncached forward, [B, max_len] over buffer columns on the cached
    path. ``return_kv=True`` on the uncached forward returns, in place of
    the (absent) cache, ``{"k", "v"}`` ``[layers, B, L, H, D]`` (the
    post-RoPE keys and values of this call's tokens) and ``"idx"``: L.
    ``mesh`` (default the ambient ``mesh_context``) is where the ring and
    the tensor- and expert-parallel layers find their axes.
    Parameters are created on ``device`` with torch's default init; use
    :func:`init_gpt_` for Flax's, or load a converted state dict (a
    rank's slice of one under a mesh: ``convert.shard_state_dict``).
    """

    def __init__(self, config: GPTConfig, *, device="cuda",
                 mesh: "Mesh | None" = None):
        super().__init__()
        if config.attn_impl not in ("full", "flash", "ring"):
            raise ValueError(f"unknown attn_impl {config.attn_impl!r}")
        mesh = mesh if mesh is not None else current_mesh()
        tp = tp_size(mesh)
        if config.num_heads % tp:
            raise ValueError(
                f"num_heads {config.num_heads} is not divisible by the "
                f"{tp}-way tp axis")
        dev = resolve_device(device)
        c = config
        kw = dict(device=dev, dtype=c.dtype)
        self.config = c
        self.mesh = mesh
        #: the attention heads this rank holds (all of them unless tp > 1)
        self.local_heads = c.num_heads // tp
        self.wte = nn.Embedding(c.vocab_size, c.hidden_size, **kw)
        self.wpe = (nn.Embedding(c.max_seq_len, c.hidden_size, **kw)
                    if c.positions == "learned" else None)
        self.h = nn.ModuleList(GPTBlock(c, i, device=dev, mesh=mesh)
                               for i in range(c.num_layers))
        self.ln_f = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps, **kw)
        self.dropout = Dropout(c.dropout)

    def embed(self, input_ids, positions=None):
        """Token embeddings plus, with the learned table, those of
        ``positions`` [B, L]."""
        x = self.wte(input_ids)
        if self.wpe is not None:
            x = x + self.wpe(positions)
        return x

    def lm_head(self, x):
        """Float32 logits of the last block's output: ``ln_f``, then the
        weight-tied head."""
        return F.linear(self.ln_f(x), self.wte.weight).float()

    def forward(self, input_ids, *, cache: Optional[dict] = None,
                positions: Optional[torch.Tensor] = None,
                attention_mask: Optional[torch.Tensor] = None,
                return_kv: bool = False, train: bool = False,
                generator: "torch.Generator | None" = None):
        c = self.config
        b, l = input_ids.shape
        if positions is None and cache is None and c.attn_impl == "ring":
            positions = _ring_positions(self.mesh, c.sp_axis, b, l,
                                        input_ids.device)
        pos = positions
        if self.wpe is not None:
            idx = cache["idx"] if cache is not None else 0
            if pos is None:
                pos = _default_positions(idx, b, l, input_ids.device)
            if isinstance(idx, torch.Tensor):
                # per-slot: an idle row's position may run past the table
                # (the reference's gather fills it; here it is clamped).
                # Admission keeps every live row inside it.
                pos = pos.clamp(0, c.max_seq_len - 1)
        x = self.embed(input_ids, pos)

        start = None
        if (cache is not None and l == 1 and c.attn_impl == "flash"
                and c.flash_decode and attention_mask is not None
                and not isinstance(cache["idx"], torch.Tensor)):
            start = cache.get("start")
            if start is None:
                start = first_valid_column(attention_mask)
        kv_sink = [] if return_kv and cache is None else None
        x = self.dropout(x, train=train, generator=generator)
        for blk in self.h:
            x = blk(x, cache=cache, positions=positions,
                    attention_mask=attention_mask, start=start,
                    kv_sink=kv_sink, train=train, generator=generator)
        logits = self.lm_head(x)
        if cache is not None:
            cache["idx"] += l
        elif kv_sink is not None:
            cache = {"k": torch.stack([kv[0] for kv in kv_sink]),
                     "v": torch.stack([kv[1] for kv in kv_sink]), "idx": l}
        return logits, cache


def init_gpt_(module: GPTLMHeadModel, seed: int = 0) -> GPTLMHeadModel:
    """Flax's default initialisation, from a seeded CPU generator (so the
    weights do not depend on the device): lecun-normal dense kernels and
    expert stacks, zero biases, LayerNorm scale 1 and bias 0, and
    ``nn.Embed``'s N(0, 1/hidden) for the token and position tables."""
    from sparkdl_torch.models.common import lecun_normal_

    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, nn.Linear):
                w = torch.empty(m.weight.shape, dtype=torch.float32)
                m.weight.copy_(lecun_normal_(w, g))
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, MoEMlpBlock):
                # stacked [E, in, out] kernels: flax's fan-in counts the
                # expert dim as receptive field, in * E
                for w in (m.wi, m.wo):
                    std = math.sqrt(1.0 / (w.shape[1] * m.num_experts)) / 0.87962566103423978
                    t = torch.empty(w.shape, dtype=torch.float32)
                    nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std, generator=g)
                    w.copy_(t)
            elif isinstance(m, nn.LayerNorm):
                m.reset_parameters()
            elif isinstance(m, nn.Embedding):
                w = torch.empty(m.weight.shape, dtype=torch.float32)
                w.normal_(0.0, math.sqrt(1.0 / m.embedding_dim), generator=g)
                m.weight.copy_(w)
    return module


# ---------------------------------------------------------------------------
# HuggingFace GPT-2 weights (a torch module, duck-typed) -> this module
# ---------------------------------------------------------------------------

def config_from_hf_gpt2(hf_config) -> GPTConfig:
    """GPTConfig reproducing an HF ``GPT2Config`` (learned positions,
    tanh-gelu MLP). Variants this forward cannot reproduce are rejected
    rather than silently diverging."""
    act = getattr(hf_config, "activation_function", "gelu_new")
    if act not in ("gelu_new", "gelu_pytorch_tanh"):
        raise ValueError(
            f"unsupported GPT-2 activation {act!r}: this forward uses "
            "tanh-gelu (gelu_new)"
        )
    if not getattr(hf_config, "scale_attn_weights", True) or getattr(
        hf_config, "scale_attn_by_inverse_layer_idx", False
    ):
        raise ValueError(
            "unsupported GPT-2 attention scaling variant (requires "
            "scale_attn_weights=True, scale_attn_by_inverse_layer_idx=False)"
        )
    return GPTConfig(
        vocab_size=hf_config.vocab_size,
        hidden_size=hf_config.n_embd,
        num_layers=hf_config.n_layer,
        num_heads=hf_config.n_head,
        intermediate_size=hf_config.n_inner or 4 * hf_config.n_embd,
        max_seq_len=hf_config.n_positions,
        positions="learned",
        layer_norm_eps=hf_config.layer_norm_epsilon,
        dropout=0.0,
    )


def load_hf_gpt2(hf_model) -> "tuple[GPTConfig, dict]":
    """An HF ``GPT2Model``/``GPT2LMHeadModel`` (torch; duck-typed, no
    ``transformers`` import) -> (config, state dict for
    :class:`GPTLMHeadModel`), float32 on the CPU. GPT-2's Conv1D stores
    weights [in, out]: they are transposed to ``nn.Linear``'s [out, in],
    and the fused c_attn splits into q/k/v."""
    base = getattr(hf_model, "transformer", hf_model)  # LMHead or bare
    cfg = config_from_hf_gpt2(base.config)
    e = cfg.hidden_size

    def t(x):
        return x.detach().to("cpu", torch.float32).contiguous().clone()

    sd = {"wte.weight": t(base.wte.weight), "wpe.weight": t(base.wpe.weight),
          "ln_f.weight": t(base.ln_f.weight), "ln_f.bias": t(base.ln_f.bias)}
    for i, blk in enumerate(base.h):
        p = f"h.{i}."
        for ln in ("ln_1", "ln_2"):
            sd[p + ln + ".weight"] = t(getattr(blk, ln).weight)
            sd[p + ln + ".bias"] = t(getattr(blk, ln).bias)
        w, bias = blk.attn.c_attn.weight, blk.attn.c_attn.bias  # [E, 3E]
        for j, name in enumerate(("q_proj", "k_proj", "v_proj")):
            sd[f"{p}attn.{name}.weight"] = t(w[:, j * e:(j + 1) * e].T)
            sd[f"{p}attn.{name}.bias"] = t(bias[j * e:(j + 1) * e])
        for name, conv in (("attn.out_proj", blk.attn.c_proj),
                           ("up", blk.mlp.c_fc), ("down", blk.mlp.c_proj)):
            sd[f"{p}{name}.weight"] = t(conv.weight.T)
            sd[f"{p}{name}.bias"] = t(conv.bias)
    return cfg, sd


# ---------------------------------------------------------------------------
# sampling and generation
# ---------------------------------------------------------------------------

def sample_logits(logits: torch.Tensor, generator=None, *,
                  temperature: float, top_k: "int | None" = None,
                  top_p: "float | None" = None) -> torch.Tensor:
    """One sampling step over [B, V] logits.

    temperature 0 = greedy (top_k/top_p ignored); otherwise temperature
    scaling, then optional top-k truncation, then optional top-p
    (nucleus) truncation, then a Gumbel-max draw from ``generator`` (a
    ``torch.Generator`` on the logits' device).
    """
    if temperature <= 0:
        return torch.argmax(logits, dim=-1)
    logits = logits / temperature
    if top_k is not None:
        if top_k < 1:
            raise ValueError(f"top_k must be >= 1, got {top_k}")
        # top_k beyond the vocab keeps everything
        top_k = min(top_k, logits.shape[-1])
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, NEG_INF, logits)
    if top_p is not None:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        csum = torch.cumsum(probs, dim=-1)
        # keep every token whose preceding cumulative mass is < top_p
        # (the first token is always kept)
        keep = csum - probs < top_p
        cutoff = torch.where(keep, sorted_logits, math.inf).min(
            dim=-1, keepdim=True).values
        logits = torch.where(logits < cutoff, NEG_INF, logits)
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


def check_generate_args(config: GPTConfig, prompt_shape, max_new_tokens: int,
                        *, temperature: float = 0.0,
                        top_k: Optional[int] = None,
                        top_p: Optional[float] = None,
                        generator: Optional[torch.Generator] = None,
                        max_len: Optional[int] = None) -> int:
    """The checks :func:`generate` makes of its host arguments (shapes and
    settings; no tensor is read). Returns the cache length ``max_len``
    resolves to."""
    lp = prompt_shape[1]
    if max_new_tokens < 0:
        raise ValueError(f"max_new_tokens must be >= 0, got {max_new_tokens}")
    if max_len is None:
        max_len = lp + max_new_tokens
    elif max_len < lp + max_new_tokens:
        raise ValueError(
            f"max_len={max_len} < prompt_len {lp} + max_new_tokens "
            f"{max_new_tokens}: cache writes would overflow"
        )
    if (config.positions == "learned"
            and lp + max_new_tokens > config.max_seq_len):
        raise ValueError(
            f"prompt_len {lp} + max_new_tokens {max_new_tokens} exceeds the "
            f"learned position table (max_seq_len={config.max_seq_len})"
        )
    if temperature > 0 and generator is None:
        raise ValueError("sampling (temperature>0) requires a generator")
    if temperature <= 0 and (top_k is not None or top_p is not None):
        raise ValueError(
            "top_k/top_p only apply when sampling (temperature > 0)"
        )
    if top_k is not None and top_k < 1:
        raise ValueError(f"top_k must be >= 1, got {top_k}")
    if top_p is not None and not (0.0 < top_p <= 1.0):
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")
    return max_len


@torch.inference_mode()
def generate(
    model: GPTLMHeadModel,
    prompt_ids: torch.Tensor,
    max_new_tokens: int,
    *,
    temperature: float = 0.0,
    top_k: Optional[int] = None,
    top_p: Optional[float] = None,
    generator: Optional[torch.Generator] = None,
    max_len: Optional[int] = None,
    attention_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Autoregressive decode: prefill the prompt, then one cached forward
    per further token. Returns [B, prompt_len + max_new_tokens] ids.

    temperature 0 = greedy; >0 = sampled from ``generator`` (required),
    with optional ``top_k`` / ``top_p`` truncation. ``attention_mask``
    ([B, prompt_len], 1 = real token) decodes LEFT-padded unequal-length
    prompts together: pad columns are excluded from every softmax and
    positions count real tokens only, so under greedy decoding row b
    equals the unbatched generation of its unpadded prompt. Output rows
    keep their left pads.

    The last token needs no forward of its own, so this runs
    ``max_new_tokens - 1`` decode forwards after the prefill. The cache
    position is a host int: the loop never waits for the device. This is
    the eager loop, one host launch per op; ``DeepTextGenerator`` runs the
    same calls as one CUDA graph per bucket on the card.
    """
    b, lp = prompt_ids.shape
    max_len = check_generate_args(
        model.config, prompt_ids.shape, max_new_tokens,
        temperature=temperature, top_k=top_k, top_p=top_p,
        generator=generator, max_len=max_len)
    mask = None
    if attention_mask is not None:
        if tuple(attention_mask.shape) != (b, lp):
            raise ValueError(
                f"attention_mask shape {tuple(attention_mask.shape)} != "
                f"prompt shape {(b, lp)}"
            )
        mask = attention_mask.to(device=prompt_ids.device, dtype=torch.bool)
        if not bool((mask[:, 1:] >= mask[:, :-1]).all()):
            raise ValueError(
                "attention_mask must be left-padded (each row 0...01...1); "
                "right-padded prompts cannot share a sampling column"
            )
        if not bool(mask[:, -1].all()):
            raise ValueError("every row needs at least one real token")
    return generate_unchecked(
        model, prompt_ids, max_new_tokens, max_len, attention_mask=mask,
        temperature=temperature, top_k=top_k, top_p=top_p,
        generator=generator)


def generate_unchecked(model: GPTLMHeadModel, prompt_ids: torch.Tensor,
                       max_new_tokens: int, max_len: int, *,
                       attention_mask: Optional[torch.Tensor] = None,
                       temperature: float = 0.0,
                       top_k: Optional[int] = None,
                       top_p: Optional[float] = None,
                       generator: Optional[torch.Generator] = None
                       ) -> torch.Tensor:
    """The device work of :func:`generate`, after its checks: no host
    read of any tensor, so it can be captured in a CUDA graph (the KV
    cache is allocated inside, from the graph's pool). ``attention_mask``
    must be a left-padded bool [B, prompt_len] on the prompt's device,
    with a real last column (:func:`generate` checks that on the host)."""
    b, lp = prompt_ids.shape
    dev = prompt_ids.device
    positions = key_valid = pad_len = None
    if attention_mask is not None:
        pad_len = lp - attention_mask.sum(dim=1)  # [B]
        # logical positions: pads clamp to 0 (masked out of attention)
        positions = (attention_mask.cumsum(dim=1) - 1).clamp_min(0)
        # buffer-column validity for the whole generation
        key_valid = torch.cat(
            [attention_mask,
             torch.ones((b, max_len - lp), dtype=torch.bool, device=dev)],
            dim=1)
    if max_new_tokens == 0:
        return prompt_ids.clone()

    def sample(logits):
        return sample_logits(logits, generator, temperature=temperature,
                             top_k=top_k, top_p=top_p)

    cache = init_cache(model.config, b, max_len, device=dev,
                       num_heads=model.local_heads)
    if key_valid is not None:
        cache["start"] = first_valid_column(key_valid)
    logits, cache = model(prompt_ids, cache=cache, positions=positions,
                          attention_mask=key_valid)
    new = _decode(model, logits[:, -1], cache, max_new_tokens, sample,
                  key_valid=key_valid, pad_len=pad_len)
    return torch.cat([prompt_ids, new.to(prompt_ids.dtype)], dim=1)


def _decode(model: GPTLMHeadModel, last_logits: torch.Tensor, cache: dict,
            max_new_tokens: int, sample, *, key_valid=None,
            pad_len=None) -> torch.Tensor:
    """[B, max_new_tokens] tokens sampled from ``last_logits`` [B, V] and
    then from one cached forward per further token."""
    toks = [sample(last_logits)]
    for _ in range(max_new_tokens - 1):
        pos = None if pad_len is None else (cache["idx"] - pad_len)[:, None]
        logits, cache = model(toks[-1][:, None], cache=cache, positions=pos,
                              attention_mask=key_valid)
        toks.append(sample(logits[:, -1]))
    return torch.stack(toks, dim=1)


@torch.inference_mode()
def generate_from_cache(model: GPTLMHeadModel, logits: torch.Tensor,
                        cache: dict, max_new_tokens: int, *,
                        temperature: float = 0.0, top_k: Optional[int] = None,
                        top_p: Optional[float] = None,
                        generator: Optional[torch.Generator] = None
                        ) -> torch.Tensor:
    """Decode ``max_new_tokens`` from a prefilled lockstep cache: the
    prefill's ``logits`` [B, L, V] (the last column seeds the first
    token) and its :func:`init_cache`-shaped ``cache`` (``idx`` = L), as
    :func:`sp_prefill` returns them. The cache is copied into buffers of
    ``L + max_new_tokens`` columns first where it has fewer. Returns the
    [B, max_new_tokens] new tokens, :func:`generate`'s continuation of the
    same prompt."""
    check_generate_args(model.config, (logits.shape[0], int(cache["idx"])),
                        max_new_tokens, temperature=temperature, top_k=top_k,
                        top_p=top_p, generator=generator)
    if max_new_tokens == 0:
        return logits.new_zeros((logits.shape[0], 0), dtype=torch.long)
    idx = int(cache["idx"])
    need = idx + max_new_tokens - 1
    if cache["k"].shape[2] < need:
        grown = init_cache(model.config, cache["k"].shape[1], need,
                           device=cache["k"].device, num_heads=cache["k"].shape[3])
        grown["k"][:, :, :idx] = cache["k"][:, :, :idx]
        grown["v"][:, :, :idx] = cache["v"][:, :, :idx]
        cache = grown
    else:
        cache = dict(cache)
    cache["idx"] = idx

    def sample(last):
        return sample_logits(last, generator, temperature=temperature,
                             top_k=top_k, top_p=top_p)

    return _decode(model, logits[:, -1], cache, max_new_tokens, sample)


@torch.no_grad()
def sp_prefill(model: GPTLMHeadModel, prompt_ids: torch.Tensor,
               mesh: "Mesh | None" = None) -> "tuple[torch.Tensor, dict]":
    """Sequence-parallel prompt prefill: the prompt's TOKENS split
    contiguously over the ``sp`` axis of ``mesh`` (default the ambient
    one), every rank running one uncached forward of its shard at its
    global positions with ``return_kv=True``, attention by
    ``config.sp_mode`` (``"ring"``: exact up to float summation order;
    ``"allgather"``: the ``"full"`` path's operations on each query
    shard). Every rank of the axis calls it with the whole prompt.

    Requires ``config.attn_impl == "ring"``. A prompt whose length ``sp``
    does not divide is right-padded first: the pad keys sit causally after
    every real query, so they stay invisible without a mask, and the pad
    positions are cut from what comes back. Returns ``(logits [B, L, V],
    cache)``, both gathered on every rank: ``cache`` is
    :func:`init_cache`-shaped (``k``/``v`` ``[layers, B, L, H, D]``,
    ``idx = L``), ready for :func:`generate_from_cache`. A one-shot call:
    it is not captured in a CUDA graph.
    """
    c = model.config
    if c.attn_impl != "ring":
        raise ValueError(
            f"sp_prefill requires attn_impl='ring' (sp_mode="
            f"'ring'|'allgather'), got attn_impl={c.attn_impl!r}")
    mesh = mesh if mesh is not None else (
        model.mesh if model.mesh is not None else current_mesh())
    ag = axis_group(c.sp_axis, mesh)
    b, l = prompt_ids.shape
    pad = (-l) % ag.size
    lpad = l + pad
    if c.positions == "learned" and lpad > c.max_seq_len:
        raise ValueError(
            f"prompt_len {l} (padded to {lpad} for sp={ag.size}) exceeds the "
            f"learned position table (max_seq_len={c.max_seq_len})")
    ids = F.pad(prompt_ids, (0, pad))
    n = lpad // ag.size
    mine = ids[:, ag.index * n:(ag.index + 1) * n]
    positions = (ag.index * n + torch.arange(n, device=ids.device)).expand(b, n)
    with mesh_context(mesh):
        logits, kv = model(mine, positions=positions, return_kv=True)
    logits = gather_replicated(logits, ag, 1)[:, :l]
    cache = {"k": gather_replicated(kv["k"], ag, 2)[:, :, :l].contiguous(),
             "v": gather_replicated(kv["v"], ag, 2)[:, :, :l].contiguous(),
             "idx": l}
    return logits, cache
