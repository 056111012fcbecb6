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
``[layers, B, max_len, H, D]`` written in place, and a host int ``idx``
(the number of positions written), so no step reads anything back from
the device. The forward is the JAX module's deterministic one
(``train=False``): dropout belongs to training, which is not ported yet
(ROADMAP A8). Not ported yet either, and raising where asked for: ring
attention and mixture-of-experts MLPs (A8), per-slot caches and block
pools (A7), ``return_kv`` and ``sp_prefill`` (A8).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from sparkdl_torch.ops._dispatch import resolve_device
from sparkdl_torch.ops.flash_attention import NEG_INF, flash_attention
from sparkdl_torch.ops.flash_decode import flash_decode

_NOT_PORTED = "not ported to sparkdl_torch yet (ROADMAP {item})"


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
    #: "full" | "flash" (hand-written CUDA kernels) | "ring" (not ported)
    attn_impl: str = "full"
    #: the ops/flash_decode kernel for the single-token cached step
    flash_decode: bool = False
    sp_axis: str = "sp"
    sp_mode: str = "ring"
    #: 0 = dense MLPs; >0 = mixture of experts (not ported)
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
               per_slot: bool = False, *, device="cuda") -> dict:
    """Zeroed KV cache for :func:`generate` / incremental decode:
    ``k``/``v`` ``[num_layers, B, max_len, H, D]`` on ``device`` and
    ``idx`` = 0, the number of positions written (a host int). Forward
    calls write their keys/values in place and advance ``idx``."""
    if per_slot:
        raise NotImplementedError(
            "per-slot caches (continuous batching) are "
            + _NOT_PORTED.format(item="A7"))
    hd = config.hidden_size // config.num_heads
    shape = (config.num_layers, batch, max_len, config.num_heads, hd)
    dev = resolve_device(device)
    return {
        "k": torch.zeros(shape, dtype=config.dtype, device=dev),
        "v": torch.zeros(shape, dtype=config.dtype, device=dev),
        "idx": 0,
    }


def init_block_pool(*args, **kwargs):
    raise NotImplementedError("the paged KV block pool is "
                              + _NOT_PORTED.format(item="A7"))


def sp_prefill(*args, **kwargs):
    raise NotImplementedError("sequence-parallel prefill is "
                              + _NOT_PORTED.format(item="A8"))


def first_valid_column(key_valid: torch.Tensor) -> torch.Tensor:
    """int32 [B]: each row's first True column of a left-padded [B, L]
    key-validity mask (the ``start`` of ``ops/flash_decode``)."""
    return torch.argmax(key_valid.to(torch.int32), dim=1).to(torch.int32)


def _dense_attention(q, k, v, keep):
    """softmax(q·kᵀ/√D) over [B, L, H, D] with ``keep`` broadcast to
    [B, H, Lq, Lk]; masked scores are the -1e30 sentinel."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(
        q.shape[-1])
    s = torch.where(keep, s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


class GPTAttention(nn.Module):
    def __init__(self, config: GPTConfig, layer_idx: int, device=None):
        super().__init__()
        self.config = config
        self.layer_idx = layer_idx
        h = config.hidden_size
        kw = dict(device=device, dtype=config.dtype)
        self.q_proj = nn.Linear(h, h, **kw)
        self.k_proj = nn.Linear(h, h, **kw)
        self.v_proj = nn.Linear(h, h, **kw)
        self.out_proj = nn.Linear(h, h, **kw)

    def forward(self, x, *, cache: Optional[dict] = None,
                positions: Optional[torch.Tensor] = None,
                attention_mask: Optional[torch.Tensor] = None,
                start: Optional[torch.Tensor] = None):
        c = self.config
        nh = c.num_heads
        hd = c.hidden_size // nh
        b, l = x.shape[0], x.shape[1]
        q, k, v = (p(x).view(b, l, nh, hd)
                   for p in (self.q_proj, self.k_proj, self.v_proj))
        idx = cache["idx"] if cache is not None else 0
        if c.positions == "rope":
            if positions is None:
                positions = (idx + torch.arange(l, device=x.device)).expand(b, l)
            q = apply_rope(q, positions, c.rope_base)
            k = apply_rope(k, positions, c.rope_base)

        if cache is not None:
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
            if attention_mask is not None and c.attn_impl != "full":
                raise ValueError(
                    "attention_mask on the uncached forward requires "
                    f"attn_impl='full' (got {c.attn_impl!r}); the flash/"
                    "ring kernels take ragged batches only through the "
                    "KV-cached generate() path"
                )
            if c.attn_impl == "flash":
                ctx = flash_attention(q, k, v, causal=True)
            else:
                keep = torch.ones((l, l), dtype=torch.bool,
                                  device=x.device).tril()[None, None]
                if attention_mask is not None:
                    keep = keep & attention_mask[:, None, None, :].bool()
                ctx = _dense_attention(q, k, v, keep)
        return self.out_proj(ctx.reshape(b, l, c.hidden_size))


class GPTBlock(nn.Module):
    def __init__(self, config: GPTConfig, layer_idx: int, device=None):
        super().__init__()
        c = config
        kw = dict(device=device, dtype=c.dtype)
        self.ln_1 = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps, **kw)
        self.attn = GPTAttention(c, layer_idx, device=device)
        self.ln_2 = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps, **kw)
        self.up = nn.Linear(c.hidden_size, c.intermediate_size, **kw)
        self.down = nn.Linear(c.intermediate_size, c.hidden_size, **kw)

    def forward(self, x, **attn_kw):
        x = x + self.attn(self.ln_1(x), **attn_kw)
        return x + self.down(F.gelu(self.up(self.ln_2(x)), approximate="tanh"))


class GPTLMHeadModel(nn.Module):
    """Decoder LM. ``forward(input_ids, cache=None)`` -> (logits, cache).

    Without a cache: the full causal forward. With a cache from
    :func:`init_cache`: writes K/V at ``cache['idx']`` in place, advances
    ``idx`` and returns the same cache. ``positions``: optional [B, L]
    token positions (RoPE or the learned table). ``attention_mask``:
    optional key validity (False = masked), [B, L] on the uncached
    forward, [B, max_len] over buffer columns on the cached path.
    Parameters are created on ``device`` with torch's default init; use
    :func:`init_gpt_` for Flax's, or load a converted state dict.
    """

    def __init__(self, config: GPTConfig, *, device="cuda"):
        super().__init__()
        if config.attn_impl == "ring":
            raise NotImplementedError(
                "attn_impl='ring' (sequence-parallel attention) is "
                + _NOT_PORTED.format(item="A8"))
        if config.attn_impl not in ("full", "flash"):
            raise ValueError(f"unknown attn_impl {config.attn_impl!r}")
        if config.num_experts > 0:
            raise NotImplementedError(
                "mixture-of-experts MLPs (num_experts > 0) are "
                + _NOT_PORTED.format(item="A8"))
        dev = resolve_device(device)
        c = config
        kw = dict(device=dev, dtype=c.dtype)
        self.config = c
        self.wte = nn.Embedding(c.vocab_size, c.hidden_size, **kw)
        self.wpe = (nn.Embedding(c.max_seq_len, c.hidden_size, **kw)
                    if c.positions == "learned" else None)
        self.h = nn.ModuleList(GPTBlock(c, i, device=dev)
                               for i in range(c.num_layers))
        self.ln_f = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps, **kw)

    def forward(self, input_ids, *, cache: Optional[dict] = None,
                positions: Optional[torch.Tensor] = None,
                attention_mask: Optional[torch.Tensor] = None,
                return_kv: bool = False):
        if return_kv:
            raise NotImplementedError(
                "return_kv (the sequence-parallel prefill's building block) "
                "is " + _NOT_PORTED.format(item="A8"))
        c = self.config
        b, l = input_ids.shape
        x = self.wte(input_ids)
        if self.wpe is not None:
            pos = positions
            if pos is None:
                idx = cache["idx"] if cache is not None else 0
                pos = (idx + torch.arange(l, device=x.device)).expand(b, l)
            x = x + self.wpe(pos)

        start = None
        if (cache is not None and l == 1 and c.attn_impl == "flash"
                and c.flash_decode and attention_mask is not None):
            start = cache.get("start")
            if start is None:
                start = first_valid_column(attention_mask)
        for blk in self.h:
            x = blk(x, cache=cache, positions=positions,
                    attention_mask=attention_mask, start=start)
        x = self.ln_f(x)
        logits = F.linear(x, self.wte.weight).float()  # weight-tied LM head
        if cache is not None:
            cache["idx"] += l
        return logits, cache


def init_gpt_(module: GPTLMHeadModel, seed: int = 0) -> GPTLMHeadModel:
    """Flax's default initialisation, from a seeded CPU generator (so the
    weights do not depend on the device): lecun-normal dense kernels and
    zero biases, LayerNorm scale 1 and bias 0, and ``nn.Embed``'s
    N(0, 1/hidden) for the token and position tables."""
    from sparkdl_torch.models.common import lecun_normal_

    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, nn.Linear):
                w = torch.empty(m.weight.shape, dtype=torch.float32)
                m.weight.copy_(lecun_normal_(w, g))
                m.bias.zero_()
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
    position is a host int: the loop never waits for the device.
    """
    b, lp = prompt_ids.shape
    if max_new_tokens < 0:
        raise ValueError(f"max_new_tokens must be >= 0, got {max_new_tokens}")
    if max_len is None:
        max_len = lp + max_new_tokens
    elif max_len < lp + max_new_tokens:
        raise ValueError(
            f"max_len={max_len} < prompt_len {lp} + max_new_tokens "
            f"{max_new_tokens}: cache writes would overflow"
        )
    if (model.config.positions == "learned"
            and lp + max_new_tokens > model.config.max_seq_len):
        raise ValueError(
            f"prompt_len {lp} + max_new_tokens {max_new_tokens} exceeds the "
            f"learned position table (max_seq_len={model.config.max_seq_len})"
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

    dev = prompt_ids.device
    positions = key_valid = pad_len = None
    if attention_mask is not None:
        if tuple(attention_mask.shape) != (b, lp):
            raise ValueError(
                f"attention_mask shape {tuple(attention_mask.shape)} != "
                f"prompt shape {(b, lp)}"
            )
        mask = attention_mask.to(device=dev, dtype=torch.bool)
        if not bool((mask[:, 1:] >= mask[:, :-1]).all()):
            raise ValueError(
                "attention_mask must be left-padded (each row 0...01...1); "
                "right-padded prompts cannot share a sampling column"
            )
        if not bool(mask[:, -1].all()):
            raise ValueError("every row needs at least one real token")
        pad_len = lp - mask.sum(dim=1)  # [B]
        # logical positions: pads clamp to 0 (masked out of attention)
        positions = (mask.cumsum(dim=1) - 1).clamp_min(0)
        # buffer-column validity for the whole generation
        key_valid = torch.cat(
            [mask, torch.ones((b, max_len - lp), dtype=torch.bool, device=dev)],
            dim=1)
    if max_new_tokens == 0:
        return prompt_ids.clone()

    def sample(logits):
        return sample_logits(logits, generator, temperature=temperature,
                             top_k=top_k, top_p=top_p)

    cache = init_cache(model.config, b, max_len, device=dev)
    if key_valid is not None:
        cache["start"] = first_valid_column(key_valid)
    logits, cache = model(prompt_ids, cache=cache, positions=positions,
                          attention_mask=key_valid)
    toks = [sample(logits[:, -1])]
    for _ in range(max_new_tokens - 1):
        pos = None if pad_len is None else (cache["idx"] - pad_len)[:, None]
        logits, cache = model(toks[-1][:, None], cache=cache, positions=pos,
                              attention_mask=key_valid)
        toks.append(sample(logits[:, -1]))
    new = torch.stack(toks, dim=1).to(prompt_ids.dtype)
    return torch.cat([prompt_ids, new], dim=1)
