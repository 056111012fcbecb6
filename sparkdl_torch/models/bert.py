"""BERT encoders: the port of ``sparkdl_tpu.models.bert``.

Same configuration, parameter tree (through :func:`bert_flax_to_torch` in
``models/convert.py``) and numerics as the JAX modules: word + position +
token-type embeddings and LayerNorm (eps 1e-12), post-LayerNorm encoder
layers with an exact-GELU MLP, a tanh pooler over [CLS] and a classifier
head. Attention dispatches on ``BertConfig.attn_impl``:

- ``"full"``: the dense masked softmax (einsum), masked scores at -1e30;
- ``"flash"``: ``ops/flash_attention`` with the ``[B, L]`` key mask,
  differentiable through its backward kernels (training runs through
  them).

The JAX module's tensor-parallel projections are plain ``nn.Linear``
here. Not ported yet, and raising where asked for: ring attention and
tensor parallelism (ROADMAP A8), and dropout in training (``train=True``
with a nonzero dropout rate; A8) — the JAX fine-tune path runs its
forward with ``train=False``.
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

_NOT_PORTED = "not ported to sparkdl_torch yet (ROADMAP {item})"


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    #: "full" | "flash" (hand-written CUDA kernels) | "ring" (not ported)
    attn_impl: str = "full"
    sp_axis: str = "sp"
    dtype: Any = torch.float32

    @classmethod
    def base(cls, **kw) -> "BertConfig":
        return cls(**kw)

    @classmethod
    def tiny(cls, **kw) -> "BertConfig":
        """Test-sized config (oracle/unit tests)."""
        defaults = dict(
            vocab_size=128, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=2, intermediate_size=64,
            max_position_embeddings=64, hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0,
        )
        defaults.update(kw)
        return cls(**defaults)


def _check_train(config: BertConfig, train: bool) -> None:
    if train and (config.hidden_dropout_prob > 0
                  or config.attention_probs_dropout_prob > 0):
        raise NotImplementedError(
            "train=True with nonzero dropout (hidden "
            f"{config.hidden_dropout_prob}, attention "
            f"{config.attention_probs_dropout_prob}): BERT dropout is "
            + _NOT_PORTED.format(item="A8")
            + "; fine-tune with train=False as the JAX fine-tune path does, "
            "or set both dropout rates to 0")


class BertEmbeddings(nn.Module):
    def __init__(self, config: BertConfig, device=None):
        super().__init__()
        c = config
        kw = dict(device=device, dtype=c.dtype)
        self.word_embeddings = nn.Embedding(c.vocab_size, c.hidden_size, **kw)
        self.position_embeddings = nn.Embedding(
            c.max_position_embeddings, c.hidden_size, **kw)
        self.token_type_embeddings = nn.Embedding(
            c.type_vocab_size, c.hidden_size, **kw)
        self.LayerNorm = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps, **kw)

    def forward(self, input_ids, token_type_ids, position_ids):
        x = (self.word_embeddings(input_ids)
             + self.position_embeddings(position_ids)
             + self.token_type_embeddings(token_type_ids))
        return self.LayerNorm(x)


class BertSelfAttention(nn.Module):
    def __init__(self, config: BertConfig, device=None):
        super().__init__()
        self.config = config
        h = config.hidden_size
        kw = dict(device=device, dtype=config.dtype)
        self.query = nn.Linear(h, h, **kw)
        self.key = nn.Linear(h, h, **kw)
        self.value = nn.Linear(h, h, **kw)
        self.output_dense = nn.Linear(h, h, **kw)

    def forward(self, x, attention_mask: Optional[torch.Tensor]):
        c = self.config
        nh = c.num_attention_heads
        hd = c.hidden_size // nh
        b, l = x.shape[0], x.shape[1]
        q, k, v = (p(x).view(b, l, nh, hd)
                   for p in (self.query, self.key, self.value))
        if c.attn_impl == "flash":
            ctx = flash_attention(q, k, v, attention_mask)
        else:
            s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(hd)
            if attention_mask is not None:
                s = torch.where(attention_mask[:, None, None, :], s, NEG_INF)
            p = torch.softmax(s, dim=-1).to(c.dtype)
            ctx = torch.einsum("bhqk,bkhd->bqhd", p, v)
        return self.output_dense(ctx.reshape(b, l, c.hidden_size))


class BertLayer(nn.Module):
    def __init__(self, config: BertConfig, device=None):
        super().__init__()
        c = config
        kw = dict(device=device, dtype=c.dtype)
        self.attention = BertSelfAttention(c, device=device)
        self.attention_LayerNorm = nn.LayerNorm(c.hidden_size,
                                                eps=c.layer_norm_eps, **kw)
        self.intermediate = nn.Linear(c.hidden_size, c.intermediate_size, **kw)
        self.output = nn.Linear(c.intermediate_size, c.hidden_size, **kw)
        self.output_LayerNorm = nn.LayerNorm(c.hidden_size,
                                             eps=c.layer_norm_eps, **kw)

    def forward(self, x, attention_mask):
        x = self.attention_LayerNorm(x + self.attention(x, attention_mask))
        h = self.output(F.gelu(self.intermediate(x)))  # exact GELU
        return self.output_LayerNorm(x + h)


class BertModel(nn.Module):
    """Encoder + tanh pooler over [CLS] (HF BertModel shape).

    ``forward(input_ids, attention_mask=None, token_type_ids=None,
    position_ids=None, *, train=False)`` -> (sequence output [B, L, H],
    pooled [B, H] or None without the pooler). ``attention_mask`` [B, L]:
    nonzero = a real token. Parameters are created on ``device`` with
    torch's default init; use :func:`init_bert_` for Flax's, or load a
    converted state dict.
    """

    def __init__(self, config: BertConfig, add_pooler: bool = True, *,
                 device="cuda"):
        super().__init__()
        if config.attn_impl == "ring":
            raise NotImplementedError(
                "attn_impl='ring' (sequence-parallel attention) is "
                + _NOT_PORTED.format(item="A8"))
        if config.attn_impl not in ("full", "flash"):
            raise ValueError(f"unknown attn_impl {config.attn_impl!r}")
        dev = resolve_device(device)
        self.config = config
        self.embeddings = BertEmbeddings(config, device=dev)
        self.layer = nn.ModuleList(BertLayer(config, device=dev)
                                   for _ in range(config.num_hidden_layers))
        self.pooler = (nn.Linear(config.hidden_size, config.hidden_size,
                                 device=dev, dtype=config.dtype)
                       if add_pooler else None)

    def forward(self, input_ids, attention_mask=None, token_type_ids=None,
                position_ids=None, *, train: bool = False):
        _check_train(self.config, train)
        b, l = input_ids.shape
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        if position_ids is None:
            position_ids = torch.arange(l, device=input_ids.device).expand(b, l)
        mask = None if attention_mask is None else attention_mask.bool()
        x = self.embeddings(input_ids, token_type_ids, position_ids)
        for blk in self.layer:
            x = blk(x, mask)
        pooled = None
        if self.pooler is not None:
            pooled = torch.tanh(self.pooler(x[:, 0]))
        return x, pooled


class BertForSequenceClassification(nn.Module):
    """Fine-tune head: pooled [CLS] -> logits [B, num_labels]."""

    def __init__(self, config: BertConfig, num_labels: int = 2, *,
                 device="cuda"):
        super().__init__()
        self.config = config
        self.num_labels = num_labels
        self.bert = BertModel(config, device=device)
        self.classifier = nn.Linear(config.hidden_size, num_labels,
                                    device=resolve_device(device),
                                    dtype=config.dtype)

    def forward(self, input_ids, attention_mask=None, token_type_ids=None, *,
                train: bool = False):
        _, pooled = self.bert(input_ids, attention_mask, token_type_ids,
                              train=train)
        return self.classifier(pooled)


def init_bert_(module: nn.Module, seed: int = 0) -> nn.Module:
    """Flax's default initialisation, from a seeded CPU generator (so the
    weights do not depend on the device): lecun-normal dense kernels and
    zero biases, LayerNorm scale 1 and bias 0, and ``nn.Embed``'s
    N(0, 1/hidden) for the three embedding tables."""
    from sparkdl_torch.models.gpt import init_gpt_

    return init_gpt_(module, seed)


# ---------------------------------------------------------------------------
# HuggingFace BERT weights (a torch module, duck-typed) -> this module
# ---------------------------------------------------------------------------

def config_from_hf(hf_config) -> BertConfig:
    return BertConfig(
        vocab_size=hf_config.vocab_size,
        hidden_size=hf_config.hidden_size,
        num_hidden_layers=hf_config.num_hidden_layers,
        num_attention_heads=hf_config.num_attention_heads,
        intermediate_size=hf_config.intermediate_size,
        max_position_embeddings=hf_config.max_position_embeddings,
        type_vocab_size=hf_config.type_vocab_size,
        layer_norm_eps=hf_config.layer_norm_eps,
        hidden_dropout_prob=hf_config.hidden_dropout_prob,
        attention_probs_dropout_prob=hf_config.attention_probs_dropout_prob,
    )


_HF_LAYER = (
    ("attention.query", "attention.self.query"),
    ("attention.key", "attention.self.key"),
    ("attention.value", "attention.self.value"),
    ("attention.output_dense", "attention.output.dense"),
    ("attention_LayerNorm", "attention.output.LayerNorm"),
    ("intermediate", "intermediate.dense"),
    ("output", "output.dense"),
    ("output_LayerNorm", "output.LayerNorm"),
)


def load_hf_bert(hf_model) -> "tuple[BertConfig, dict]":
    """An HF ``BertModel`` (torch; duck-typed, no ``transformers``
    import) -> (config, state dict for :class:`BertModel`), or, for a
    module with a ``.bert`` submodule such as
    ``BertForSequenceClassification``, a state dict for
    :class:`BertForSequenceClassification` (its classifier head included).
    float32 on the CPU; HF's ``nn.Linear`` weights are already [out, in]."""
    bert, head, prefix = hf_model, None, ""
    if hasattr(hf_model, "bert"):
        bert, head, prefix = hf_model.bert, hf_model.classifier, "bert."
    cfg = config_from_hf(bert.config)
    src = bert.state_dict()

    def t(key):
        return src[key].detach().to("cpu", torch.float32).contiguous().clone()

    sd = {}
    for name in ("word_embeddings", "position_embeddings",
                 "token_type_embeddings"):
        sd[f"{prefix}embeddings.{name}.weight"] = t(f"embeddings.{name}.weight")
    for field in ("weight", "bias"):
        sd[f"{prefix}embeddings.LayerNorm.{field}"] = t(
            f"embeddings.LayerNorm.{field}")
        for i in range(cfg.num_hidden_layers):
            for ours, theirs in _HF_LAYER:
                sd[f"{prefix}layer.{i}.{ours}.{field}"] = t(
                    f"encoder.layer.{i}.{theirs}.{field}")
        if "pooler.dense.weight" in src:
            sd[f"{prefix}pooler.{field}"] = t(f"pooler.dense.{field}")
        if head is not None:
            sd[f"classifier.{field}"] = getattr(head, field).detach().to(
                "cpu", torch.float32).contiguous().clone()
    return cfg, sd
