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

``train=True`` applies dropout at the reference's sites: the embeddings'
output, the attention probabilities (the ``full`` path only: the flash
kernels never form them, and ``flash`` warns as the reference does), the
attention block's and the MLP's outputs, and the pooled [CLS] before the
classifier. The masks come from an explicit ``torch.Generator`` the
caller may pass (``generator=``; the device's default generator
otherwise), so a seed gives the same bits. The JAX fine-tune path runs
its forward with ``train=False``, as ``finetune_classifier`` does.

``"ring"`` (``parallel/ring_attention``): attention over a sequence
split on the ``sp_axis`` of the mesh, the key mask riding the ring with
its block; under it ``position_ids`` default to the shard's global
positions, every peer pools the sequence's [CLS] (the first peer's first
token), and attention-probs dropout is skipped as under ``flash``.
Under a mesh (``mesh=``, default the ambient ``mesh_context``) whose
``tp`` axis is larger than 1, query/key/value and ``intermediate`` are
column-parallel and ``output_dense`` and ``output`` row-parallel
(``parallel/tensor_parallel``), as the JAX module annotates them: each
rank holds ``num_attention_heads/tp`` heads.
"""

from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Any, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from sparkdl_torch.ops._dispatch import resolve_device
from sparkdl_torch.ops.flash_attention import NEG_INF, flash_attention
from sparkdl_torch.parallel.collectives import all_reduce, axis_group
from sparkdl_torch.parallel.ring_attention import ring_self_attention
from sparkdl_torch.parallel.tensor_parallel import dense_pair, shared_input, tp_size
from sparkdl_torch.runtime.mesh import Mesh, current_mesh


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
    #: "full" | "flash" (hand-written CUDA kernels) | "ring" (the
    #: sequence split over ``sp_axis``)
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


class Dropout(nn.Dropout):
    """``nn.Dropout`` whose mask is drawn from an explicit generator:
    ``forward(x, train=..., generator=...)`` keeps each element with
    probability ``1 - p`` and scales it by ``1/(1 - p)``, as Flax's
    ``nn.Dropout`` does; identity when not training or at ``p = 0``."""

    def forward(self, x: torch.Tensor, *, train: bool = False,
                generator: "torch.Generator | None" = None) -> torch.Tensor:
        if not train or self.p == 0.0:
            return x
        keep = torch.rand(x.shape, generator=generator, device=x.device,
                          dtype=torch.float32) >= self.p
        return torch.where(keep, x / (1.0 - self.p), torch.zeros_like(x))


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
        self.dropout = Dropout(c.hidden_dropout_prob)

    def forward(self, input_ids, token_type_ids, position_ids, *,
                train: bool = False, generator=None):
        x = (self.word_embeddings(input_ids)
             + self.position_embeddings(position_ids)
             + self.token_type_embeddings(token_type_ids))
        return self.dropout(self.LayerNorm(x), train=train,
                            generator=generator)


class BertSelfAttention(nn.Module):
    def __init__(self, config: BertConfig, device=None,
                 mesh: "Mesh | None" = None):
        super().__init__()
        self.config = config
        self.mesh = mesh
        self.heads = config.num_attention_heads // tp_size(mesh)
        h = config.hidden_size
        column, row = dense_pair(mesh, device=device, dtype=config.dtype)
        # q, k and v read one input: one gradient all-reduce for the three
        self.query = column(h, h, copy_input=False)
        self.key = column(h, h, copy_input=False)
        self.value = column(h, h, copy_input=False)
        self.output_dense = row(h, h)
        self.dropout = Dropout(config.attention_probs_dropout_prob)

    def forward(self, x, attention_mask: Optional[torch.Tensor], *,
                train: bool = False, generator=None):
        c = self.config
        nh = self.heads
        hd = c.hidden_size // c.num_attention_heads
        b, l = x.shape[0], x.shape[1]
        xs = shared_input(x, self.query)
        q, k, v = (p(xs).view(b, l, nh, hd)
                   for p in (self.query, self.key, self.value))
        if c.attn_impl in ("flash", "ring"):
            if train and c.attention_probs_dropout_prob > 0:
                # the kernels and the ring's online softmax never form the
                # probability matrix, so attention-probs dropout cannot
                # apply (the usual flash-attention trade-off)
                warnings.warn(
                    f"attn_impl={c.attn_impl!r} skips attention-probs "
                    f"dropout (p={c.attention_probs_dropout_prob}); set "
                    "attention_probs_dropout_prob=0 to silence",
                    stacklevel=2,
                )
        if c.attn_impl == "flash":
            ctx = flash_attention(q, k, v, attention_mask)
        elif c.attn_impl == "ring":
            ctx = ring_self_attention(q, k, v, attention_mask,
                                      axis_name=c.sp_axis, mesh=self.mesh)
        else:
            s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(hd)
            if attention_mask is not None:
                s = torch.where(attention_mask[:, None, None, :], s, NEG_INF)
            p = torch.softmax(s, dim=-1).to(c.dtype)
            p = self.dropout(p, train=train, generator=generator)
            ctx = torch.einsum("bhqk,bkhd->bqhd", p, v)
        return self.output_dense(ctx.reshape(b, l, nh * hd))


class BertLayer(nn.Module):
    def __init__(self, config: BertConfig, device=None,
                 mesh: "Mesh | None" = None):
        super().__init__()
        c = config
        kw = dict(device=device, dtype=c.dtype)
        self.attention = BertSelfAttention(c, device=device, mesh=mesh)
        self.attention_LayerNorm = nn.LayerNorm(c.hidden_size,
                                                eps=c.layer_norm_eps, **kw)
        column, row = dense_pair(mesh, device=device, dtype=c.dtype)
        self.intermediate = column(c.hidden_size, c.intermediate_size)
        self.output = row(c.intermediate_size, c.hidden_size)
        self.output_LayerNorm = nn.LayerNorm(c.hidden_size,
                                             eps=c.layer_norm_eps, **kw)
        self.dropout = Dropout(c.hidden_dropout_prob)

    def forward(self, x, attention_mask, *, train: bool = False,
                generator=None):
        drop = dict(train=train, generator=generator)
        a = self.dropout(self.attention(x, attention_mask, **drop), **drop)
        x = self.attention_LayerNorm(x + a)
        h = self.output(F.gelu(self.intermediate(x)))  # exact GELU
        return self.output_LayerNorm(x + self.dropout(h, **drop))


class BertModel(nn.Module):
    """Encoder + tanh pooler over [CLS] (HF BertModel shape).

    ``forward(input_ids, attention_mask=None, token_type_ids=None,
    position_ids=None, *, train=False, generator=None)`` -> (sequence
    output [B, L, H],
    pooled [B, H] or None without the pooler). ``attention_mask`` [B, L]:
    nonzero = a real token. Parameters are created on ``device`` with
    torch's default init; use :func:`init_bert_` for Flax's, or load a
    converted state dict (a rank's slice of one under a ``tp`` mesh:
    ``convert.shard_state_dict``). ``mesh``: where the ring and the
    tensor-parallel layers find their axes (default the ambient
    ``mesh_context``).
    """

    def __init__(self, config: BertConfig, add_pooler: bool = True, *,
                 device="cuda", mesh: "Mesh | None" = None):
        super().__init__()
        if config.attn_impl not in ("full", "flash", "ring"):
            raise ValueError(f"unknown attn_impl {config.attn_impl!r}")
        mesh = mesh if mesh is not None else current_mesh()
        tp = tp_size(mesh)
        if config.num_attention_heads % tp:
            raise ValueError(
                f"num_attention_heads {config.num_attention_heads} is not "
                f"divisible by the {tp}-way tp axis")
        dev = resolve_device(device)
        self.config = config
        self.mesh = mesh
        self.embeddings = BertEmbeddings(config, device=dev)
        self.layer = nn.ModuleList(BertLayer(config, device=dev, mesh=mesh)
                                   for _ in range(config.num_hidden_layers))
        self.pooler = (nn.Linear(config.hidden_size, config.hidden_size,
                                 device=dev, dtype=config.dtype)
                       if add_pooler else None)

    def forward(self, input_ids, attention_mask=None, token_type_ids=None,
                position_ids=None, *, train: bool = False, generator=None):
        b, l = input_ids.shape
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        if position_ids is None:
            start = 0
            if self.config.attn_impl == "ring":  # this shard's global positions
                start = axis_group(self.config.sp_axis, self.mesh).index * l
            position_ids = (start + torch.arange(
                l, device=input_ids.device)).expand(b, l)
        mask = None if attention_mask is None else attention_mask.bool()
        x = self.embeddings(input_ids, token_type_ids, position_ids,
                            train=train, generator=generator)
        for blk in self.layer:
            x = blk(x, mask, train=train, generator=generator)
        pooled = None
        if self.pooler is not None:
            first = x[:, 0]
            if self.config.attn_impl == "ring":
                # [CLS] is the first token of the sequence, on the first sp
                # peer: every peer pools it (all_reduce's backward sums the
                # peers' gradients of it back onto that token; every peer's
                # input is in the graph, so every peer runs that backward)
                ag = axis_group(self.config.sp_axis, self.mesh)
                if ag.size > 1:
                    first = all_reduce(first * (ag.index == 0), ag)
            pooled = torch.tanh(self.pooler(first))
        return x, pooled


class BertForSequenceClassification(nn.Module):
    """Fine-tune head: pooled [CLS] -> logits [B, num_labels]."""

    def __init__(self, config: BertConfig, num_labels: int = 2, *,
                 device="cuda", mesh: "Mesh | None" = None):
        super().__init__()
        self.config = config
        self.num_labels = num_labels
        self.bert = BertModel(config, device=device, mesh=mesh)
        self.classifier = nn.Linear(config.hidden_size, num_labels,
                                    device=resolve_device(device),
                                    dtype=config.dtype)
        self.dropout = Dropout(config.hidden_dropout_prob)

    def forward(self, input_ids, attention_mask=None, token_type_ids=None, *,
                train: bool = False, generator=None):
        _, pooled = self.bert(input_ids, attention_mask, token_type_ids,
                              train=train, generator=generator)
        pooled = self.dropout(pooled, train=train, generator=generator)
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
