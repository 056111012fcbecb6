"""Vision Transformer (ViT) as a torch ``nn.Module``: the port of
``sparkdl_tpu.models.vit``.

The HF ``ViTModel`` computation (google/vit-base-*): a PxP stride-P conv
patch embedding, a prepended CLS token, learned position embeddings,
pre-LayerNorm encoder blocks with an exact (erf) GELU MLP, and a final
LayerNorm (eps 1e-12 throughout). Attention dispatches on
``ViTConfig.attn_impl``:

- ``"full"``: the dense softmax (einsum) with float32 scores;
- ``"flash"``: ``ops/flash_attention`` with no mask (ViT's sequences are
  dense), the hand-written CUDA kernel on the card.

Zoo contract, as the CNNs of the registry: ``forward(x)`` takes NHWC
[B, S, S, 3] preprocessed images and returns (features, probs); features
are the final-LayerNorm CLS token [B, hidden], probs the classifier's
softmax or None without the top. Under a mesh (``mesh=``, default the
ambient ``mesh_context``) whose ``tp`` axis is larger than 1, query/key/
value and ``intermediate`` are column-parallel and ``output_dense`` and
``output`` row-parallel (``parallel/tensor_parallel``), as the JAX module
annotates them: each rank holds ``num_heads/tp`` heads and loads its
slice with ``models/convert.shard_state_dict``. At ``tp = 1`` they are
plain ``nn.Linear`` s, with the same names. Parameters are created with
torch's default init; use
:func:`init_vit_` for Flax's, load a state dict converted from the Flax
tree (``models/convert.vit_flax_to_torch``) or from a transformers model
(:func:`load_hf_vit`).

``ViTConfig.dtype`` is the compute dtype, as in the Flax module: the
parameters stay float32 and are cast at each op, LayerNorm normalizes in
float32 and rounds its output, the attention scores are float32.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from sparkdl_torch.models.common import conv2d_tf, linear
from sparkdl_torch.ops.flash_attention import flash_attention
from sparkdl_torch.parallel.tensor_parallel import dense_pair, shared_input, tp_size
from sparkdl_torch.runtime.mesh import Mesh, current_mesh


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    layer_norm_eps: float = 1e-12
    dropout: float = 0.0
    #: "full" | "flash" (the hand-written CUDA kernel; dense, no mask)
    attn_impl: str = "full"
    num_classes: int = 1000
    dtype: Any = torch.float32

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @classmethod
    def b16(cls, **kw) -> "ViTConfig":
        return cls(**kw)

    @classmethod
    def tiny(cls, **kw) -> "ViTConfig":
        """Test-sized config (oracle/unit tests)."""
        defaults = dict(
            image_size=32, patch_size=8, hidden_size=32, num_layers=2,
            num_heads=2, intermediate_size=64, dropout=0.0,
        )
        defaults.update(kw)
        return cls(**defaults)


def _dense(x: torch.Tensor, m: nn.Linear) -> torch.Tensor:
    """``m`` applied in ``x``'s dtype: a plain layer through
    :func:`linear`, a tensor-parallel one through its forward (its
    collective)."""
    return linear(x, m) if type(m) is nn.Linear else m(x)


class ViTSelfAttention(nn.Module):
    def __init__(self, config: ViTConfig, mesh: "Mesh | None" = None,
                 device=None):
        super().__init__()
        self.config = config
        self.heads = config.num_heads // tp_size(mesh)
        h = config.hidden_size
        column, row = dense_pair(mesh, device=device)
        # q, k and v read one input: one gradient all-reduce for the three
        self.query = column(h, h, copy_input=False)
        self.key = column(h, h, copy_input=False)
        self.value = column(h, h, copy_input=False)
        self.output_dense = row(h, h)

    def forward(self, x):
        c = self.config
        nh = self.heads
        hd = c.hidden_size // c.num_heads
        b, l = x.shape[0], x.shape[1]
        xs = shared_input(x, self.query)
        q, k, v = (_dense(xs, p).view(b, l, nh, hd)
                   for p in (self.query, self.key, self.value))
        if c.attn_impl == "flash":
            ctx = flash_attention(q, k, v)
        else:
            s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(hd)
            p = torch.softmax(s, dim=-1).to(c.dtype)
            ctx = torch.einsum("bhqk,bkhd->bqhd", p, v)
        return _dense(ctx.reshape(b, l, nh * hd), self.output_dense)


def _layer_norm(x: torch.Tensor, m: nn.LayerNorm) -> torch.Tensor:
    """``m`` in float32, rounded back to ``x``'s dtype (Flax's LayerNorm)."""
    y = F.layer_norm(x.float(), m.normalized_shape, m.weight, m.bias, m.eps)
    return y.to(x.dtype)


class ViTBlock(nn.Module):
    """Pre-LN block: LN -> attention -> +residual; LN -> MLP -> +residual."""

    def __init__(self, config: ViTConfig, mesh: "Mesh | None" = None,
                 device=None):
        super().__init__()
        c = config
        self.layernorm_before = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps,
                                             device=device)
        self.attention = ViTSelfAttention(c, mesh, device)
        self.layernorm_after = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps,
                                            device=device)
        column, row = dense_pair(mesh, device=device)
        self.intermediate = column(c.hidden_size, c.intermediate_size)
        self.output = row(c.intermediate_size, c.hidden_size)

    def forward(self, x):
        x = x + self.attention(_layer_norm(x, self.layernorm_before))
        h = F.gelu(_dense(_layer_norm(x, self.layernorm_after), self.intermediate))
        return x + _dense(h, self.output)  # exact GELU above


class ViTModel(nn.Module):
    """Zoo-contract ViT: ``forward(x)`` -> (features [B, hidden], probs or
    None), both float32. ``num_classes`` defaults to the config's (which
    :func:`load_hf_vit` sets from HF ``num_labels``); ``dtype``, when
    given, overrides the config's compute dtype. Parameters are float32
    whatever the compute dtype, as the Flax module's. ``device``: where
    the parameters are made (the CPU by default, as the registry builds
    its models before moving them); ``mesh``: where the tensor-parallel
    layers find their ``tp`` axis (default the ambient ``mesh_context``)."""

    def __init__(self, config: ViTConfig = ViTConfig(), num_classes: "int | None" = None,
                 include_top: bool = True, dtype: "torch.dtype | None" = None, *,
                 device=None, mesh: "Mesh | None" = None):
        super().__init__()
        if config.attn_impl not in ("full", "flash"):
            raise ValueError(f"unknown attn_impl {config.attn_impl!r}")
        if dtype is not None and dtype != config.dtype:
            config = dataclasses.replace(config, dtype=dtype)
        c = config
        mesh = mesh if mesh is not None else current_mesh()
        if c.num_heads % tp_size(mesh):
            raise ValueError(
                f"num_heads {c.num_heads} is not divisible by the "
                f"{tp_size(mesh)}-way tp axis")
        device = "cpu" if device is None else device
        self.config = c
        self.mesh = mesh
        self.include_top = include_top
        self.num_classes = num_classes if num_classes is not None else c.num_classes
        p, h = c.patch_size, c.hidden_size
        kw = dict(device=torch.device(device))
        self.patch_embed = nn.Conv2d(3, h, p, stride=p, **kw)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, h, **kw))
        self.pos_embed = nn.Parameter(torch.zeros(1, c.num_patches + 1, h, **kw))
        self.layer = nn.ModuleList(ViTBlock(c, mesh, kw["device"])
                                   for _ in range(c.num_layers))
        self.layernorm = nn.LayerNorm(h, eps=c.layer_norm_eps, **kw)
        self.classifier = nn.Linear(h, self.num_classes, **kw) if include_top else None

    def forward(self, x: torch.Tensor):
        c = self.config
        b = x.shape[0]
        if x.shape[1] != c.image_size or x.shape[2] != c.image_size:
            raise ValueError(
                f"ViT expects {c.image_size}x{c.image_size} inputs, got "
                f"{x.shape[1]}x{x.shape[2]}")
        # patch embedding: conv PxP stride P == a linear map of each patch;
        # patches in row-major (h, w) order, as the Flax reshape has them
        h = conv2d_tf(x.to(c.dtype).permute(0, 3, 1, 2), self.patch_embed.weight,
                      self.patch_embed.bias, c.patch_size, "VALID")
        h = h.flatten(2).transpose(1, 2)  # [B, N, H]
        cls = self.cls_token.to(c.dtype).expand(b, 1, c.hidden_size)
        h = torch.cat([cls, h], dim=1) + self.pos_embed.to(c.dtype)
        for blk in self.layer:
            h = blk(h)
        h = _layer_norm(h, self.layernorm)
        features = h[:, 0].float()
        if self.classifier is None:
            return features, None
        return features, torch.softmax(linear(h[:, 0], self.classifier).float(), dim=-1)


def vit_b16_builder(include_top: bool = True, dtype: torch.dtype = torch.float32,
                    num_classes: int = 1000) -> ViTModel:
    """Registry-shaped constructor for ViT-B/16 at 224 px, computing in
    ``dtype``."""
    return ViTModel(ViTConfig.b16(dtype=dtype), num_classes=num_classes,
                    include_top=include_top, dtype=dtype)


def init_vit_(module: ViTModel, seed: int = 0) -> ViTModel:
    """The JAX module's initialisation, from a seeded CPU generator:
    lecun-normal patch-conv and dense kernels with zero biases, a zero CLS
    token, N(0, 0.02) position embeddings, LayerNorm scale 1 and bias 0."""
    from sparkdl_torch.models.common import lecun_normal_

    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                w = torch.empty(m.weight.shape, dtype=torch.float32)
                m.weight.copy_(lecun_normal_(w, g))
                m.bias.zero_()
            elif isinstance(m, nn.LayerNorm):
                m.reset_parameters()
        module.cls_token.zero_()
        pos = torch.empty(module.pos_embed.shape, dtype=torch.float32)
        module.pos_embed.copy_(pos.normal_(0.0, 0.02, generator=g))
    return module


# ---------------------------------------------------------------------------
# HuggingFace ViT weights (a torch module, duck-typed) -> this module
# ---------------------------------------------------------------------------

def config_from_hf_vit(hf_config) -> ViTConfig:
    if getattr(hf_config, "hidden_act", "gelu") not in ("gelu",):
        raise ValueError(f"unsupported ViT activation {hf_config.hidden_act!r}")
    return ViTConfig(
        image_size=hf_config.image_size,
        patch_size=hf_config.patch_size,
        hidden_size=hf_config.hidden_size,
        num_layers=hf_config.num_hidden_layers,
        num_heads=hf_config.num_attention_heads,
        intermediate_size=hf_config.intermediate_size,
        layer_norm_eps=hf_config.layer_norm_eps,
        dropout=0.0,
        num_classes=getattr(hf_config, "num_labels", None) or 1000,
    )


_HF_LAYER = (
    ("layernorm_before", "layernorm_before"),
    ("layernorm_after", "layernorm_after"),
    ("attention.query", "attention.attention.query"),
    ("attention.key", "attention.attention.key"),
    ("attention.value", "attention.attention.value"),
    ("attention.output_dense", "attention.output.dense"),
    ("intermediate", "intermediate.dense"),
    ("output", "output.dense"),
)


def load_hf_vit(hf_model) -> "tuple[ViTConfig, dict]":
    """A transformers ``ViTModel`` or ``ViTForImageClassification`` (torch;
    duck-typed, no ``transformers`` import) -> (config, state dict for
    :class:`ViTModel`), the classifier head included where the model has
    one. float32 on the CPU; HF's weights are already in torch's layouts."""
    base = getattr(hf_model, "vit", hf_model)
    cfg = config_from_hf_vit(base.config)
    src = base.state_dict()

    def t(tensor):
        return tensor.detach().to("cpu", torch.float32).contiguous().clone()

    sd = {
        "patch_embed.weight": t(src["embeddings.patch_embeddings.projection.weight"]),
        "patch_embed.bias": t(src["embeddings.patch_embeddings.projection.bias"]),
        "cls_token": t(src["embeddings.cls_token"]),
        "pos_embed": t(src["embeddings.position_embeddings"]),
    }
    for field in ("weight", "bias"):
        sd[f"layernorm.{field}"] = t(src[f"layernorm.{field}"])
        for i in range(cfg.num_layers):
            for ours, theirs in _HF_LAYER:
                sd[f"layer.{i}.{ours}.{field}"] = t(
                    src[f"encoder.layer.{i}.{theirs}.{field}"])
    head = getattr(hf_model, "classifier", None)
    if head is not None and hasattr(head, "weight"):
        sd["classifier.weight"], sd["classifier.bias"] = t(head.weight), t(head.bias)
    return cfg, sd
