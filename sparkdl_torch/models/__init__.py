"""The port's models: the zoo registry and the GPT, BERT and ViT families
as ``torch.nn`` modules (the reference's Flax modules), with their
Hugging Face loaders. ``models.registry`` is the zoo's module."""

from sparkdl_torch.models.registry import (
    SUPPORTED_MODELS,
    ModelEntry,
    build_keras_model,
    build_torch_model,
    get_entry,
)
from sparkdl_torch.models.gpt import (
    GPTConfig,
    GPTLMHeadModel,
    config_from_hf_gpt2,
    generate,
    init_cache,
    load_hf_gpt2,
)
from sparkdl_torch.models.bert import (
    BertConfig,
    BertForSequenceClassification,
    BertModel,
    config_from_hf,
    load_hf_bert,
)
from sparkdl_torch.models.vit import (
    ViTConfig,
    ViTModel,
    config_from_hf_vit,
    load_hf_vit,
)

__all__ = [
    "SUPPORTED_MODELS",
    "ModelEntry",
    "build_keras_model",
    "build_torch_model",
    "get_entry",
    "GPTConfig",
    "GPTLMHeadModel",
    "config_from_hf_gpt2",
    "generate",
    "init_cache",
    "load_hf_gpt2",
    "BertConfig",
    "BertForSequenceClassification",
    "BertModel",
    "config_from_hf",
    "load_hf_bert",
    "ViTConfig",
    "ViTModel",
    "config_from_hf_vit",
    "load_hf_vit",
]
