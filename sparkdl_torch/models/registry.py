"""Named-model registry: metadata + constructors for the zoo.

Each entry records the model's input size, preprocessing mode and
featurization width, and how to build both its ``nn.Module`` and the Keras
original (for weight conversion): InceptionV3, Xception, ResNet50, VGG16,
VGG19 and ViT-B/16, the zoo of ``sparkdl_tpu.models.registry``. Weight
resolution order:

  1. an explicit .h5/.keras file given by the caller,
  2. keras.applications pretrained weights if cached locally
     (zero-egress environments fall back to 3, with a warning),
  3. random init from a seed (weights=None or 'random').

The HF-sourced ViTB16 takes pretrained weights only through
``models.vit.load_hf_vit``.
"""

from __future__ import annotations

import dataclasses
import functools
import logging
from typing import Any, Callable

import torch

from sparkdl_torch.ops._dispatch import resolve_device

logger = logging.getLogger(__name__)


def init_random_(module: torch.nn.Module, seed: int = 0) -> torch.nn.Module:
    """Flax's default initialisation from a seeded generator: lecun-normal
    conv/dense kernels, zero biases, BN mean 0 / var 1 (and unit weight)."""
    from sparkdl_torch.models.common import lecun_normal_

    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear)):
                lecun_normal_(m.weight, g)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, torch.nn.BatchNorm2d):
                m.reset_parameters()
    return module


@dataclasses.dataclass(frozen=True)
class ModelEntry:
    name: str
    builder: Callable[..., Any]
    input_size: tuple[int, int]
    preprocess: str  # key into sparkdl_torch.ops.preprocess.PREPROCESSORS
    feature_dim: int
    num_classes: int = 1000
    #: models whose featurization layer is part of the Keras classifier
    #: head (VGG's fc2): the named-image transformers build them with it
    features_need_top: bool = False
    #: pretrained-weight source: "keras" (keras.applications) or "hf" (a
    #: transformers model through the family's load_hf_* converter)
    source: str = "keras"
    #: random initialisation (module, seed) -> module
    init: Callable[..., Any] = init_random_
    #: "module:attr" inside keras.applications ("" for HF-sourced models)
    keras_builder_path: str = ""
    #: per-type layer ordering for weight conversion (see keras_loader)
    layer_order: str = "topo"


def _entries() -> dict[str, ModelEntry]:
    from sparkdl_torch.models.inception import InceptionV3
    from sparkdl_torch.models.resnet import ResNet50
    from sparkdl_torch.models.vgg import VGG16, VGG19
    from sparkdl_torch.models.vit import init_vit_, vit_b16_builder
    from sparkdl_torch.models.xception import Xception

    entries = [
        ModelEntry("InceptionV3", InceptionV3, (299, 299), "tf", 2048,
                   keras_builder_path="inception_v3:InceptionV3",
                   layer_order="auto_suffix"),
        ModelEntry("Xception", Xception, (299, 299), "tf", 2048,
                   keras_builder_path="xception:Xception"),
        ModelEntry("ResNet50", functools.partial(ResNet50, device="cpu"),
                   (224, 224), "caffe", 2048, keras_builder_path="resnet:ResNet50"),
        ModelEntry("VGG16", VGG16, (224, 224), "caffe", 4096,
                   features_need_top=True, keras_builder_path="vgg16:VGG16"),
        ModelEntry("VGG19", VGG19, (224, 224), "caffe", 4096,
                   features_need_top=True, keras_builder_path="vgg19:VGG19"),
        # HF ViT's default image processing (rescale 1/255, normalize
        # mean=std=0.5) is exactly the "tf" preprocess mode
        ModelEntry("ViTB16", vit_b16_builder, (224, 224), "tf", 768,
                   source="hf", init=init_vit_),
    ]
    return {e.name: e for e in entries}


SUPPORTED_MODELS = ("InceptionV3", "Xception", "ResNet50", "VGG16",
                    "VGG19", "ViTB16")


def get_entry(name: str) -> ModelEntry:
    entries = _entries()
    if name not in entries:
        raise ValueError(f"unknown model {name!r}; supported: {sorted(entries)}")
    return entries[name]


def build_keras_model(entry: ModelEntry, weights: "str | None" = "imagenet",
                      include_top: bool = True):
    """Build the keras.applications original (for conversion and oracles).

    Falls back to random weights when pretrained ones are not cached and
    cannot be downloaded (zero-egress), with a warning.
    """
    import importlib

    if entry.source != "keras":
        raise ValueError(
            f"model {entry.name} has no keras.applications source "
            f"(source={entry.source!r}); use the family's load_hf_* "
            "converter for pretrained weights"
        )
    mod_name, attr = entry.keras_builder_path.split(":")
    builder = getattr(importlib.import_module(f"keras.applications.{mod_name}"), attr)
    try:
        return builder(weights=weights, include_top=include_top)
    except Exception as e:  # Keras raises a bare Exception for a failed download
        if weights is None:
            raise
        logger.warning(
            "could not load %s pretrained weights (%s); using random init",
            entry.name, e,
        )
        return builder(weights=None, include_top=include_top)


def build_torch_model(name: str, weights: "str | None" = None,
                      dtype: "torch.dtype | None" = None, include_top: bool = True,
                      device="cuda", seed: int = 0) -> torch.nn.Module:
    """The named model as an eval-mode ``nn.Module`` on ``device``,
    computing in ``dtype`` (float32 when None; parameters are float32).

    ``weights``: 'imagenet' (keras.applications' weights, random-init
    Keras weights with a warning where they are not cached), a path to a
    Keras .h5/.keras file, or None / 'random' (random init from ``seed``;
    'random' exists so Spark-ML Param plumbing, where None means "unset",
    can ask for it). Keras weights go through ``models/keras_loader``:
    a classifier head the module does not build is dropped, and any other
    name or shape that disagrees raises. An HF-sourced model (ViTB16)
    raises ``ValueError`` for any weights but random, as the JAX package
    does.
    """
    entry = get_entry(name)
    dev = resolve_device(device)
    if weights == "random":
        weights = None
    if entry.source == "hf" and weights is not None:
        raise ValueError(
            f"model {name} sources pretrained weights from HF: "
            f"weights={weights!r} has no keras.applications loader. Pass "
            "weights='random' (or None) for random init, or convert a "
            "transformers model with the family's load_hf_* converter "
            "(models.vit.load_hf_vit)")
    module = entry.builder(include_top=include_top, num_classes=entry.num_classes,
                           dtype=torch.float32 if dtype is None else dtype)
    if weights is None:
        entry.init(module, seed)
    else:
        from sparkdl_torch.models.keras_loader import load_keras_weights, read_keras_model

        if weights == "imagenet":
            # Keras' VGG builds fc1/fc2 only with its top
            top = include_top or entry.features_need_top
            source = build_keras_model(entry, weights=weights, include_top=top)
        else:
            source = weights
        load_keras_weights(module, read_keras_model(source), entry.layer_order)
    return module.to(dev).eval()
