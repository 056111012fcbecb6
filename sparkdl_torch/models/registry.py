"""Named-model registry: metadata + constructors for the zoo.

Each entry records the model's input size, preprocessing mode and
featurization width, and how to build its ``nn.Module``: InceptionV3,
Xception, ResNet50, VGG16, VGG19 and ViT-B/16, the zoo of
``sparkdl_tpu.models.registry``. Weights are a random initialisation from
a seed; pretrained Keras weights ('imagenet', .h5/.keras files) wait for
the Keras side of ROADMAP A3 and raise, and the HF-sourced ViTB16 takes
pretrained weights only through ``models.vit.load_hf_vit``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable

import torch

from sparkdl_torch.ops._dispatch import resolve_device


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


def _entries() -> dict[str, ModelEntry]:
    from sparkdl_torch.models.inception import InceptionV3
    from sparkdl_torch.models.resnet import ResNet50
    from sparkdl_torch.models.vgg import VGG16, VGG19
    from sparkdl_torch.models.vit import init_vit_, vit_b16_builder
    from sparkdl_torch.models.xception import Xception

    entries = [
        ModelEntry("InceptionV3", InceptionV3, (299, 299), "tf", 2048),
        ModelEntry("Xception", Xception, (299, 299), "tf", 2048),
        ModelEntry("ResNet50", functools.partial(ResNet50, device="cpu"),
                   (224, 224), "caffe", 2048),
        ModelEntry("VGG16", VGG16, (224, 224), "caffe", 4096,
                   features_need_top=True),
        ModelEntry("VGG19", VGG19, (224, 224), "caffe", 4096,
                   features_need_top=True),
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


def build_torch_model(name: str, weights: "str | None" = None,
                      include_top: bool = True, device="cuda",
                      seed: int = 0) -> torch.nn.Module:
    """The named model as an eval-mode ``nn.Module`` on ``device``.

    ``weights``: None or 'random' (random init from ``seed``; 'random'
    exists so Spark-ML Param plumbing, where None means "unset", can ask
    for it). 'imagenet' and Keras weight files wait for the Keras side of
    ROADMAP A3 and raise ``NotImplementedError``; an HF-sourced model
    (ViTB16) raises ``ValueError`` for any other weights, as the JAX
    package does.
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
    if weights is not None:
        raise NotImplementedError(
            f"weights={weights!r}: Keras weights ('imagenet', .h5/.keras "
            "files) wait for the Keras side of ROADMAP A3 (keras_loader), "
            "not ported to sparkdl_torch yet; use weights='random'")
    module = entry.builder(include_top=include_top, num_classes=entry.num_classes)
    entry.init(module, seed)
    return module.to(dev).eval()
