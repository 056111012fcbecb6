"""Named-model registry: metadata + constructors for the zoo.

Each entry records the model's input size, preprocessing mode and
featurization width, and how to build its ``nn.Module``. The port has
InceptionV3 with random initialisation; pretrained weights and the other
zoo models are not ported yet (see ROADMAP.md) and raise when asked for.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from sparkdl_torch.ops._dispatch import resolve_device


@dataclasses.dataclass(frozen=True)
class ModelEntry:
    name: str
    builder: Callable[..., Any]
    input_size: tuple[int, int]
    preprocess: str  # key into sparkdl_torch.ops.preprocess.PREPROCESSORS
    feature_dim: int
    num_classes: int = 1000


def _entries() -> dict[str, ModelEntry]:
    from sparkdl_torch.models.inception import InceptionV3

    return {"InceptionV3": ModelEntry("InceptionV3", InceptionV3, (299, 299),
                                      "tf", 2048)}


SUPPORTED_MODELS = ("InceptionV3",)
#: zoo models of sparkdl_tpu that this package does not have yet
NOT_YET_PORTED = ("Xception", "ResNet50", "VGG16", "VGG19", "ViTB16")


def get_entry(name: str) -> ModelEntry:
    if name in NOT_YET_PORTED:
        raise NotImplementedError(
            f"model {name!r} is not ported to sparkdl_torch yet (see "
            f"ROADMAP.md); supported: {list(SUPPORTED_MODELS)}"
        )
    entries = _entries()
    if name not in entries:
        raise ValueError(f"unknown model {name!r}; supported: {sorted(entries)}")
    return entries[name]


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


def build_torch_model(name: str, weights: "str | None" = None,
                      include_top: bool = True, device="cuda",
                      seed: int = 0) -> torch.nn.Module:
    """The named model as an eval-mode ``nn.Module`` on ``device``.

    ``weights``: None or 'random' (random init from ``seed``). 'imagenet'
    and weight files are not ported yet and raise.
    """
    entry = get_entry(name)
    dev = resolve_device(device)
    if weights not in (None, "random"):
        raise NotImplementedError(
            f"weights={weights!r}: pretrained weights are not ported to "
            "sparkdl_torch yet (see ROADMAP.md); use weights='random'"
        )
    module = entry.builder(include_top=include_top, num_classes=entry.num_classes)
    init_random_(module, seed)
    return module.to(dev).eval()
