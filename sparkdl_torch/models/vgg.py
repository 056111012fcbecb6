"""VGG16 / VGG19 as torch ``nn.Module``s (keras.applications.vgg16/vgg19-
equivalent): the port of ``sparkdl_tpu.models.vgg``.

3x3 SAME convs with biases and ReLU, a 2x2/2 max-pool after each block,
then fc1 and fc2 (4096 each, ReLU) and the classifier. The featurizer's
features are the fc2 activations (4096-d), as the reference exposes them.
Layers are named in construction order (``conv000``, ..., ``dense000``
fc1, ``dense001`` fc2, ``dense002`` the classifier), the Flax zoo's names.

Keras and Flax flatten the last block's output in NHWC order; this module
runs NCHW, so it permutes to NHWC before the flatten, or fc1's converted
weights would multiply the wrong features.
"""

from __future__ import annotations

import torch
from torch import nn

from sparkdl_torch.models.common import (
    Namer,
    conv2d_tf,
    linear,
    max_pool,
    nhwc_to_nchw,
)

FEATURE_DIM = 4096
VGG16_BLOCKS = ((2, 64), (2, 128), (3, 256), (3, 512), (3, 512))
VGG19_BLOCKS = ((2, 64), (2, 128), (4, 256), (4, 512), (4, 512))
#: the flattened last block at the 224 px input: 7 x 7 x 512
FLAT_DIM = 7 * 7 * 512


class _VGG(nn.Module):
    """``forward(x)``: NHWC [B, 224, 224, 3] -> (fc2 features [B, 4096],
    softmax probabilities or None when ``include_top`` is False), in
    ``dtype``."""

    blocks: tuple[tuple[int, int], ...] = ()

    def __init__(self, include_top: bool = True, num_classes: int = 1000,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.include_top = include_top
        self.num_classes = num_classes
        self.dtype = dtype
        nm = Namer()
        cin = 3
        for n_convs, filters in self.blocks:
            for _ in range(n_convs):
                self.add_module(nm.conv(), nn.Conv2d(cin, filters, 3))
                cin = filters
        self.add_module(nm.dense(), nn.Linear(FLAT_DIM, FEATURE_DIM))  # fc1
        self.add_module(nm.dense(), nn.Linear(FEATURE_DIM, FEATURE_DIM))  # fc2
        if include_top:
            self.add_module(nm.dense(), nn.Linear(FEATURE_DIM, num_classes))

    def forward(self, x: torch.Tensor):
        nm = Namer()
        y = nhwc_to_nchw(x).to(self.dtype)
        for n_convs, _ in self.blocks:
            for _ in range(n_convs):
                m = getattr(self, nm.conv())
                y = torch.relu(conv2d_tf(y, m.weight, m.bias))
            y = max_pool(y, 2, 2)
        y = y.permute(0, 2, 3, 1).flatten(1)  # Keras' row-major HWC flatten
        y = torch.relu(linear(y, getattr(self, nm.dense())))
        features = torch.relu(linear(y, getattr(self, nm.dense())))
        if not self.include_top:
            return features, None
        logits = linear(features, getattr(self, nm.dense()))
        return features, torch.softmax(logits, dim=-1)


class VGG16(_VGG):
    blocks = VGG16_BLOCKS


class VGG19(_VGG):
    blocks = VGG19_BLOCKS
