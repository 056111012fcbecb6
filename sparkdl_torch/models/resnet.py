"""ResNet50 as a torch ``nn.Module`` (keras.applications.resnet.ResNet50-
equivalent): the port of ``sparkdl_tpu.models.resnet``.

The original v1 bottleneck ResNet as Keras builds it: stride on the first
1x1 conv of each stage's first block, conv biases on, BatchNorm eps
1.001e-5, stem ``zero_pad(3)`` -> 7x7/2 VALID conv -> BN -> ReLU ->
``zero_pad(1)`` -> 3x3/2 max-pool. Layers are named in construction order
(``conv000``, ``bn000``, ..., ``dense000``) with the Flax module's order
(per block: 1x1, 3x3, the shortcut's 1x1 where there is one, the closing
1x1), so ``models/convert.flax_to_torch`` loads the Flax tree key for key.

Parameters are created on ``device`` (``cuda`` unless the caller passes
``device="cpu"``) with torch's default init; use
``models/common.init_zoo_`` for Flax's, or load a converted state dict.

``forward(x, train=False)`` takes NHWC [B, H, W, 3] and returns (features
[B, 2048], softmax probabilities or None without the top). With
``train=True`` every BatchNorm normalizes with its batch moments and its
running statistics move as Flax moves them (``models/common.py``), in
place.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from sparkdl_torch.models.common import (
    Namer,
    bn_moments,
    bn_scale_shift,
    conv2d_tf,
    global_avg_pool,
    max_pool,
    moved_running_stats,
    nhwc_to_nchw,
    set_running_stats,
    zero_pad,
)
from sparkdl_torch.ops._dispatch import resolve_device

BN_EPS = 1.001e-5
FEATURE_DIM = 2048
#: (filters, blocks, stride) per stage
STAGES = ((64, 3, 1), (128, 4, 2), (256, 6, 2), (512, 3, 2))


class ResNet50(nn.Module):
    """Returns (features, probs); probs is None when include_top=False."""

    def __init__(self, include_top: bool = True, num_classes: int = 1000, *,
                 device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.include_top = include_top
        self.num_classes = num_classes
        nm = Namer()

        def conv_bn(cin, cout, k):
            self.add_module(nm.conv(), nn.Conv2d(cin, cout, k, device=dev))
            self.add_module(nm.bn(), nn.BatchNorm2d(cout, eps=BN_EPS, device=dev))

        conv_bn(3, 64, 7)
        cin = 64
        for filters, blocks, _ in STAGES:
            for i in range(blocks):
                conv_bn(cin, filters, 1)
                conv_bn(filters, filters, 3)
                if i == 0:
                    conv_bn(cin, 4 * filters, 1)
                conv_bn(filters, 4 * filters, 1)
                cin = 4 * filters
        if include_top:
            self.add_module("dense000", nn.Linear(FEATURE_DIM, num_classes,
                                                  device=dev))

    def forward(self, x: torch.Tensor, train: bool = False):
        nm = Namer()

        def conv(y, stride=1, padding="SAME"):
            m = getattr(self, nm.conv())
            return conv2d_tf(y, m.weight, m.bias, stride, padding)

        def bn(y):
            m = getattr(self, nm.bn())
            if not train:
                return F.batch_norm(y, m.running_mean, m.running_var, m.weight,
                                    m.bias, False, 0.0, m.eps)
            mean, var = bn_moments(y, (0, 2, 3))
            set_running_stats(m, moved_running_stats(m, mean, var))
            scale, shift = bn_scale_shift(m, mean, var)
            return y * scale[:, None, None] + shift[:, None, None]

        y = zero_pad(nhwc_to_nchw(x), 3)
        y = torch.relu(bn(conv(y, 2, "VALID")))
        y = max_pool(zero_pad(y, 1), 3, 2)
        for filters, blocks, stride in STAGES:
            for i in range(blocks):
                s = stride if i == 0 else 1
                z = torch.relu(bn(conv(y, s)))
                z = torch.relu(bn(conv(z)))
                sc = bn(conv(y, s)) if i == 0 else y
                y = torch.relu(bn(conv(z)) + sc)
        features = global_avg_pool(y)
        if not self.include_top:
            return features, None
        return features, torch.softmax(self.dense000(features), dim=-1)
