"""Plain ResNet50 (``keras.applications.ResNet50``), float32.

He et al., "Deep Residual Learning for Image Recognition",
arXiv:1512.03385, as Keras builds it: the v1 bottleneck with the stride
on each stage's first 1x1 conv, conv biases on, BatchNorm eps 1.001e-5,
stem ``zero_pad(3)`` -> 7x7/2 VALID conv -> BN -> ReLU -> ``zero_pad(1)``
-> 3x3/2 max-pool, global average pool, a 1000-way softmax head. Layers
are named in construction order (per block: the 1x1, the 3x3, the
shortcut's 1x1 where there is one, the closing 1x1), so a state dict made
for this module loads into the program's module key for key.

In training every BatchNorm normalizes with its batch's mean and biased
variance (E[x^2] - E[x]^2) and moves its running statistics by 0.01 of
the way, as Flax does. The loss is the mean negative log of the softmax
probability of the label, probabilities clamped at 1e-8. A frozen copy:
it imports nothing of the program.
"""

from __future__ import annotations

import torch
from torch import nn

from benchmark.reference.common import (
    Namer,
    bn_eval,
    bn_moments,
    conv2d_tf,
    global_avg_pool,
    max_pool,
    move_running_stats,
    nhwc_to_nchw,
    zero_pad,
)

BN_EPS = 1.001e-5
FEATURE_DIM = 2048
#: (filters, blocks, stride) per stage
STAGES = ((64, 3, 1), (128, 4, 2), (256, 6, 2), (512, 3, 2))
CAFFE_MEAN_BGR = (103.939, 116.779, 123.68)


class ResNet50(nn.Module):
    def __init__(self, include_top: bool = True, num_classes: int = 1000):
        super().__init__()
        self.include_top = include_top
        nm = Namer()

        def conv_bn(cin, cout, k):
            self.add_module(nm.conv(), nn.Conv2d(cin, cout, k))
            self.add_module(nm.bn(), nn.BatchNorm2d(cout, eps=BN_EPS))

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
            self.dense000 = nn.Linear(FEATURE_DIM, num_classes)

    def forward(self, x: torch.Tensor, train: bool = False):
        """NHWC [B, H, W, 3] preprocessed images -> (features [B, 2048],
        probabilities [B, classes] or None without the head)."""
        nm = Namer()

        def conv(y, stride=1, padding="SAME"):
            m = getattr(self, nm.conv())
            return conv2d_tf(y, m.weight, m.bias, stride, padding)

        def bn(y):
            m = getattr(self, nm.bn())
            if not train:
                return bn_eval(y, m)
            mean, var = bn_moments(y, (0, 2, 3))
            move_running_stats(m, mean, var)
            inv = torch.rsqrt(var + m.eps)
            return ((y - mean[:, None, None]) * (inv * m.weight)[:, None, None]
                    + m.bias[:, None, None])

        y = zero_pad(nhwc_to_nchw(x), 3)
        y = torch.relu(bn(conv(y, 2, "VALID")))
        y = max_pool(zero_pad(y, 1), 3, 2)
        for _, blocks, stride in STAGES:
            for i in range(blocks):
                s = stride if i == 0 else 1
                z = torch.relu(bn(conv(y, s)))
                z = torch.relu(bn(conv(z)))
                sc = bn(conv(y, s)) if i == 0 else y
                y = torch.relu(bn(conv(z)) + sc)
        feats = global_avg_pool(y)
        if not self.include_top:
            return feats, None
        return feats, torch.softmax(self.dense000(feats), dim=-1)


def build(include_top: bool = False) -> nn.Module:
    return ResNet50(include_top=include_top).eval()


def preprocess(rgb: torch.Tensor) -> torch.Tensor:
    """Keras' ``preprocess_input`` in mode 'caffe': RGB -> BGR, minus the
    ImageNet channel means, no scaling."""
    mean = torch.tensor(CAFFE_MEAN_BGR, dtype=rgb.dtype, device=rgb.device)
    return rgb.flip(-1) - mean


@torch.no_grad()
def features(module: nn.Module, rgb: torch.Tensor) -> torch.Tensor:
    """Features of NHWC RGB float32 pixels in [0, 255]."""
    return module(preprocess(rgb))[0]


def loss(module: nn.Module, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The training loss of one batch (x already preprocessed, NHWC);
    moves the running statistics."""
    _, probs = module(x, train=True)
    logp = torch.log(torch.clamp(probs, min=1e-8))
    return -torch.gather(logp, 1, y.long()[:, None]).mean()
