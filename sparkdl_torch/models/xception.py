"""Xception as a torch ``nn.Module`` (keras.applications.xception-
equivalent): the port of ``sparkdl_tpu.models.xception``.

Separable convs are a depthwise + pointwise conv pair
(``models/common.sep_conv``), every conv is bias-free, every BN has a
scale and Keras' default eps 1e-3. The stride-2 blocks close with a 3x3/2
SAME max-pool, padded with -inf as TF pads it. As in InceptionV3
(``models/inception.py``), the architecture is written once, in
:func:`_body`, over an ``ops`` object: :class:`_Build` walks it to create
the layers, :class:`_Run` to compute. Each residual 1x1 conv and its BN
are created AFTER their block's body, the Flax module's (and Keras')
order, so ``Namer`` indices line up with the Flax tree.

features = global-average-pooled block14 output (2048-d).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from sparkdl_torch.models.common import (
    Namer,
    conv2d_tf,
    global_avg_pool,
    make_sep_conv,
    max_pool,
    nhwc_to_nchw,
    sep_conv,
)

FEATURE_DIM = 2048


def _body(x, ops):
    relu, bn = ops.relu, ops.bn

    def sep(y, filters):
        return bn(ops.sep(y, filters))

    # -- entry flow ----------------------------------------------------
    x = relu(bn(ops.conv(x, 32, 3, 2, "VALID")))
    x = relu(bn(ops.conv(x, 64, 3, 1, "VALID")))

    # block2: no leading relu on the first sepconv
    y = sep(x, 128)
    y = sep(relu(y), 128)
    res = bn(ops.conv(x, 128, 1, 2))
    x = ops.add(ops.max_pool(y), res)

    for filters in (256, 728):  # blocks 3-4
        y = sep(relu(x), filters)
        y = sep(relu(y), filters)
        res = bn(ops.conv(x, filters, 1, 2))
        x = ops.add(ops.max_pool(y), res)

    # -- middle flow: 8 identity blocks ----------------------------------
    for _ in range(8):
        res = x
        for _ in range(3):
            x = sep(relu(x), 728)
        x = ops.add(x, res)

    # -- exit flow -----------------------------------------------------
    y = sep(relu(x), 728)
    y = sep(relu(y), 1024)
    res = bn(ops.conv(x, 1024, 1, 2))
    x = ops.add(ops.max_pool(y), res)

    x = relu(sep(x, 1536))
    x = relu(sep(x, 2048))
    return ops.global_avg_pool(x)


class _Build:
    """Creates the layers on ``module``; the values are channel counts."""

    def __init__(self, module: nn.Module):
        self.module, self.nm = module, Namer()

    def conv(self, c, filters, kernel, stride=1, padding="SAME"):
        self.module.add_module(self.nm.conv(),
                               nn.Conv2d(c, filters, kernel, bias=False))
        return filters

    def sep(self, c, filters):
        dw, pw = make_sep_conv(c, filters, 3)
        self.module.add_module(self.nm.sepdw(), dw)
        self.module.add_module(self.nm.seppw(), pw)
        return filters

    def bn(self, c):
        self.module.add_module(self.nm.bn(), nn.BatchNorm2d(c, eps=1e-3))
        return c

    @staticmethod
    def add(a, b):
        assert a == b, (a, b)
        return a

    @staticmethod
    def relu(c):
        return c

    max_pool = global_avg_pool = relu


class _Run:
    """Computes with ``module``'s layers, taken in construction order."""

    def __init__(self, module: nn.Module):
        self.module, self.nm = module, Namer()

    def conv(self, x, filters, kernel, stride=1, padding="SAME"):
        m = getattr(self.module, self.nm.conv())
        return conv2d_tf(x, m.weight, None, stride, padding)

    def sep(self, x, filters):
        return sep_conv(x, getattr(self.module, self.nm.sepdw()),
                        getattr(self.module, self.nm.seppw()))

    def bn(self, x):
        m = getattr(self.module, self.nm.bn())
        return F.batch_norm(x, m.running_mean, m.running_var, m.weight, m.bias,
                            False, 0.0, m.eps)

    @staticmethod
    def add(a, b):
        return a + b

    @staticmethod
    def relu(x):
        return torch.relu(x)

    @staticmethod
    def max_pool(x):
        return max_pool(x, 3, 2, "SAME")

    @staticmethod
    def global_avg_pool(x):
        return global_avg_pool(x)


class Xception(nn.Module):
    """``forward(x)``: NHWC [B, H, W, 3] preprocessed images ->
    (features [B, 2048], softmax probabilities or None when
    ``include_top`` is False)."""

    def __init__(self, include_top: bool = True, num_classes: int = 1000):
        super().__init__()
        self.include_top = include_top
        self.num_classes = num_classes
        _body(3, _Build(self))
        if include_top:
            self.add_module("dense000", nn.Linear(FEATURE_DIM, num_classes))

    def forward(self, x: torch.Tensor):
        features = _body(nhwc_to_nchw(x), _Run(self))
        if not self.include_top:
            return features, None
        return features, torch.softmax(self.dense000(features), dim=-1)
