"""InceptionV3 as a torch ``nn.Module`` (keras.applications-equivalent).

The featurizer's flagship model. Every conv is bias-free and every BN is
scale-free, as in the Keras original. The architecture is written once,
in :func:`_body`, over an ``ops`` object: :class:`_Build` walks it to
create the layers (tracking only channel counts), :class:`_Run` walks it
again to compute. Layers are named in construction order (``conv000``,
``bn000``, ..., ``dense000``), the Flax zoo's names, so converted weights
line up key for key. Concatenation order == construction order.

features = global-average-pooled mixed10 output (2048-d). ``dtype`` is
the compute dtype (the parameters stay float32), as the Flax module's.
"""

from __future__ import annotations

import torch
from torch import nn

from sparkdl_torch.models.common import (
    Namer,
    avg_pool_keras,
    conv_bn_relu,
    global_avg_pool,
    linear,
    make_conv_bn,
    max_pool,
    nhwc_to_nchw,
)

FEATURE_DIM = 2048


def _body(x, ops):
    cb, concat = ops.cb, ops.concat

    # -- stem ----------------------------------------------------------
    x = cb(x, 32, 3, 3, strides=2, padding="VALID")
    x = cb(x, 32, 3, 3, padding="VALID")
    x = cb(x, 64, 3, 3)
    x = ops.max_pool(x)
    x = cb(x, 80, 1, 1, padding="VALID")
    x = cb(x, 192, 3, 3, padding="VALID")
    x = ops.max_pool(x)

    # -- 3x inception-A (35x35), mixed0..2 -----------------------------
    for pool_filters in (32, 64, 64):
        b1 = cb(x, 64, 1, 1)
        b5 = cb(x, 48, 1, 1)
        b5 = cb(b5, 64, 5, 5)
        b3 = cb(x, 64, 1, 1)
        b3 = cb(b3, 96, 3, 3)
        b3 = cb(b3, 96, 3, 3)
        bp = ops.avg_pool(x)
        bp = cb(bp, pool_filters, 1, 1)
        x = concat(b1, b5, b3, bp)

    # -- reduction-A, mixed3 -------------------------------------------
    b3 = cb(x, 384, 3, 3, strides=2, padding="VALID")
    bd = cb(x, 64, 1, 1)
    bd = cb(bd, 96, 3, 3)
    bd = cb(bd, 96, 3, 3, strides=2, padding="VALID")
    bp = ops.max_pool(x)
    x = concat(b3, bd, bp)

    # -- 4x inception-B (17x17), mixed4..7 -----------------------------
    for mid in (128, 160, 160, 192):
        b1 = cb(x, 192, 1, 1)
        b7 = cb(x, mid, 1, 1)
        b7 = cb(b7, mid, 1, 7)
        b7 = cb(b7, 192, 7, 1)
        bd = cb(x, mid, 1, 1)
        bd = cb(bd, mid, 7, 1)
        bd = cb(bd, mid, 1, 7)
        bd = cb(bd, mid, 7, 1)
        bd = cb(bd, 192, 1, 7)
        bp = ops.avg_pool(x)
        bp = cb(bp, 192, 1, 1)
        x = concat(b1, b7, bd, bp)

    # -- reduction-B, mixed8 -------------------------------------------
    b3 = cb(x, 192, 1, 1)
    b3 = cb(b3, 320, 3, 3, strides=2, padding="VALID")
    b7 = cb(x, 192, 1, 1)
    b7 = cb(b7, 192, 1, 7)
    b7 = cb(b7, 192, 7, 1)
    b7 = cb(b7, 192, 3, 3, strides=2, padding="VALID")
    bp = ops.max_pool(x)
    x = concat(b3, b7, bp)

    # -- 2x inception-C (8x8), mixed9..10 ------------------------------
    for _ in range(2):
        b1 = cb(x, 320, 1, 1)
        b3 = cb(x, 384, 1, 1)
        b3a = cb(b3, 384, 1, 3)
        b3b = cb(b3, 384, 3, 1)
        b3 = concat(b3a, b3b)
        bd = cb(x, 448, 1, 1)
        bd = cb(bd, 384, 3, 3)
        bda = cb(bd, 384, 1, 3)
        bdb = cb(bd, 384, 3, 1)
        bd = concat(bda, bdb)
        bp = ops.avg_pool(x)
        bp = cb(bp, 192, 1, 1)
        x = concat(b1, b3, bd, bp)

    return ops.global_avg_pool(x)


class _Build:
    """Creates the layers on ``module``; the values are channel counts."""

    def __init__(self, module: nn.Module):
        self.module, self.nm = module, Namer()

    def cb(self, c, filters, kh, kw, strides=1, padding="SAME"):
        conv, bn = make_conv_bn(c, filters, (kh, kw))
        self.module.add_module(self.nm.conv(), conv)
        self.module.add_module(self.nm.bn(), bn)
        return filters

    @staticmethod
    def concat(*cs):
        return sum(cs)

    @staticmethod
    def max_pool(c):
        return c

    avg_pool = global_avg_pool = max_pool


class _Run:
    """Computes with ``module``'s layers, taken in construction order."""

    def __init__(self, module: nn.Module):
        self.module, self.nm = module, Namer()

    def cb(self, x, filters, kh, kw, strides=1, padding="SAME"):
        conv = getattr(self.module, self.nm.conv())
        bn = getattr(self.module, self.nm.bn())
        return conv_bn_relu(x, conv, bn, strides, padding)

    @staticmethod
    def concat(*xs):
        return torch.cat(xs, dim=1)

    @staticmethod
    def max_pool(x):
        return max_pool(x, 3, 2, "VALID")

    @staticmethod
    def avg_pool(x):
        return avg_pool_keras(x, 3, 1, "SAME")

    @staticmethod
    def global_avg_pool(x):
        return global_avg_pool(x)


class InceptionV3(nn.Module):
    """``forward(x)``: NHWC [B, H, W, 3] preprocessed images ->
    (features [B, 2048], softmax probabilities [B, num_classes] or None
    when ``include_top`` is False) — the Flax module's return, in
    ``dtype``."""

    def __init__(self, include_top: bool = True, num_classes: int = 1000,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.include_top = include_top
        self.num_classes = num_classes
        self.dtype = dtype
        _body(3, _Build(self))
        if include_top:
            self.add_module("dense000", nn.Linear(FEATURE_DIM, num_classes))

    def forward(self, x: torch.Tensor):
        features = _body(nhwc_to_nchw(x).to(self.dtype), _Run(self))
        if not self.include_top:
            return features, None
        return features, torch.softmax(linear(features, self.dense000), dim=-1)
