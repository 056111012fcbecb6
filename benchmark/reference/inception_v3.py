"""Plain InceptionV3 (``keras.applications.InceptionV3``), float32.

Szegedy et al., "Rethinking the Inception Architecture for Computer
Vision", arXiv:1512.00567, as Keras builds it: every conv bias-free, every
BatchNorm scale-free (eps 1e-3), features the global-average-pooled
mixed10 output (2048-d). Layers are named in construction order
(``conv000``, ``bn000``, ...), so a state dict made for this module loads
into the program's module key for key. The architecture is written once,
in :func:`body`, over an ``ops`` object: :class:`_Build` creates the
layers, :class:`_Run` computes, and ``benchmark/flops.py`` walks it for
the operation count. A frozen copy: it imports nothing of the program.
"""

from __future__ import annotations

import torch
from torch import nn

from benchmark.reference.common import (
    Namer,
    avg_pool_same,
    conv_bn_relu,
    global_avg_pool,
    make_conv_bn,
    max_pool,
    nhwc_to_nchw,
)

FEATURE_DIM = 2048


def body(x, ops):
    cb, concat = ops.cb, ops.concat

    # stem
    x = cb(x, 32, 3, 3, strides=2, padding="VALID")
    x = cb(x, 32, 3, 3, padding="VALID")
    x = cb(x, 64, 3, 3)
    x = ops.max_pool(x)
    x = cb(x, 80, 1, 1, padding="VALID")
    x = cb(x, 192, 3, 3, padding="VALID")
    x = ops.max_pool(x)

    # 3x inception-A (35x35), mixed0..2
    for pool_filters in (32, 64, 64):
        b1 = cb(x, 64, 1, 1)
        b5 = cb(x, 48, 1, 1)
        b5 = cb(b5, 64, 5, 5)
        b3 = cb(x, 64, 1, 1)
        b3 = cb(b3, 96, 3, 3)
        b3 = cb(b3, 96, 3, 3)
        bp = cb(ops.avg_pool(x), pool_filters, 1, 1)
        x = concat(b1, b5, b3, bp)

    # reduction-A, mixed3
    b3 = cb(x, 384, 3, 3, strides=2, padding="VALID")
    bd = cb(x, 64, 1, 1)
    bd = cb(bd, 96, 3, 3)
    bd = cb(bd, 96, 3, 3, strides=2, padding="VALID")
    x = concat(b3, bd, ops.max_pool(x))

    # 4x inception-B (17x17), mixed4..7
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
        bp = cb(ops.avg_pool(x), 192, 1, 1)
        x = concat(b1, b7, bd, bp)

    # reduction-B, mixed8
    b3 = cb(x, 192, 1, 1)
    b3 = cb(b3, 320, 3, 3, strides=2, padding="VALID")
    b7 = cb(x, 192, 1, 1)
    b7 = cb(b7, 192, 1, 7)
    b7 = cb(b7, 192, 7, 1)
    b7 = cb(b7, 192, 3, 3, strides=2, padding="VALID")
    x = concat(b3, b7, ops.max_pool(x))

    # 2x inception-C (8x8), mixed9..10
    for _ in range(2):
        b1 = cb(x, 320, 1, 1)
        b3 = cb(x, 384, 1, 1)
        b3 = concat(cb(b3, 384, 1, 3), cb(b3, 384, 3, 1))
        bd = cb(x, 448, 1, 1)
        bd = cb(bd, 384, 3, 3)
        bd = concat(cb(bd, 384, 1, 3), cb(bd, 384, 3, 1))
        bp = cb(ops.avg_pool(x), 192, 1, 1)
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
        return max_pool(x, 3, 2)

    @staticmethod
    def avg_pool(x):
        return avg_pool_same(x, 3)

    @staticmethod
    def global_avg_pool(x):
        return global_avg_pool(x)


class InceptionV3(nn.Module):
    """``forward(x)``: NHWC [B, H, W, 3] preprocessed images -> features
    [B, 2048] (no classifier head: the featurizer's model)."""

    def __init__(self):
        super().__init__()
        body(3, _Build(self))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return body(nhwc_to_nchw(x), _Run(self))


def build() -> nn.Module:
    return InceptionV3().eval()


def preprocess(rgb: torch.Tensor) -> torch.Tensor:
    """Keras' ``preprocess_input`` in mode 'tf': [0, 255] -> [-1, 1]."""
    return rgb / 127.5 - 1.0


@torch.no_grad()
def features(module: nn.Module, rgb: torch.Tensor) -> torch.Tensor:
    """Features of NHWC RGB float32 pixels in [0, 255]."""
    return module(preprocess(rgb))
