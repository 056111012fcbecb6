"""Plain PyTorch building blocks of the references, on NCHW tensors.

A frozen copy of the zoo helpers the two references need (TF "SAME"
padding, eval and train-mode BatchNorm with Keras/Flax semantics, the
pools), so that the yardstick does not move when the program's helpers
change. Nothing here imports the program.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-3       # Keras' BatchNormalization default (InceptionV3)
BN_MOMENTUM = 0.99  # running = 0.99 * running + 0.01 * batch


class Namer:
    """Construction-order names for weight-bearing layers: ``conv000``,
    ``bn000``, ``dense000``, ..."""

    def __init__(self) -> None:
        self._counts: dict[str, int] = {}

    def next(self, kind: str) -> str:
        i = self._counts.get(kind, 0)
        self._counts[kind] = i + 1
        return f"{kind}{i:03d}"

    def conv(self) -> str:
        return self.next("conv")

    def bn(self) -> str:
        return self.next("bn")


def same_padding(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """TF "SAME" padding (before, after) along one axis: at stride 2 the
    extra pixel goes after."""
    out = math.ceil(size / stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def pair(v) -> tuple[int, int]:
    return (v, v) if isinstance(v, int) else (int(v[0]), int(v[1]))


def _same_pads(x: torch.Tensor, kernel, stride):
    (kh, kw), (sh, sw) = pair(kernel), pair(stride)
    top, bottom = same_padding(x.shape[-2], kh, sh)
    left, right = same_padding(x.shape[-1], kw, sw)
    return left, right, top, bottom


def conv2d_tf(x, weight, bias=None, stride=1, padding: str = "SAME"):
    """``F.conv2d`` with TF padding semantics ("SAME" or "VALID")."""
    if padding == "VALID":
        return F.conv2d(x, weight, bias, stride)
    left, right, top, bottom = _same_pads(x, tuple(weight.shape[-2:]), stride)
    if top == bottom and left == right:
        return F.conv2d(x, weight, bias, stride, padding=(top, left))
    return F.conv2d(F.pad(x, (left, right, top, bottom)), weight, bias, stride)


def make_conv_bn(c_in: int, c_out: int, kernel: tuple[int, int]):
    """A bias-free conv and a scale-free BatchNorm (Keras' ``scale=False``:
    the BN weight stays 1 and takes no gradient)."""
    conv = nn.Conv2d(c_in, c_out, kernel, bias=False)
    bn = nn.BatchNorm2d(c_out, eps=BN_EPS, momentum=0.01)
    bn.weight.requires_grad_(False)
    return conv, bn


def bn_eval(x, bn: nn.BatchNorm2d):
    """BatchNorm on its running statistics."""
    return F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight,
                        bn.bias, False, 0.0, bn.eps)


def conv_bn_relu(x, conv, bn, stride=1, padding="SAME"):
    return torch.relu(bn_eval(conv2d_tf(x, conv.weight, None, stride, padding), bn))


def max_pool(x, window=3, strides=2):
    """VALID max pool."""
    return F.max_pool2d(x, pair(window), pair(strides))


def avg_pool_same(x, window=3):
    """Keras' stride-1 "SAME" average pool: padded cells are left out of
    the divisor."""
    pad = (window - 1) // 2
    return F.avg_pool2d(x, window, 1, padding=pad, count_include_pad=False)


def global_avg_pool(x):
    return x.mean(dim=(2, 3))


def zero_pad(x, pad: int):
    return F.pad(x, (pad, pad, pad, pad))


def nhwc_to_nchw(x):
    return x.permute(0, 3, 1, 2)


def bn_moments(x, dims):
    """Batch mean and biased variance as Flax takes them: E[x^2] - E[x]^2,
    clamped at 0."""
    mean = x.mean(dim=dims)
    var = torch.clamp((x * x).mean(dim=dims) - mean * mean, min=0.0)
    return mean, var


def move_running_stats(bn: nn.BatchNorm2d, mean, var) -> None:
    """One training step's move of the running statistics, in place."""
    m = BN_MOMENTUM
    with torch.no_grad():
        bn.running_mean.copy_(m * bn.running_mean + (1 - m) * mean.detach())
        bn.running_var.copy_(m * bn.running_var + (1 - m) * var.detach())
