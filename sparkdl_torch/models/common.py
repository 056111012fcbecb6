"""Shared building blocks for the named-model zoo, on NCHW tensors.

Every weight-bearing layer is named by construction order (``conv000``,
``bn000``, ``dense000``, ...) via :class:`Namer`, the same names and order
as the Flax zoo of ``sparkdl_tpu``, so weights convert key by key
(``models/convert.py``). Public model functions take NHWC like the JAX
package; inside, tensors are NCHW in ``channels_last`` memory format.

The compute dtype is the activations' dtype: the helpers cast float32
parameters to it at the op (Flax's ``dtype`` with ``param_dtype=float32``),
and BatchNorm normalizes in float32 and rounds its output back, as Flax's
does. A float32 input runs exactly the float32 ops.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-3  # Keras' BatchNormalization default, as the zoo uses


class Namer:
    """Construction-order names for weight-bearing layers."""

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

    def dense(self) -> str:
        return self.next("dense")

    def sepdw(self) -> str:
        return self.next("sepdw")

    def seppw(self) -> str:
        return self.next("seppw")


def same_padding(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """TF "SAME" padding (before, after) along one axis. At stride 2 it is
    asymmetric (the extra pixel goes after), where torch's ``padding=``
    is always symmetric."""
    out = math.ceil(size / stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def pair(v) -> tuple[int, int]:
    """An int or an (h, w) pair as an (h, w) pair."""
    return (v, v) if isinstance(v, int) else (int(v[0]), int(v[1]))


def _same_pads(x: torch.Tensor, kernel, stride):
    """(left, right, top, bottom) TF "SAME" padding of an NCHW tensor;
    ``kernel`` and ``stride`` are ints or (h, w) pairs."""
    (kh, kw), (sh, sw) = pair(kernel), pair(stride)
    top, bottom = same_padding(x.shape[-2], kh, sh)
    left, right = same_padding(x.shape[-1], kw, sw)
    return left, right, top, bottom


def _as(t, x: torch.Tensor):
    """Parameter ``t`` (or None) in ``x``'s dtype: a no-op when they agree."""
    return None if t is None else t.to(x.dtype)


def conv2d_tf(x: torch.Tensor, weight: torch.Tensor, bias=None,
              stride=1, padding: str = "SAME",
              groups: int = 1) -> torch.Tensor:
    """``F.conv2d`` with TF padding semantics ("SAME" or "VALID"), in
    ``x``'s dtype; ``stride`` is an int or an (h, w) pair."""
    weight, bias = _as(weight, x), _as(bias, x)
    if padding == "VALID":
        return F.conv2d(x, weight, bias, stride, groups=groups)
    if padding != "SAME":
        raise ValueError(f"padding must be 'SAME' or 'VALID', got {padding!r}")
    left, right, top, bottom = _same_pads(x, tuple(weight.shape[-2:]), stride)
    if top == bottom and left == right:
        return F.conv2d(x, weight, bias, stride, padding=(top, left),
                        groups=groups)
    return F.conv2d(F.pad(x, (left, right, top, bottom)), weight, bias, stride,
                    groups=groups)


def make_sep_conv(c_in: int, c_out: int, kernel: int = 3):
    """A Keras SeparableConv2D as its two bias-free convs: the depthwise
    ``kernel`` x ``kernel`` (one filter a channel) and the 1x1 pointwise."""
    return (nn.Conv2d(c_in, c_in, kernel, groups=c_in, bias=False),
            nn.Conv2d(c_in, c_out, 1, bias=False))


def sep_conv(x, dw: nn.Conv2d, pw: nn.Conv2d, stride: int = 1,
             padding: str = "SAME"):
    """Depthwise conv (TF padding) then the pointwise 1x1."""
    x = conv2d_tf(x, dw.weight, None, stride, padding, groups=dw.groups)
    return F.conv2d(x, pw.weight.to(x.dtype), _as(pw.bias, x))


def make_conv_bn(c_in: int, c_out: int, kernel: tuple[int, int]):
    """A bias-free conv and a BatchNorm(eps 1e-3) without a learned scale:
    the BN weight is fixed at 1, as Keras' ``scale=False`` has it."""
    conv = nn.Conv2d(c_in, c_out, kernel, bias=False)
    bn = nn.BatchNorm2d(c_out, eps=BN_EPS, momentum=0.01)
    bn.weight.requires_grad_(False)
    return conv, bn


def bn_eval(x: torch.Tensor, bn: nn.BatchNorm2d) -> torch.Tensor:
    """BatchNorm on its running statistics over NCHW ``x``: computed in
    float32, rounded back to ``x``'s dtype."""
    y = F.batch_norm(x.float(), bn.running_mean, bn.running_var, bn.weight,
                     bn.bias, False, 0.0, bn.eps)
    return y.to(x.dtype)


def linear(x: torch.Tensor, m: nn.Linear) -> torch.Tensor:
    """``m`` applied in ``x``'s dtype."""
    return F.linear(x, m.weight.to(x.dtype), _as(m.bias, x))


def conv_bn_relu(x, conv: nn.Conv2d, bn: nn.BatchNorm2d, stride: int = 1,
                 padding: str = "SAME"):
    """Eval conv -> BatchNorm on its running statistics -> ReLU."""
    x = conv2d_tf(x, conv.weight, None, stride, padding)
    return torch.relu(bn_eval(x, bn))


def max_pool(x, window=3, strides=2, padding: str = "VALID"):
    """Max pool with TF padding semantics (``window`` and ``strides`` ints
    or (h, w) pairs). "SAME" pads with -inf, more on the bottom/right
    where the total is odd, so a pad cell never wins (zero padding, or
    torch's symmetric ``padding=``, changes edge rows)."""
    window, strides = pair(window), pair(strides)
    if padding == "VALID":
        return F.max_pool2d(x, window, strides)
    if padding != "SAME":
        raise ValueError(f"padding must be 'SAME' or 'VALID', got {padding!r}")
    pads = _same_pads(x, window, strides)
    if any(pads):
        x = F.pad(x, pads, value=float("-inf"))
    return F.max_pool2d(x, window, strides)


def avg_pool_keras(x, window=3, strides=1, padding: str = "SAME"):
    """Average pool with Keras semantics (``window`` and ``strides`` ints
    or (h, w) pairs): "SAME"'s padded cells are left out of the divisor."""
    window, strides = pair(window), pair(strides)
    if padding == "VALID":
        return F.avg_pool2d(x, window, strides)
    if padding != "SAME":
        raise ValueError(f"padding must be 'SAME' or 'VALID', got {padding!r}")
    left, right, top, bottom = _same_pads(x, window, strides)
    if top == bottom and left == right:
        return F.avg_pool2d(x, window, strides, padding=(top, left),
                            count_include_pad=False)
    # asymmetric (TF-SAME at stride 2): each window's sum over the padded
    # map over the count of real cells in it
    ones = torch.ones_like(x[:1, :1])
    sums, counts = (F.avg_pool2d(F.pad(t, (left, right, top, bottom)), window,
                                 strides, divisor_override=1) for t in (x, ones))
    return sums / counts


def global_avg_pool(x):
    return x.mean(dim=(2, 3))


def zero_pad(x, pad: int):
    """``pad`` zero rows and columns on every side of an NCHW tensor."""
    return F.pad(x, (pad, pad, pad, pad))


def nhwc_to_nchw(x: torch.Tensor) -> torch.Tensor:
    """NHWC tensor -> NCHW view in channels_last memory (no copy when x
    is contiguous NHWC)."""
    return x.permute(0, 3, 1, 2)


def lecun_normal_(w: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Flax's default kernel init (variance_scaling(1, fan_in, truncated
    normal)): N(0, 1/fan_in) truncated at 2 std, std corrected for the cut."""
    fan_in = w[0].numel()  # torch weights are [out, in, kh, kw] or [out, in]
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                     generator=generator)


# ---------------------------------------------------------------------------
# train-mode BatchNorm with Flax's semantics
# ---------------------------------------------------------------------------
#
# Flax's nn.BatchNorm(momentum=0.99) normalizes with the BIASED batch
# variance, E[x^2] - E[x]^2 clamped at 0, and moves its running variance
# toward that same biased value. F.batch_norm(training=True) writes the
# unbiased variance into running_var instead, so the zoo computes the
# moments itself and updates the running statistics explicitly.

BN_MOMENTUM = 0.99  # Flax's: running = 0.99 * running + 0.01 * batch


def bn_moments(x: torch.Tensor, dims, centered: bool = False
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """float32 batch mean and biased variance over ``dims``: Flax's
    E[x^2] - E[x]^2 clamped at 0, or with ``centered`` Keras' two-pass
    E[(x - E[x])^2] (``keras.ops.moments``, ``jnp.var``)."""
    xf = x.float()
    if centered:
        mean = xf.mean(dim=dims, keepdim=True)
        var = ((xf - mean) ** 2).mean(dim=dims)
        return mean.reshape(var.shape), var
    mean = xf.mean(dim=dims)
    var = torch.clamp((xf * xf).mean(dim=dims) - mean * mean, min=0.0)
    return mean, var


def moved_running_stats(bn: nn.BatchNorm2d, mean: torch.Tensor,
                        var: torch.Tensor) -> dict:
    """The running statistics after one training step, as Flax moves
    them: ``{"mean": ..., "var": ...}`` (detached)."""
    m = BN_MOMENTUM
    return {"mean": m * bn.running_mean + (1 - m) * mean.detach(),
            "var": m * bn.running_var + (1 - m) * var.detach()}


def set_running_stats(bn: nn.BatchNorm2d, stats: dict) -> None:
    with torch.no_grad():
        bn.running_mean.copy_(stats["mean"])
        bn.running_var.copy_(stats["var"])


def bn_scale_shift(bn: nn.BatchNorm2d, mean, var):
    """The BN as one affine: (gamma·rsqrt(var+eps), beta - mean·scale)."""
    scale = bn.weight * torch.rsqrt(var + bn.eps)
    return scale, bn.bias - mean * scale


def init_zoo_(module: nn.Module, seed: int = 0) -> nn.Module:
    """Flax's default initialisation of a conv zoo model, from a seeded
    CPU generator (so the weights do not depend on the device):
    lecun-normal conv and dense kernels with zero biases, BatchNorm scale
    1 and bias 0, running mean 0 and variance 1."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                w = torch.empty(m.weight.shape, dtype=torch.float32)
                m.weight.copy_(lecun_normal_(w, g))
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
    return module
