"""ResNet50's training forward with the fused 1x1-conv + BN-stats kernel:
the port of ``sparkdl_tpu.models.resnet_fused``.

:func:`resnet50_fused_forward` computes the same network over the same
module as :class:`models.resnet.ResNet50` (so weights, running statistics
and checkpoints interchange with it) as a plain function, NHWC
throughout, whose stride-1 1x1 convs with at least 128 input channels run
through :func:`ops.fused_gemm_bn.conv1x1_bn_stats` in training:

- each such conv emits its BN's batch moments from the GEMM's float32
  accumulator (no stats pass over its output);
- the 3x3 -> 1x1 seam fuses the 3x3's BN-normalize + ReLU into the
  closing 1x1's operand load (the normalized activation never reaches
  device memory).

That is 25 kernel launches per training forward (stage 1: 2, stage 2: 7,
stage 3: 11, stage 4: 5). The stem, the 3x3 convs, the stride-2 1x1s and
the Cin = 64 1x1s stay on cuDNN, as they stay on XLA in the JAX package.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from sparkdl_torch.models.common import (
    Namer,
    bn_moments,
    bn_scale_shift,
    conv2d_tf,
    moved_running_stats,
)
from sparkdl_torch.models.resnet import BN_EPS, STAGES
from sparkdl_torch.ops.fused_gemm_bn import conv1x1_bn_stats

#: the JAX package's gate for the fused kernel: stride 1 and Cin >= 128
FUSED_MIN_CIN = 128


def resnet50_fused_forward(module, x, *, train: bool = True,
                           num_classes: int = 1000, include_top: bool = True,
                           dtype=torch.bfloat16):
    """Forward pass of a :class:`~sparkdl_torch.models.resnet.ResNet50`
    ``module`` over NHWC ``x`` [B, H, W, 3], computing in ``dtype``
    (float32 or bfloat16; parameters stay float32, statistics are float32).

    Returns ``((features, probs), new_batch_stats)`` when ``train`` — the
    running statistics after this step, ``{"bn000": {"mean", "var"}, ...}``,
    as the JAX ``model.apply(..., mutable=["batch_stats"])`` returns them;
    the module's own buffers are left as they are — and ``(features,
    probs)`` otherwise. ``probs`` is None when ``include_top`` is False.
    """
    if include_top and (not module.include_top
                        or module.dense000.out_features != num_classes):
        raise ValueError(f"module has no {num_classes}-class top")
    new_stats: dict[str, dict] = {}
    nm = Namer()
    x = x.to(dtype)

    def bn_apply(name, mean, var, y):
        scale, shift = bn_scale_shift(getattr(module, name), mean, var)
        return y * scale.to(y.dtype) + shift.to(y.dtype)

    def stats(name, y):
        """this BN's moments (recording its moved running stats) in
        training, its running stats otherwise"""
        if not train:
            bn = getattr(module, name)
            return bn.running_mean, bn.running_var
        mean, var = bn_moments(y, (0, 1, 2))
        new_stats[name] = moved_running_stats(getattr(module, name), mean, var)
        return mean, var

    def conv(name, y, stride=1, padding="SAME"):
        m = getattr(module, name)
        out = conv2d_tf(y.permute(0, 3, 1, 2), m.weight.to(dtype),
                        m.bias.to(dtype), stride, padding)
        return out.permute(0, 2, 3, 1)

    def conv1x1(name, bn, y, prev_bn=None, relu_in=False, stride=1):
        """A 1x1 conv and this BN's moments: through the kernel where the
        gate allows, else cuDNN and a separate reduction."""
        m = getattr(module, name)
        w = m.weight[:, :, 0, 0].t().to(dtype)  # [Cin, Cout]
        if train and stride == 1 and y.shape[-1] >= FUSED_MIN_CIN:
            out, mean, var = conv1x1_bn_stats(y, w, m.bias, prev_bn=prev_bn,
                                              relu_in=relu_in)
            new_stats[bn] = moved_running_stats(getattr(module, bn), mean, var)
            return out, (mean, var)
        if prev_bn is not None:
            mean_p, var_p, gamma, beta, eps = prev_bn
            scale = gamma * torch.rsqrt(var_p + eps)
            y = y * scale.to(y.dtype) + (beta - mean_p * scale).to(y.dtype)
        if relu_in:
            y = torch.relu(y)
        out = conv(name, y, stride, "VALID")
        return out, stats(bn, out)

    # stem
    y = F.pad(x, (0, 0, 3, 3, 3, 3))
    name = nm.conv()
    y = conv(name, y, stride=2, padding="VALID")
    bn = nm.bn()
    y = torch.relu(bn_apply(bn, *stats(bn, y), y)).to(dtype)
    y = F.pad(y, (0, 0, 1, 1, 1, 1))
    y = F.max_pool2d(y.permute(0, 3, 1, 2), 3, 2).permute(0, 2, 3, 1)

    for filters, blocks, stride in STAGES:
        for i in range(blocks):
            s = stride if i == 0 else 1
            c_a, b_a = nm.conv(), nm.bn()
            c_3, b_3 = nm.conv(), nm.bn()
            if i == 0:
                c_s, b_s = nm.conv(), nm.bn()
            c_b, b_b = nm.conv(), nm.bn()

            a_raw, (m_a, v_a) = conv1x1(c_a, b_a, y, stride=s)
            z1 = torch.relu(bn_apply(b_a, m_a, v_a, a_raw)).to(dtype)
            y2 = conv(c_3, z1)
            m2, v2 = stats(b_3, y2)
            p3 = getattr(module, b_3)
            # the 3x3's BN-normalize + ReLU fused into the closing 1x1's load
            b_raw, (m_b, v_b) = conv1x1(
                c_b, b_b, y2.to(dtype),
                prev_bn=(m2, v2, p3.weight, p3.bias, BN_EPS), relu_in=True)
            if i == 0:
                s_raw, (m_s, v_s) = conv1x1(c_s, b_s, y, stride=s)
                sc = bn_apply(b_s, m_s, v_s, s_raw)
            else:
                sc = y
            y = torch.relu(bn_apply(b_b, m_b, v_b, b_raw) + sc).to(dtype)

    features = y.float().mean(dim=(1, 2))
    probs = None
    if include_top:
        probs = torch.softmax(module.dense000(features), dim=-1)
    out = (features, probs)
    return (out, new_stats) if train else out
