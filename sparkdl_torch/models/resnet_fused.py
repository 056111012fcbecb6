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

In training, every BatchNorm's elementwise work and reductions run on
:mod:`ops.bn_train`'s kernels, forward and backward:

- the batch moments of each tensor a cuDNN conv made (28 a step: the
  stem, the 16 3x3s, the 4 shortcuts, the 4 first-block 1x1s and stage
  1's 3 closing 1x1s; the fused GEMM gives the other 25 theirs);
- one apply per normalized tensor: normalize, the bottleneck's
  residual or its shortcut's BatchNorm added, ReLU (36 a step, covering
  40 BatchNorms), with the closed-form backward pair behind each;
- the 13 seam BatchNorms (stages 2-4's 3x3 into the closing 1x1) run
  their backward pair inside the fused GEMM's backward
  (``x_moments``).

:func:`bn_train_launches` lists those calls by shape.

The stem's max pool pads with its own padding, which takes the same
maximum as the JAX package's zero padding: a ReLU output is never below
zero.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from sparkdl_torch.models.common import (
    Namer,
    bn_scale_shift,
    conv2d_tf,
    moved_running_stats,
)
from sparkdl_torch.models.resnet import BN_EPS, STAGES
from sparkdl_torch.ops.bn_train import batch_moments, bn_train
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

    def moments(name, y):
        """this BN's batch moments (recording its moved running stats) in
        training, its running stats otherwise"""
        bn = getattr(module, name)
        if not train:
            return bn.running_mean, bn.running_var
        mean, var = batch_moments(y.reshape(-1, y.shape[-1]))
        new_stats[name] = moved_running_stats(bn, mean, var)
        return mean, var

    def norm(terms, residual=None, relu=True):
        """act(sum of BN(y) [+ residual]) over NHWC tensors, in ``dtype``;
        ``terms``: one or two (bn name, y, (mean, var))."""
        if train:
            c = terms[0][1].shape[-1]
            z = bn_train(
                [(y.reshape(-1, c), getattr(module, n).weight, getattr(module, n).bias,
                  mean, var) for n, y, (mean, var) in terms], BN_EPS,
                residual=None if residual is None else residual.reshape(-1, c),
                relu=relu)
            return z.reshape(terms[0][1].shape)
        u = None
        for n, y, (mean, var) in terms:
            scale, shift = bn_scale_shift(getattr(module, n), mean, var)
            a = y * scale.to(y.dtype) + shift.to(y.dtype)
            u = a if u is None else u + a
        if residual is not None:
            u = u + residual
        return (torch.relu(u) if relu else u).to(dtype)

    def conv(name, y, stride=1, padding="SAME"):
        m = getattr(module, name)
        out = conv2d_tf(y.permute(0, 3, 1, 2), m.weight.to(dtype),
                        m.bias.to(dtype), stride, padding)
        return out.permute(0, 2, 3, 1)

    def conv1x1(name, bn, y, prev=None, stride=1):
        """A 1x1 conv and this BN's moments, ``prev`` = (bn name, its
        moments) the BN + ReLU that normalizes y first: through the kernel
        where the gate allows, else cuDNN and a separate reduction."""
        m = getattr(module, name)
        if train and stride == 1 and y.shape[-1] >= FUSED_MIN_CIN:
            prev_bn = None
            if prev is not None:
                p = getattr(module, prev[0])
                prev_bn = (*prev[1], p.weight, p.bias, BN_EPS)
            w = m.weight[:, :, 0, 0].t().to(dtype)  # [Cin, Cout]
            out, mean, var = conv1x1_bn_stats(y, w, m.bias, prev_bn=prev_bn,
                                              relu_in=prev is not None,
                                              x_moments=True)
            new_stats[bn] = moved_running_stats(getattr(module, bn), mean, var)
            return out, (mean, var)
        if prev is not None:
            y = norm([(prev[0], y, prev[1])])
        out = conv(name, y, stride, "VALID")
        return out, moments(bn, out)

    # stem
    y = F.pad(x, (0, 0, 3, 3, 3, 3))
    name = nm.conv()
    y = conv(name, y, stride=2, padding="VALID")
    bn = nm.bn()
    y = norm([(bn, y, moments(bn, y))])
    y = F.max_pool2d(y.permute(0, 3, 1, 2), 3, 2, padding=1).permute(0, 2, 3, 1)

    for filters, blocks, stride in STAGES:
        for i in range(blocks):
            s = stride if i == 0 else 1
            c_a, b_a = nm.conv(), nm.bn()
            c_3, b_3 = nm.conv(), nm.bn()
            if i == 0:
                c_s, b_s = nm.conv(), nm.bn()
            c_b, b_b = nm.conv(), nm.bn()

            a_raw, m_a = conv1x1(c_a, b_a, y, stride=s)
            y2 = conv(c_3, norm([(b_a, a_raw, m_a)]))
            # the 3x3's BN-normalize + ReLU fused into the closing 1x1's load
            b_raw, m_b = conv1x1(c_b, b_b, y2, prev=(b_3, moments(b_3, y2)))
            terms = [(b_b, b_raw, m_b)]
            if i == 0:
                s_raw, m_s = conv1x1(c_s, b_s, y, stride=s)
                terms.append((b_s, s_raw, m_s))
            y = norm(terms, residual=None if i == 0 else y)

    features = y.float().mean(dim=(1, 2))
    probs = None
    if include_top:
        probs = torch.softmax(module.dense000(features), dim=-1)
    out = (features, probs)
    return (out, new_stats) if train else out


def bn_train_launches(batch: int, size: int) -> dict:
    """The :mod:`ops.bn_train` calls of one fused training step over
    ``batch`` images of ``size`` px, as :func:`resnet50_fused_forward`
    makes them: ``moments`` (M, C) for each tensor a cuDNN conv made,
    ``apply`` (M, C, BatchNorms, residual) for each normalized tensor,
    ``backward`` (M, C, BatchNorms, residual, seam) for each apply and
    each seam (the 3x3's BatchNorm in the closing 1x1's load)."""
    h = size // 2
    mom, app = [(batch * h * h, 64)], [(batch * h * h, 64, 1, False)]
    h, cin = h // 2, 64
    for f, blocks, stride in STAGES:
        for i in range(blocks):
            s = stride if i == 0 else 1
            h //= s
            m = batch * h * h
            if s != 1 or cin < FUSED_MIN_CIN:
                mom.append((m, f))  # the first 1x1 on cuDNN
            mom.append((m, f))  # the 3x3
            app.append((m, f, 1, False))
            if f < FUSED_MIN_CIN:  # the closing 1x1 on cuDNN: the 3x3's BN first
                mom.append((m, 4 * f))
                app.append((m, f, 1, False))
            if i == 0:
                mom.append((m, 4 * f))  # the shortcut
                app.append((m, 4 * f, 2, False))
            else:
                app.append((m, 4 * f, 1, True))
            cin = 4 * f
    bwd = [a + (False,) for a in app]
    h = size // 4
    for f, blocks, stride in STAGES[1:]:
        h //= stride
        bwd += [(batch * h * h, f, 1, False, True)] * blocks
    return {"moments": mom, "apply": app, "backward": bwd}
