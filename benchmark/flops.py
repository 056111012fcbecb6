"""Operation and byte counts from layer shapes, the card's peaks, and the
bounds the per-layer metrics divide by.

Operations count 2 FLOP a multiply-add, over convolutions and dense
layers only (BatchNorm, ReLU, pooling and the softmax are left out). The
shapes come from walking the references' own architecture
(``benchmark/reference``), so the count follows the model, not whatever
implements it.

Peaks are NVIDIA's published dense rates of one H100 SXM at its 700 W
limit. The port's float32 kernels run 3xTF32 on the tensor cores (three
TF32 passes a product keep float32 accuracy), so their yardstick is the
TF32 peak over three, 165 TFLOP/s; the float32 rate outside the tensor
cores, 67 TFLOP/s, is printed for information only.
"""

from __future__ import annotations

import math

from benchmark.reference import inception_v3, resnet50

H100_TF32_FLOPS = 495e12
PEAK_FLOPS = H100_TF32_FLOPS / 3   # 3xTF32: the float32 yardstick
H100_F32_FLOPS = 67e12             # CUDA cores, for information
PEAK_BYTES_S = 3.35e12             # HBM3
F32 = 4


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: operations at the 3xTF32 peak
    or bytes at the HBM rate, whichever is longer."""
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES_S)


def _out(size: int, k: int, stride: int, padding: str) -> int:
    if padding == "SAME":
        return math.ceil(size / stride)
    return (size - k) // stride + 1


class _Shapes:
    """Walks ``inception_v3.body`` on (channels, height, width) and records
    each conv as (cin, cout, kh, kw, h_out, w_out)."""

    def __init__(self):
        self.convs: list[tuple[int, ...]] = []

    def cb(self, x, filters, kh, kw, strides=1, padding="SAME"):
        c, h, w = x
        ho, wo = _out(h, kh, strides, padding), _out(w, kw, strides, padding)
        self.convs.append((c, filters, kh, kw, ho, wo))
        return filters, ho, wo

    @staticmethod
    def concat(*xs):
        return sum(x[0] for x in xs), xs[0][1], xs[0][2]

    @staticmethod
    def max_pool(x):
        c, h, w = x
        return c, _out(h, 3, 2, "VALID"), _out(w, 3, 2, "VALID")

    @staticmethod
    def avg_pool(x):
        return x

    @staticmethod
    def global_avg_pool(x):
        return x[0]


def inception_v3_convs(size: int = 299) -> list[tuple[int, ...]]:
    """(cin, cout, kh, kw, h_out, w_out) of each of InceptionV3's 94 convs."""
    walk = _Shapes()
    inception_v3.body((3, size, size), walk)
    return walk.convs


def resnet50_convs(size: int = 224) -> list[tuple[int, ...]]:
    """(cin, cout, kh, kw, h_out, w_out, stride, role) of ResNet50's 53
    convs in construction order; role is "stem", "a" (opening 1x1),
    "3x3", "shortcut" or "b" (closing 1x1)."""
    h = _out(size + 6, 7, 2, "VALID")
    convs = [(3, 64, 7, 7, h, h, 2, "stem")]
    h = _out(h + 2, 3, 2, "VALID")  # zero_pad(1), 3x3/2 max-pool
    cin = 64
    for filters, blocks, stride in resnet50.STAGES:
        for i in range(blocks):
            s = stride if i == 0 else 1
            ho = _out(h, 1, s, "SAME")
            convs.append((cin, filters, 1, 1, ho, ho, s, "a"))
            convs.append((filters, filters, 3, 3, ho, ho, 1, "3x3"))
            if i == 0:
                convs.append((cin, 4 * filters, 1, 1, ho, ho, s, "shortcut"))
            convs.append((filters, 4 * filters, 1, 1, ho, ho, 1, "b"))
            cin, h = 4 * filters, ho
    return convs


def _conv_macs(c) -> int:
    cin, cout, kh, kw, ho, wo = c[:6]
    return cin * cout * kh * kw * ho * wo


def forward_flops(reference: str, size: int, include_top: bool = False,
                  num_classes: int = 1000) -> float:
    """FLOP of one image's forward pass."""
    if reference == "inception_v3":
        macs = sum(map(_conv_macs, inception_v3_convs(size)))
        feature_dim = inception_v3.FEATURE_DIM
    elif reference == "resnet50":
        macs = sum(map(_conv_macs, resnet50_convs(size)))
        feature_dim = resnet50.FEATURE_DIM
    else:
        raise ValueError(f"no operation count for reference {reference!r}")
    if include_top:
        macs += feature_dim * num_classes
    return 2.0 * macs


def train_flops(reference: str, size: int, num_classes: int = 1000) -> float:
    """FLOP of one sample's training step: the forward and a backward of
    twice its work (the gradients of the inputs and of the weights)."""
    return 3.0 * forward_flops(reference, size, True, num_classes)


# -- the InceptionV3 stem: conv000-002 (each conv-BN-ReLU) + max-pool ----------

def stem_flops(batch: int, size: int = 299) -> float:
    """FLOP of the stem's three convs over a batch (78.93 G at B=64, 299 px)."""
    return 2.0 * batch * sum(map(_conv_macs, inception_v3_convs(size)[:3]))


def stem_bytes(batch: int, size: int = 299) -> float:
    """The stem's bytes, each read or written once: float32 pixels in, the
    folded weights (kernels, BN scale and shift), the pooled float32
    [B, Rp, Rp, 64] out."""
    convs = inception_v3_convs(size)[:3]
    weights = sum(cin * cout * kh * kw + 2 * cout for cin, cout, kh, kw, _, _ in convs)
    h = convs[2][4]
    rp = _out(h, 3, 2, "VALID")
    return F32 * (batch * size * size * 3 + weights + batch * rp * rp * 64)


def stem_bound_s(batch: int, size: int = 299) -> float:
    return bound_s(stem_flops(batch, size), stem_bytes(batch, size))


# -- the fused 1x1-conv + BN-stats GEMM of the ResNet50 train step -------------

#: the program's gate for the fused kernel: a stride-1 1x1 conv with at
#: least this many input channels, in training
FUSED_MIN_CIN = 128


def gemm_bn_shapes(batch: int, size: int = 224) -> list[tuple[int, int, int, int, bool]]:
    """(M, K, N, launches a step, prologue) of the fused GEMM in one
    training step: every stride-1 1x1 conv with K >= 128 input channels,
    M = batch x h x w rows. The closing 1x1 ("b") carries the 3x3's
    BN-normalize + ReLU as its prologue. 25 launches at any size."""
    counts: dict[tuple, int] = {}
    for cin, cout, kh, _, ho, wo, stride, role in resnet50_convs(size):
        if kh == 1 and stride == 1 and cin >= FUSED_MIN_CIN and role in ("a", "b"):
            key = (batch * ho * wo, cin, cout, role == "b")
            counts[key] = counts.get(key, 0) + 1
    return [(m, k, n, c, prev) for (m, k, n, prev), c in counts.items()]


def gemm_bn_bound_s(batch: int, size: int = 224) -> float:
    """The sum over one step's launches of each launch's bound: operations
    2MKN; bytes of X, W, Y once, the bias and the BN sums, and the
    prologue's scale and shift."""
    total = 0.0
    for m, k, n, count, prev in gemm_bn_shapes(batch, size):
        nbytes = F32 * (m * k + k * n + m * n + 2 * n + (2 * k if prev else 0))
        total += count * bound_s(2.0 * m * k * n, nbytes)
    return total


def gemm_bn_launches_a_step(size: int = 224) -> int:
    return sum(c for _, _, _, c, _ in gemm_bn_shapes(1, size))
