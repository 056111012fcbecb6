"""Branch-merged InceptionV3 eval forward: the featurizer's fast path.

Each Inception mixed block runs several 1x1 convs over the SAME input
tensor (branch heads). This forward evaluates the module's math with the
branch-head kernels concatenated along the output axis — one bigger conv
per head group (input read once), then a channel split. The stem (conv000
-002 and the first max-pool) is the hand-written kernel
``ops/stem_fused.py::inception_stem_fused``; every other conv runs on
``F.conv2d`` (cuDNN on the GPU).

Merged groups (all 1x1 stride-1 heads sharing the block input):
  - inception-A x3: b1 / b5-reduce / b3-reduce
  - inception-B x4: b1 / b7-reduce / b7dbl-reduce
  - reduction-B:    b3-reduce / b7-reduce
  - inception-C x2: b1 / b3-reduce / b3dbl-reduce

Everything that depends only on the weights is done once, in
:func:`prepare_fused_inception_v3`: eval BN is folded into each conv
(W * r, bias = BN shift), head groups are concatenated, and the stem's
parameters are folded for the kernel. Eval-only.

The forward computes in ``dtype`` (bfloat16 by default, as the JAX
package's): the stem kernel writes its output in it, and every other conv
runs on a copy of its folded weights in it, made once per dtype and
held beside (not inside) the parameters. The features come back float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.weak import WeakTensorKeyDictionary

from sparkdl_torch.models.common import (
    BN_EPS,
    avg_pool_keras,
    conv2d_tf,
    global_avg_pool,
    max_pool,
    nhwc_to_nchw,
)
from sparkdl_torch.ops.stem_fused import fold_stem_params, inception_stem_fused

# index groups of 1x1 heads merged into one conv, in construction order
_A_FIRST, _B_FIRST = 5, 5 + 3 * 7 + 4   # first conv of mixed0 / mixed4
_RB_FIRST = _B_FIRST + 4 * 10           # first conv of mixed8
_C_FIRST = _RB_FIRST + 6                # first conv of mixed9
_N_CONVS = _C_FIRST + 2 * 9             # 94
_MERGED = (
    [tuple(_A_FIRST + 7 * m + i for i in (0, 1, 3)) for m in range(3)]
    + [tuple(_B_FIRST + 10 * m + i for i in (0, 1, 4)) for m in range(4)]
    + [(_RB_FIRST, _RB_FIRST + 2)]
    + [tuple(_C_FIRST + 9 * m + i for i in (0, 1, 4)) for m in range(2)]
)


def prepare_fused_inception_v3(state_dict: dict) -> dict:
    """The fused forward's parameters from an InceptionV3 state_dict
    (plain or ``fold_tf_preprocess``'ed), on the weights' device."""
    convs = {}
    for i in range(3, _N_CONVS):
        w = state_dict[f"conv{i:03d}.weight"].float()
        r = torch.rsqrt(state_dict[f"bn{i:03d}.running_var"].float() + BN_EPS)
        shift = (state_dict[f"bn{i:03d}.bias"].float()
                 - state_dict[f"bn{i:03d}.running_mean"].float() * r)
        convs[i] = ((w * r.view(-1, 1, 1, 1)).contiguous(
            memory_format=torch.channels_last), shift.contiguous())
    merged = {}
    for idxs in _MERGED:
        w = torch.cat([convs[i][0] for i in idxs]).contiguous(
            memory_format=torch.channels_last)
        merged[idxs] = (w, torch.cat([convs[i][1] for i in idxs]),
                        [convs[i][0].shape[0] for i in idxs])
    return {"stem": fold_stem_params(state_dict), "convs": convs,
            "merged": merged}


# the first folded conv weight of a parameter set -> {dtype: (convs, merged)}:
# the cast copies live as long as the parameters they were made from
_CAST = WeakTensorKeyDictionary()


def _weights_in(params: dict, dtype: torch.dtype) -> tuple[dict, dict]:
    """(convs, merged) of ``params`` in ``dtype``: the float32 originals,
    or a copy cast on first use and kept in ``_CAST``."""
    if dtype == torch.float32:
        return params["convs"], params["merged"]
    cast = _CAST.setdefault(params["convs"][3][0], {})
    if dtype not in cast:
        cast[dtype] = (
            {i: (w.to(dtype), b.to(dtype)) for i, (w, b) in params["convs"].items()},
            {k: (w.to(dtype), b.to(dtype), widths)
             for k, (w, b, widths) in params["merged"].items()},
        )
    return cast[dtype]


def fused_inception_v3_features(params: dict, x: torch.Tensor, *,
                                dtype: torch.dtype = torch.bfloat16,
                                stem=inception_stem_fused) -> torch.Tensor:
    """2048-d float32 features, the math of
    ``InceptionV3(include_top=False, dtype=dtype)(x)`` with branch heads
    merged.

    ``params`` from :func:`prepare_fused_inception_v3`; ``x``: NHWC
    [B, H, W, 3] float32 (or uint8) — raw [0, 255] pixels when the weights
    were ``fold_tf_preprocess``'ed, else already preprocessed. ``dtype``:
    the compute dtype, float32 or bfloat16. ``stem`` computes conv000-002
    + max-pool into ``dtype``; pass ``ops.stem_fused.stem_reference`` for
    the plain version.
    """
    convs, merged = _weights_in(params, dtype)
    nxt = iter(range(3, _N_CONVS))

    def cbr(h, i=None, strides=1, padding="SAME"):
        w, b = convs[next(nxt) if i is None else i]
        return torch.relu(conv2d_tf(h, w, b, strides, padding))

    def heads(h, idxs):
        w, b, widths = merged[tuple(idxs)]
        return torch.relu(F.conv2d(h, w, b)).split(widths, dim=1)

    def take(n):
        return [next(nxt) for _ in range(n)]

    # -- stem: conv000-002 + max-pool, one kernel ------------------------
    h = nhwc_to_nchw(stem(x.contiguous(), params["stem"], dtype=dtype))
    h = cbr(h, padding="VALID")
    h = cbr(h, padding="VALID")
    h = max_pool(h, 3, 2, "VALID")

    # -- 3x inception-A (module order: b1, b5r, b5, b3r, b3a, b3b, bp) --
    for _ in range(3):
        idx = take(7)
        b1, b5, b3 = heads(h, [idx[0], idx[1], idx[3]])
        b5 = cbr(b5, idx[2])
        b3 = cbr(cbr(b3, idx[4]), idx[5])
        bp = cbr(avg_pool_keras(h, 3, 1, "SAME"), idx[6])
        h = torch.cat([b1, b5, b3, bp], dim=1)

    # -- reduction-A (b3s2, bdr, bd, bds2 — no mergeable heads) --------
    b3 = cbr(h, strides=2, padding="VALID")
    bd = cbr(cbr(h))
    bd = cbr(bd, strides=2, padding="VALID")
    h = torch.cat([b3, bd, max_pool(h, 3, 2, "VALID")], dim=1)

    # -- 4x inception-B (order: b1, b7r, b7a, b7b, bdr, bd1..bd4, bp) --
    for _ in range(4):
        idx = take(10)
        b1, b7, bd = heads(h, [idx[0], idx[1], idx[4]])
        b7 = cbr(cbr(b7, idx[2]), idx[3])
        for i in idx[5:9]:
            bd = cbr(bd, i)
        bp = cbr(avg_pool_keras(h, 3, 1, "SAME"), idx[9])
        h = torch.cat([b1, b7, bd, bp], dim=1)

    # -- reduction-B (order: b3r, b3s2, b7r, b7a, b7b, b7s2) -----------
    idx = take(6)
    b3, b7 = heads(h, [idx[0], idx[2]])
    b3 = cbr(b3, idx[1], strides=2, padding="VALID")
    b7 = cbr(cbr(b7, idx[3]), idx[4])
    b7 = cbr(b7, idx[5], strides=2, padding="VALID")
    h = torch.cat([b3, b7, max_pool(h, 3, 2, "VALID")], dim=1)

    # -- 2x inception-C (order: b1, b3r, b3a, b3b, bdr, bd, bda, bdb, bp)
    for _ in range(2):
        idx = take(9)
        b1, b3, bd = heads(h, [idx[0], idx[1], idx[4]])
        b3 = torch.cat([cbr(b3, idx[2]), cbr(b3, idx[3])], dim=1)
        bd = cbr(bd, idx[5])
        bd = torch.cat([cbr(bd, idx[6]), cbr(bd, idx[7])], dim=1)
        bp = cbr(avg_pool_keras(h, 3, 1, "SAME"), idx[8])
        h = torch.cat([b1, b3, bd, bp], dim=1)

    return global_avg_pool(h).float()
