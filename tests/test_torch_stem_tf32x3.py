"""The numeric design of the stem kernel (sparkdl_torch/csrc/stem_fused.cu),
emulated in plain torch.

The kernel runs each of the stem's three convs as an implicit GEMM on the
tensor cores at float32 accuracy (3xTF32, the split of
tests/test_torch_gemm_bn_tf32x3.py: big = tf32(x) rounded as
``cvt.rna.tf32.f32`` rounds, the small half x - big left for the tensor
cores to truncate). As emulated here:

- each conv is an im2col GEMM over K = tap x channel in HWIO order (conv1
  27 columns, zero-padded to 32; conv2 and conv3 288), cut into 8-column
  k-steps, each through three TF32 passes;
- conv2 and conv3 sum a tap's 4 k-steps from zero and add that run to the
  float32 accumulator; conv1's 4 k-steps are one run;
- uint8 pixels are integers <= 255, exact in TF32, so the kernel's conv1
  on uint8 pixels runs two passes (big * small and big * big);
- the epilogue is relu(acc * s + b), conv2's output zero-padded for
  conv3's SAME padding, then the 3x3/2 max-pool.

Held to the port's plain version (``stem_reference``) within
chip_smoke.py's STEM_TOL at S = 59 and 75, and to the JAX package's
``stem_reference`` and its Pallas kernel in interpret mode at S = 59. One
TF32 pass misses STEM_TOL. On the CPU every float32 add rounds to nearest,
so chaining all 36 k-steps through the accumulator passes here too; the
card's tensor cores round the running sum they are handed their own way,
which only chip_smoke.py and tools/stem_variants.py ("chain") can show.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from chip_smoke import STEM_TOL
from sparkdl_tpu.ops import stem_fused as jax_stem
from sparkdl_torch.ops import stem_fused as torch_stem
from test_torch_flash_bwd_tf32x3 import mm_1xtf32, tf32
from test_torch_gemm_bn_tf32x3 import mm_3xtf32, trunc
from test_torch_stem import _pixels, _random_folded, _torch_folded

TAP_RUN = 4  # stem_fused.cu: a tap's 4 k-steps sum from zero


def mm_2xtf32(a, b):
    """a @ b with a exact in TF32 (uint8 pixels): big·small, big·big."""
    b_big = tf32(b)
    assert torch.equal(tf32(a), a)
    return a @ trunc(b - b_big) + a @ b_big


def _im2col(h, stride, padding):
    """NHWC [B, H, W, C] -> [B * Ho * Wo, 9 * C] patches, K in HWIO order
    (tap-major, channel-minor), and the output's (B, Ho, Wo)."""
    x = F.pad(h.permute(0, 3, 1, 2), (padding,) * 4)
    b, c = x.shape[0], x.shape[1]
    cols = F.unfold(x, 3, stride=stride)  # [B, C * 9, L], channel-major
    ho = (x.shape[2] - 3) // stride + 1
    cols = cols.view(b, c, 9, -1).permute(0, 3, 2, 1).reshape(-1, 9 * c)
    return cols, (b, ho, ho)


def emulated_conv(h, k, s, b, stride, padding, mm, run):
    """relu(conv(h) * s + b) as the kernel computes it: 8-column k-steps
    through mm, runs of ``run`` k-steps from zero added to the float32
    accumulator; K padded with zeros to a multiple of 8."""
    a, shape = _im2col(h, stride, padding)
    w = k.reshape(-1, k.shape[-1])
    pad = -a.shape[1] % 8
    a, w = F.pad(a, (0, pad)), F.pad(w, (0, 0, 0, pad))
    acc = torch.zeros((a.shape[0], w.shape[1]))
    for r0 in range(0, a.shape[1], 8 * run):
        part = torch.zeros_like(acc)
        for k0 in range(r0, min(r0 + 8 * run, a.shape[1]), 8):
            part = part + mm(a[:, k0:k0 + 8], w[k0:k0 + 8])
        acc = acc + part
    # fmaf(acc, s, b): the product is exact in float64
    y = (acc.double() * s.double() + b.double()).float()
    return torch.relu(y).view(*shape, -1)


def emulated_stem(x, folded, mm=mm_3xtf32, run=TAP_RUN):
    """NHWC pixels -> [B, Rp, Rp, 64] as the kernel computes them."""
    h = x.float()
    conv1_mm = mm_2xtf32 if x.dtype == torch.uint8 and mm is mm_3xtf32 else mm
    h = emulated_conv(h, folded["k1"], folded["s1"], folded["b1"], 2, 0, conv1_mm, 4)
    h = emulated_conv(h, folded["k2"], folded["s2"], folded["b2"], 1, 0, mm, run)
    h = emulated_conv(h, folded["k3"], folded["s3"], folded["b3"], 1, 1, mm, run)
    return F.max_pool2d(h.permute(0, 3, 1, 2), 3, 2).permute(0, 2, 3, 1)


def _rel(got, want):
    got, want = (torch.from_numpy(np.array(v, dtype=np.float32)) for v in (got, want))
    assert got.shape == want.shape
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("pixel_dtype", ["u8", "f32"])
@pytest.mark.parametrize("size", [59, 75])
def test_3xtf32_matches_the_plain_version(size, pixel_dtype):
    folded = _torch_folded(_random_folded(2))
    x = torch.from_numpy(_pixels(size, pixel_dtype, seed=5))
    got = emulated_stem(x, folded)
    want = torch_stem.stem_reference(x, folded)
    assert _rel(got, want) <= STEM_TOL, _rel(got, want)


@pytest.mark.parametrize("reference", ["xla", "pallas_interpret"])
def test_3xtf32_matches_jax_stem(reference):
    """At S = 59, against the JAX package's stem_reference (XLA convs) and
    its Pallas kernel in interpret mode, on the same numpy inputs."""
    folded = _random_folded(1)
    x = _pixels(59, "u8", seed=4)
    if reference == "xla":
        want = jax_stem.stem_reference(jnp.asarray(x), folded)
    else:
        want = jax_stem.inception_stem_fused(
            jnp.asarray(x), jax_stem.pack_stem_params(folded),
            dtype=jnp.float32, interpret=True)
    got = emulated_stem(torch.from_numpy(x), _torch_folded(folded))
    assert _rel(got, want) <= STEM_TOL, _rel(got, want)


def test_one_tf32_pass_misses_the_tolerance():
    """One TF32 pass keeps ~3 digits: the stem misses STEM_TOL."""
    folded = _torch_folded(_random_folded(2))
    x = torch.from_numpy(_pixels(75, "f32", seed=5))
    want = torch_stem.stem_reference(x, folded)
    one = emulated_stem(x, folded, mm=mm_1xtf32)
    assert _rel(one, want) > STEM_TOL, _rel(one, want)


@pytest.mark.parametrize("run", [1, 36])
def test_other_runs_pass_on_the_cpu(run):
    """Each k-step from zero (run 1), and all 36 chained through one
    accumulator (run 36), hold STEM_TOL on the CPU, where every float32
    add rounds to nearest."""
    folded = _torch_folded(_random_folded(2))
    x = torch.from_numpy(_pixels(59, "f32", seed=6))
    want = torch_stem.stem_reference(x, folded)
    got = emulated_stem(x, folded, run=run)
    assert _rel(got, want) <= STEM_TOL, _rel(got, want)


def test_uint8_pixels_are_exact_in_tf32():
    """Every uint8 pixel is its own TF32 big half, with a zero small half:
    the two-pass conv1 on uint8 pixels gives the three-pass result."""
    v = torch.arange(256, dtype=torch.float32)
    assert torch.equal(tf32(v), v)
    assert torch.equal(trunc(v - tf32(v)), torch.zeros(256))
    folded = _torch_folded(_random_folded(3))
    x = torch.from_numpy(_pixels(35, "u8", seed=7))
    two = emulated_stem(x, folded)
    three = emulated_stem(x.float(), folded)
    assert torch.equal(two, three)
