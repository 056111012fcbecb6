"""The numeric design of the fused 1x1-conv GEMM + BN-stats kernel
(sparkdl_torch/csrc/fused_gemm_bn.cu), emulated in plain torch.

The kernel runs its float32 product on the tensor cores as 3xTF32 (the
split of tests/test_torch_flash_bwd_tf32x3.py, big = tf32(x) rounded as
``cvt.rna.tf32.f32`` rounds), but leaves the small half x - big whole for
the tensor cores, which read its top 19 bits: truncated. Its design, as
emulated here:

- the previous BatchNorm's normalize and the ReLU (the prologue) run on
  the float32 operand before the TF32 split, so the split is of the
  normalized activation;
- K is contracted in 8-column k-steps, each through three TF32 passes; a
  run of k-steps sums from zero and reaches the output's accumulator in
  one float32 add (the kernel's runs: 4, one ring stage's 32-wide K
  slice);
- the bias is added to the float32 accumulator, and the stats (sum of y,
  sum of y²) are taken from it before y is stored.

Held to the port's plain version (``gemm_bn_stats_reference``) within
chip_smoke.py's GEMM_TOL (y) and STATS_TOL (batch mean and variance), up
to K = 2048, and to the JAX package's ``conv1x1_bn_stats`` (Pallas in
interpret mode) as tests/test_torch_fused_gemm_bn.py runs it. One TF32 pass
misses GEMM_TOL. On the CPU every add rounds to nearest, so chaining all
of K through one float32 accumulator passes here too: what makes the
kernel sum runs from zero is the tensor cores' own rounding of the running
sum an mma is handed, which shows only on the card (chip_smoke.py, and
tools/fwd_gemm_variants.py's "chain" variant).
"""

import numpy as np
import pytest
import torch

from chip_smoke import GEMM_TOL, STATS_TOL
from sparkdl_torch.ops import fused_gemm_bn as tfg
from sparkdl_tpu.ops import fused_gemm_bn as jfg
from test_torch_flash_bwd_tf32x3 import mm_1xtf32, tf32

torch.set_num_threads(2)
KERNEL_RUN = 4  # fused_gemm_bn.cu's RUN for float32


def trunc(x):
    """float32 -> its top 19 bits, as the tensor cores read a TF32 operand."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def mm_3xtf32(a, b):
    """a @ b as the kernel's products: small·big, big·small, big·big in
    float32, small the truncated remainder (split_tf32_trunc)."""
    a_big, b_big = tf32(a), tf32(b)
    a_small, b_small = trunc(a - a_big), trunc(b - b_big)
    acc = a_small @ b_big
    acc = acc + a_big @ b_small
    return acc + a_big @ b_big


def prologue(x, scale, shift, relu):
    """act(scale·x + shift) in float32: the A operand before the split."""
    a = x.float()
    if scale is not None:
        a = a * scale + shift
    return torch.relu(a) if relu else a


def emulated_gemm(x, w, scale, shift, bias, relu, mm, run=KERNEL_RUN):
    """(y, Σy, Σy²) as the kernel computes them: runs of ``run`` 8-column
    k-steps through mm, each run from zero, added to y in float32."""
    a, wf = prologue(x, scale, shift, relu), w.float()
    k = a.shape[1]
    y = torch.zeros((a.shape[0], wf.shape[1]))
    for r0 in range(0, k, 8 * run):
        part = None
        for k0 in range(r0, min(r0 + 8 * run, k), 8):
            p = mm(a[:, k0:k0 + 8], wf[k0:k0 + 8])
            part = p if part is None else part + p
        y = y + part
    if bias is not None:
        y = y + bias
    return y, y.sum(0), (y * y).sum(0)


def _moments(ysum, ysq, m):
    mean = ysum / m
    return mean, torch.clamp(ysq / m - mean * mean, min=0.0)


SHAPES = {
    # name: (m, k, n, prev BN, relu)
    "k2048_bn_relu": (96, 2048, 40, True, True),
    "k256_bn_no_relu": (100, 256, 72, True, False),
    "k64_plain": (130, 64, 48, False, False),
}


def _operands(name):
    m, k, n, prev, relu = SHAPES[name]
    r = np.random.default_rng(len(name))
    x = torch.from_numpy(r.standard_normal((m, k)).astype(np.float32))
    # the module's [Cout, Cin] weight, transposed, as the fused step passes it
    w = torch.from_numpy((r.standard_normal((n, k)) / np.sqrt(k)).astype(np.float32)).t()
    bias = torch.from_numpy(r.standard_normal(n).astype(np.float32) * 0.1)
    scale = shift = None
    if prev:
        scale = torch.from_numpy(r.random(k).astype(np.float32) + 0.5)
        shift = torch.from_numpy(r.standard_normal(k).astype(np.float32) * 0.3)
    return x, w, scale, shift, bias, relu


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_3xtf32_matches_the_plain_version(name):
    """y within GEMM_TOL, the batch mean and variance within STATS_TOL."""
    x, w, scale, shift, bias, relu = _operands(name)
    m = x.shape[0]
    y, ysum, ysq = emulated_gemm(x, w, scale, shift, bias, relu, mm_3xtf32)
    want_y, wsum, wsq = tfg.gemm_bn_stats_reference(x, w, scale, shift, bias, relu_in=relu)
    assert y.shape == want_y.shape
    assert _rel(y, want_y) <= GEMM_TOL, _rel(y, want_y)
    for got, want in zip(_moments(ysum, ysq, m), _moments(wsum, wsq, m)):
        assert _rel(got, want) <= STATS_TOL, _rel(got, want)


@pytest.mark.parametrize("relu", [True, False])
def test_3xtf32_matches_jax_conv1x1_bn_stats(relu):
    """The layer as the JAX package computes it (prev BN fused, K = 512),
    at tests/test_torch_fused_gemm_bn.py's tolerances."""
    r = np.random.default_rng(7)
    b, h, wd, cin, cout = 2, 6, 5, 512, 48
    x = r.standard_normal((b, h, wd, cin)).astype(np.float32)
    wk = (r.standard_normal((1, 1, cin, cout)) * 0.1).astype(np.float32)
    bi = r.standard_normal(cout).astype(np.float32)
    prev = (r.standard_normal(cin).astype(np.float32) * 0.2,
            np.abs(r.standard_normal(cin)).astype(np.float32) + 0.5,
            r.standard_normal(cin).astype(np.float32) * 0.5 + 1.0,
            r.standard_normal(cin).astype(np.float32) * 0.1, 1.001e-5)
    want = jfg.conv1x1_bn_stats(x, wk, bi, prev_bn=prev, relu_in=relu,
                                block_m=64, block_n=128, block_k=128)
    scale, shift = tfg._prev_bn_affine(tuple(torch.from_numpy(p) for p in prev[:4]) + prev[4:])
    y, ysum, ysq = emulated_gemm(torch.from_numpy(x.reshape(-1, cin)),
                                 torch.from_numpy(wk[0, 0]), scale, shift,
                                 torch.from_numpy(bi), relu, mm_3xtf32)
    m = b * h * wd
    got = (y.reshape(b, h, wd, cout),) + _moments(ysum, ysq, m)
    for g, w_, what in zip(got, want, ("y", "mean", "var")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), atol=1e-5, rtol=1e-5,
                                   err_msg=what)


def test_one_tf32_pass_misses_the_tolerance():
    """One TF32 pass keeps ~3 digits: at K = 2048 y misses GEMM_TOL."""
    x, w, scale, shift, bias, relu = _operands("k2048_bn_relu")
    want = tfg.gemm_bn_stats_reference(x, w, scale, shift, bias, relu_in=relu)[0]
    one = emulated_gemm(x, w, scale, shift, bias, relu, mm_1xtf32)[0]
    assert _rel(one, want) > GEMM_TOL, _rel(one, want)


@pytest.mark.parametrize("run", [1, 2, 256])
def test_other_runs_pass_on_the_cpu(run):
    """Runs of 1 and 2 k-steps, and all of K = 2048 chained through one
    accumulator (run 256), hold GEMM_TOL on the CPU, where every float32
    add rounds to nearest; only the card's tensor cores, which round the
    running sum they are handed their own way, tell them apart."""
    x, w, scale, shift, bias, relu = _operands("k2048_bn_relu")
    want = tfg.gemm_bn_stats_reference(x, w, scale, shift, bias, relu_in=relu)[0]
    y = emulated_gemm(x, w, scale, shift, bias, relu, mm_3xtf32, run=run)[0]
    assert _rel(y, want) <= GEMM_TOL, _rel(y, want)


def test_truncated_split_keeps_float32_accuracy():
    """big + trunc(x - big) stands for x within 2^-21 of |x|, biased toward
    zero; big alone within 2^-11."""
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(4096).astype(np.float32))
    big = tf32(x)
    small = trunc(x - big)
    assert float(((x - big) / x).abs().max()) <= 2.0 ** -11
    assert float(((x - big - small) / x).abs().max()) <= 2.0 ** -21
    assert bool(((x - big - small) * (x - big) >= 0).all())  # small shrinks toward zero
