"""The port's fused 1x1-conv GEMM + BN-stats op (sparkdl_torch/ops/
fused_gemm_bn.py) against the JAX package's (sparkdl_tpu/ops/
fused_gemm_bn.py, Pallas in interpret mode), forward and gradients, at
that package's own test tolerances (tests/ops/test_fused_gemm_bn.py):
forward 1e-5 (both sides float32), grads 1e-3, the two-layer chain 2e-3,
bfloat16 3e-2.

On CPU tensors the port runs its plain version; the CUDA kernel is held
against it on the card by chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparkdl_tpu.ops import fused_gemm_bn as jfg
from sparkdl_torch.ops import fused_gemm_bn as tfg

rng = np.random.default_rng(3)


def _mk(b, h, w, cin, cout, bias=True, bn=False):
    x = rng.standard_normal((b, h, w, cin)).astype(np.float32)
    wk = (rng.standard_normal((1, 1, cin, cout)) * 0.1).astype(np.float32)
    bi = rng.standard_normal(cout).astype(np.float32) if bias else None
    prev = None
    if bn:
        prev = (rng.standard_normal(cin).astype(np.float32) * 0.2,
                np.abs(rng.standard_normal(cin)).astype(np.float32) + 0.5,
                rng.standard_normal(cin).astype(np.float32) * 0.5 + 1.0,
                rng.standard_normal(cin).astype(np.float32) * 0.1,
                1.001e-5)
    return x, wk, bi, prev


def _t(a, grad=False):
    if a is None:
        return None
    t = torch.from_numpy(np.array(a))
    return t.requires_grad_() if grad else t


def _prev_t(prev, grad=False):
    if prev is None:
        return None
    return tuple(_t(p, grad) for p in prev[:4]) + (prev[4],)


@pytest.mark.parametrize("shape", [
    (2, 8, 8, 32, 64), (3, 7, 5, 24, 48), (1, 16, 16, 64, 16)])
@pytest.mark.parametrize("bn,relu", [(False, False), (True, True),
                                     (True, False), (False, True)])
def test_forward_matches_jax(shape, bn, relu):
    x, wk, bi, prev = _mk(*shape, bn=bn)
    want = jfg.conv1x1_bn_stats(x, wk, bi, prev_bn=prev, relu_in=relu,
                                block_m=64, block_n=128, block_k=128)
    before = tfg.gemm_bn_stats.launches
    got = tfg.conv1x1_bn_stats(_t(x), _t(wk), _t(bi), prev_bn=_prev_t(prev),
                               relu_in=relu)
    assert tfg.gemm_bn_stats.launches == before  # CPU: the plain version
    for g, w_, name in zip(got, want, ("y", "mean", "var")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), atol=1e-5,
                                   rtol=1e-5, err_msg=name)
    plain = tfg.reference_conv1x1_bn_stats(_t(x), _t(wk), _t(bi),
                                           prev_bn=_prev_t(prev), relu_in=relu)
    for g, p in zip(got, plain):
        np.testing.assert_allclose(g.numpy(), p.numpy(), atol=1e-5, rtol=1e-5)


def test_forward_stride2_matches_jax():
    x, wk, bi, prev = _mk(2, 8, 8, 16, 32, bn=True)
    want = jfg.conv1x1_bn_stats(x, wk, bi, prev_bn=prev, relu_in=True, stride=2,
                                block_m=64, block_n=128, block_k=128)
    got = tfg.conv1x1_bn_stats(_t(x), _t(wk), _t(bi), prev_bn=_prev_t(prev),
                               relu_in=True, stride=2)
    assert got[0].shape == (2, 4, 4, 32)
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), atol=1e-5, rtol=1e-5)


def test_bf16_matches_jax_tolerance():
    x, wk, bi, prev = _mk(2, 8, 8, 32, 64, bn=True)
    want = jfg.conv1x1_bn_stats(jnp.bfloat16(x), jnp.bfloat16(wk), bi,
                                prev_bn=prev, relu_in=True, block_m=64,
                                block_n=128, block_k=128)
    got = tfg.conv1x1_bn_stats(_t(x).bfloat16(), _t(wk).bfloat16(), _t(bi),
                               prev_bn=_prev_t(prev), relu_in=True)
    assert got[0].dtype == torch.bfloat16
    np.testing.assert_allclose(got[0].float().numpy(),
                               np.asarray(want[0], np.float32), atol=3e-2, rtol=3e-2)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=3e-2,
                               rtol=3e-2)


def _loss_terms(y, m, v):
    return (y * y).sum() + (torch.sin(m) * 3.0).sum() + (v * v * 0.5).sum()


@pytest.mark.parametrize("bn,relu", [(True, True), (False, False), (True, False)])
def test_grads_match_jax(bn, relu):
    """The custom backward (stat cotangents folded into dY') against
    jax.grad of the JAX op, for a loss that touches y, mean and var."""
    x, wk, bi, prev = _mk(2, 4, 4, 16, 24, bn=bn)

    def jloss(x, wk, bi, prev):
        y, m, v = jfg.conv1x1_bn_stats(x, wk, bi, prev_bn=prev, relu_in=relu,
                                       block_m=32, block_n=128, block_k=128)
        return jnp.sum(y * y) + jnp.sum(jnp.sin(m) * 3.0) + jnp.sum(v * v * 0.5)

    argnums = (0, 1, 2) if prev is None else (0, 1, 2, 3)
    want = jax.tree.leaves(jax.grad(jloss, argnums)(x, wk, bi, prev))
    tx, tw, tb = _t(x, True), _t(wk, True), _t(bi, True)
    tprev = _prev_t(prev, True)
    _loss_terms(*tfg.conv1x1_bn_stats(tx, tw, tb, prev_bn=tprev,
                                      relu_in=relu)).backward()
    got = [tx.grad, tw.grad, tb.grad]
    if tprev is not None:
        got += [p.grad for p in tprev[:4]]
    want = want[:len(got)]  # jax's leaves: the eps float gets no gradient
    assert len(got) == len(want)
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), atol=1e-3, rtol=1e-3)


def test_two_layer_chain_grads_match_jax():
    """The resnet_fused seam: layer 1's moments are layer 2's prev_bn, so
    layer 2's cotangents reach layer 1 through y AND through its moments."""
    x, w1, b1, _ = _mk(2, 4, 4, 16, 24)
    w2 = (rng.standard_normal((1, 1, 24, 32)) * 0.1).astype(np.float32)
    b2 = rng.standard_normal(32).astype(np.float32)
    gamma = (rng.standard_normal(24) * 0.3 + 1.0).astype(np.float32)
    beta = (rng.standard_normal(24) * 0.1).astype(np.float32)
    args = (x, w1, b1, w2, b2, gamma, beta)

    def chain(op, lib):
        def f(x, w1, b1, w2, b2, gamma, beta):
            y1, m1, v1 = op(x, w1, b1)
            y2, m2, v2 = op(y1, w2, b2, prev_bn=(m1, v1, gamma, beta, 1e-5),
                            relu_in=True)
            return ((y2 * y2).sum() + (m2 * 2.0).sum()
                    + lib.sqrt(v2 + 1.0).sum())
        return f

    def jop(*a, **k):
        return jfg.conv1x1_bn_stats(*a, block_m=32, block_n=128, block_k=128, **k)

    want = jax.grad(chain(jop, jnp), argnums=tuple(range(7)))(*args)
    targs = [_t(a, True) for a in args]
    chain(tfg.conv1x1_bn_stats, torch)(*targs).backward()
    for t, w_ in zip(targs, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w_), atol=2e-3,
                                   rtol=2e-3)


def test_plain_gemm_backward_equals_autograd():
    """gemm_bn_stats's backward (the JAX _bwd_rule in torch ops) against
    autograd through its own plain version."""
    r = np.random.default_rng(0)
    x, w = r.standard_normal((37, 24)), r.standard_normal((24, 40)) * 0.1
    sc, sh = r.random(24) + 0.5, r.standard_normal(24) * 0.1
    bias = r.standard_normal(40)
    grads = []
    for fn in (tfg.gemm_bn_stats, tfg.gemm_bn_stats_reference):
        ts = [torch.tensor(a, dtype=torch.float32, requires_grad=True)
              for a in (x, w, sc, sh, bias)]
        y, s, q = fn(*ts, relu_in=True)
        ((y ** 2).sum() + s.sum() * 0.3 + (q * 0.01).sum()).backward()
        grads.append([t.grad for t in ts])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_rejects_bad_arguments():
    x = torch.zeros(8, 16)
    with pytest.raises(ValueError, match=r"x \[M, K\] and w \[K, N\]"):
        tfg.gemm_bn_stats(x, torch.zeros(15, 4))
    with pytest.raises(TypeError, match="float32 or both bfloat16"):
        tfg.gemm_bn_stats(x, torch.zeros(16, 4, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="scale and shift come together"):
        tfg.gemm_bn_stats(x, torch.zeros(16, 4), torch.ones(16))
    with pytest.raises(ValueError, match="bias must be float32"):
        tfg.gemm_bn_stats(x, torch.zeros(16, 4), bias=torch.zeros(5))
    with pytest.raises(ValueError, match="M, K, N >= 1"):
        tfg.gemm_bn_stats(torch.zeros(0, 16), torch.zeros(16, 4))
    with pytest.raises(ValueError, match="not a 1x1 kernel"):
        tfg.conv1x1_bn_stats(torch.zeros(1, 2, 2, 16), torch.zeros(3, 3, 16, 4))
