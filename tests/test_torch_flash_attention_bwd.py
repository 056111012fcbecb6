"""The port's flash attention backward (sparkdl_torch/ops/flash_attention.py)
against the JAX package's (sparkdl_tpu/ops/flash_attention.py), and the
repair of the forward-only wrappers.

On CPU tensors the port's backward is its plain version,
``flash_attention_bwd_reference``; the CUDA kernels are held against that
plain version on the card by chip_smoke.py. Here the plain version is held
to ``jax.grad`` of the JAX flash attention (Pallas in interpret mode) on
the shapes and tolerances of tests/ops/test_flash_attention.py (atol 5e-5,
rtol 5e-4), on rows with at least one valid key as that file builds them,
and to autograd through ``flash_attention_reference`` on every row, rows
without a valid key included (float32: 1e-5 x max|ref|, only the order of
the sums differs; bfloat16: 2^-5 x max|ref|, autograd rounds dP to
bfloat16 where the formula keeps it in float32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparkdl_tpu.ops.flash_attention import flash_attention as jax_flash_attention
from sparkdl_torch.ops import flash_attention as torch_fa


def _qkvw(b, lq, lk, h, d, seed):
    r = np.random.default_rng(seed)
    q = r.standard_normal((b, lq, h, d)).astype(np.float32)
    k, v = (r.standard_normal((b, lk, h, d)).astype(np.float32) for _ in "kv")
    w = r.standard_normal((b, lq, h, d)).astype(np.float32)
    return q, k, v, w, r


@pytest.mark.parametrize("b,l,h,d,causal,masked", [
    (2, 16, 2, 8, False, False),
    (1, 48, 2, 32, True, False),
    (2, 33, 1, 16, False, True),
])
def test_gradients_match_jax_grad(b, l, h, d, causal, masked):
    q, k, v, w, r = _qkvw(b, l, l, h, d, seed=l)
    mask = None
    if masked:  # first key always valid: every row has a valid key
        mask = r.random((b, l)) > 0.3
        mask[:, 0] = True

    def jloss(q, k, v):
        o = jax_flash_attention(q, k, v, None if mask is None else jnp.asarray(mask),
                                causal=causal, block_q=16, block_k=16)
        return jnp.sum(jnp.asarray(w) * o ** 2)

    want = jax.grad(jloss, (0, 1, 2))(*(jnp.asarray(t) for t in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(t).requires_grad_() for t in (q, k, v))
    o = torch_fa.flash_attention(tq, tk, tv, None if mask is None else torch.from_numpy(mask),
                                 causal=causal)
    (torch.from_numpy(w) * o ** 2).sum().backward()
    for got, exp, name in zip((tq.grad, tk.grad, tv.grad), want, "qkv"):
        np.testing.assert_allclose(got.numpy(), np.asarray(exp), atol=5e-5,
                                   rtol=5e-4, err_msg=f"d{name}")


CASES = {
    # name: (b, lq, lk, h, d, causal, q_offset)
    "noncausal": (2, 20, 20, 3, 16, False, 0),
    "causal": (2, 24, 24, 2, 32, True, 0),
    "cached_prefill_offset": (2, 13, 29, 2, 64, True, 16),
    "long_d128": (2, 9, 70, 1, 128, False, 0),
}


def _autograd_grads(q, k, v, mask, do, causal, q_offset):
    q, k, v = (t.clone().requires_grad_() for t in (q, k, v))
    o = torch_fa.flash_attention_reference(q, k, v, mask, causal=causal,
                                           q_offset=q_offset)
    o.backward(do)
    return q.grad, k.grad, v.grad


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_backward_equals_autograd_of_the_reference(name, dtype):
    """Every row, those without a valid key included: row 0 of batch 0
    has all its keys masked (p = 1/Lk there: dv gets dO/Lk, dq and dk
    nothing)."""
    b, lq, lk, h, d, causal, q_offset = CASES[name]
    q, k, v, w, r = _qkvw(b, lq, lk, h, d, seed=len(name))
    mask = r.random((b, lk)) > 0.4
    mask[0] = False  # batch row 0: no valid key at all
    q, k, v, do = (torch.from_numpy(t).to(dtype) for t in (q, k, v, w))
    mask = torch.from_numpy(mask)
    o, lse = torch_fa.flash_attention_reference(
        q, k, v, mask, causal=causal, q_offset=q_offset, return_lse=True)
    got = torch_fa.flash_attention_bwd(q, k, v, mask, o, lse, do,
                                       causal=causal, q_offset=q_offset)
    want = _autograd_grads(q, k, v, mask, do, causal, q_offset)
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -5
    for g, e, n in zip(got, want, "qkv"):
        assert g.dtype == dtype and g.shape == e.shape
        err = (g.float() - e.float()).abs().max() / e.float().abs().max()
        assert err <= tol, (n, float(err))
    # the dead rows: dv = sum over rows of dO / Lk, no dq
    assert float(got[0][0].abs().max()) == 0.0
    want_dv0 = do[0].float().sum(0, keepdim=True) / lk
    np.testing.assert_allclose(got[2][0].float().numpy(),
                               np.broadcast_to(want_dv0.numpy(), got[2][0].shape),
                               rtol=2e-2 if dtype == torch.bfloat16 else 1e-5,
                               atol=2e-2 if dtype == torch.bfloat16 else 1e-6)


def test_gradients_reach_q_k_v_through_flash_attention():
    """The repair: flash_attention is differentiable (on CUDA through the
    two backward kernels, here through the plain backward), with no kernel
    launch on CPU tensors."""
    q, k, v, w, _ = _qkvw(2, 12, 12, 2, 16, seed=3)
    tq, tk, tv = (torch.from_numpy(t).requires_grad_() for t in (q, k, v))
    before = (torch_fa.flash_attention.launches,
              torch_fa.flash_attention_bwd.launches_dq,
              torch_fa.flash_attention_bwd.launches_dkv)
    o, lse = torch_fa.flash_attention(tq, tk, tv, causal=True, return_lse=True)
    assert o.grad_fn is not None and not lse.requires_grad
    (o * torch.from_numpy(w)).sum().backward()
    for t in (tq, tk, tv):
        assert t.grad is not None and float(t.grad.abs().max()) > 0
    assert (torch_fa.flash_attention.launches,
            torch_fa.flash_attention_bwd.launches_dq,
            torch_fa.flash_attention_bwd.launches_dkv) == before


def test_forward_only_wrappers_refuse_grad():
    """inception_stem_fused and flash_decode have no backward (nor have
    their JAX counterparts): under grad mode with an input that requires
    grad they raise on both devices instead of detaching; under no_grad
    they run."""
    from sparkdl_torch.ops.flash_decode import flash_decode
    from sparkdl_torch.ops.stem_fused import _PARAM_SHAPES, inception_stem_fused

    q = torch.randn(2, 1, 2, 16, requires_grad=True)
    ck, cv = torch.randn(2, 8, 2, 16), torch.randn(2, 8, 2, 16)
    with pytest.raises(RuntimeError, match="flash_decode has no backward"):
        flash_decode(q, ck, cv, 5)
    with torch.no_grad():
        assert flash_decode(q, ck, cv, 5).shape == (2, 1, 2, 16)

    folded = {n: torch.rand(s) for n, s in _PARAM_SHAPES.items()}
    folded["k1"].requires_grad_()
    x = torch.rand(1, 15, 15, 3) * 255
    with pytest.raises(RuntimeError, match="inception_stem_fused has no backward"):
        inception_stem_fused(x, folded)
    with torch.inference_mode():
        assert inception_stem_fused(x, folded).shape == (1, 2, 2, 64)


def test_backward_rejects_bad_arguments():
    q = torch.zeros(1, 4, 2, 16)
    o, lse = torch_fa.flash_attention(q, q, q, return_lse=True)
    with pytest.raises(ValueError, match="lse must be float32"):
        torch_fa.flash_attention_bwd(q, q, q, None, o, lse[:, :, :2], o)
    with pytest.raises(ValueError, match="o and do must be"):
        torch_fa.flash_attention_bwd(q, q, q, None, o, lse, o[:, :2])
