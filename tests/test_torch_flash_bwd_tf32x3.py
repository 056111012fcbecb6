"""The numeric design of the flash attention backward kernels
(sparkdl_torch/csrc/flash_attention_bwd.cu), emulated in plain torch.

The kernels run their float32 products on the tensor cores as 3xTF32:
each operand x splits as big = tf32(x), small = tf32(x - big), rounded as
``cvt.rna.tf32.f32`` rounds (to nearest, ties away from zero), and a
product sums small·big + big·small + big·big in float32. Here the five
products of the backward (S = q·kᵀ, dP = dO·vᵀ, dv = pᵀ·dO, dq = ds·k,
dk = dsᵀ·q) go through that emulation and are held to the port's plain
backward within chip_smoke.py's BWD_TOL (1e-4 x max|ref|, the tolerance
the kernels are held to on the card), rows without a valid key included,
and to ``jax.grad`` of the JAX flash attention (Pallas in interpret mode)
within tests/test_torch_flash_attention_bwd.py's atol 5e-5 / rtol 5e-4.
One TF32 pass misses BWD_TOL at D = 64, L = 128: that is why the kernels
take three. The sums here round as float32 does on the CPU; how the tensor
cores round their running sums (the reason the kernels sum S and dP from
zero at each k-step) shows only on the card, in chip_smoke.py.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import BWD_TOL
from sparkdl_torch.ops import flash_attention as torch_fa
from sparkdl_tpu.ops.flash_attention import flash_attention as jax_flash_attention


def tf32(x):
    """float32 -> the TF32 value cvt.rna.tf32.f32 gives, low 13 bits zero."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def mm_3xtf32(a, b):
    """a @ b as the kernels' float32 products: small·big, big·small, then
    big·big, each exact in float32 (11-bit by 11-bit significands), summed
    in float32."""
    a_big, b_big = tf32(a), tf32(b)
    a_small, b_small = tf32(a - a_big), tf32(b - b_big)
    acc = a_small @ b_big
    acc = acc + a_big @ b_small
    return acc + a_big @ b_big


def mm_1xtf32(a, b):
    return tf32(a) @ tf32(b)


def emulated_bwd(q, k, v, kv_mask, o, lse, do, mm, *, causal=False, q_offset=0):
    """(dq, dk, dv) as the kernels compute them, every product through mm;
    float32 [B, L, H, D] in and out. A row with no valid key (lse <=
    -1e29) has p = 1/Lk and ds = 0."""
    b, lq, _, d = q.shape
    lk = k.shape[1]
    scale = 1.0 / math.sqrt(d)
    qh, kh, vh, doh = (t.float().transpose(1, 2) for t in (q, k, v, do))
    keep = torch_fa._keep_mask(b, lq, lk, kv_mask, causal, q_offset, q.device)
    s = mm(qh, kh.transpose(-1, -2)) * scale
    dead = (lse <= torch_fa.DEAD_LSE)[..., None]
    p = torch.where(dead, 1.0 / lk,
                    torch.where(keep, torch.exp(s - lse[..., None]), 0.0))
    dv = mm(p.transpose(-1, -2), doh)
    dp = mm(doh, vh.transpose(-1, -2))
    ds = torch.where(keep, p * (dp - torch_fa._delta(o, do)[..., None]) * scale, 0.0)
    dq = mm(ds, kh)
    dk = mm(ds.transpose(-1, -2), qh)
    return tuple(t.transpose(1, 2) for t in (dq, dk, dv))


CASES = {
    # name: (b, l, h, d, causal)
    "causal_d32": (2, 48, 2, 32, True),
    "masked_d16": (2, 33, 1, 16, False),
    "bert_like_d64": (2, 128, 2, 64, False),
}


def _inputs(name, dead_row):
    b, l, h, d, causal = CASES[name]
    r = np.random.default_rng(len(name))
    q, k, v, w = (r.standard_normal((b, l, h, d)).astype(np.float32) for _ in range(4))
    mask = r.random((b, l)) > 0.3
    mask[:, 0] = True
    if dead_row:
        mask[-1] = False  # the last batch row: no valid key at all
    return q, k, v, w, mask, causal


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("name", sorted(CASES))
def test_3xtf32_matches_the_plain_backward(name):
    """Masks, causal, and a batch row with no valid key."""
    q, k, v, do, mask, causal = (torch.from_numpy(t) if isinstance(t, np.ndarray) else t
                                 for t in _inputs(name, dead_row=True))
    o, lse = torch_fa.flash_attention_reference(q, k, v, mask, causal=causal,
                                                return_lse=True)
    assert bool((lse <= torch_fa.DEAD_LSE).any())
    want = torch_fa.flash_attention_bwd_reference(q, k, v, mask, o, lse, do, causal=causal)
    got = emulated_bwd(q, k, v, mask, o, lse, do, mm_3xtf32, causal=causal)
    for g, e, n in zip(got, want, ("dq", "dk", "dv")):
        assert g.shape == e.shape
        assert _rel(g, e) <= BWD_TOL, (n, _rel(g, e))


@pytest.mark.parametrize("name", sorted(CASES))
def test_3xtf32_matches_jax_grad(name):
    """Against the JAX package's backward, on rows with a valid key (the
    JAX kernel treats rows without one differently; see the GPT parity
    note in tests/test_torch_flash_attention_bwd.py)."""
    q, k, v, w, mask, causal = _inputs(name, dead_row=False)

    def jloss(q, k, v):
        o = jax_flash_attention(q, k, v, jnp.asarray(mask), causal=causal,
                                block_q=16, block_k=16)
        return jnp.sum(jnp.asarray(w) * o ** 2)

    want = jax.grad(jloss, (0, 1, 2))(*(jnp.asarray(t) for t in (q, k, v)))
    tq, tk, tv, tw, tm = (torch.from_numpy(t) for t in (q, k, v, w, mask))
    o, lse = torch_fa.flash_attention_reference(tq, tk, tv, tm, causal=causal,
                                                return_lse=True)
    got = emulated_bwd(tq, tk, tv, tm, o, lse, 2.0 * tw * o, mm_3xtf32, causal=causal)
    for g, e, n in zip(got, want, "qkv"):
        np.testing.assert_allclose(g.numpy(), np.asarray(e), atol=5e-5, rtol=5e-4,
                                   err_msg=f"d{n} {name}")


def test_one_tf32_pass_misses_the_tolerance():
    """One TF32 pass keeps ~3 digits: at D = 64, L = 128 each of dq, dk, dv
    misses BWD_TOL, which three passes hold."""
    q, k, v, do, mask, _ = (torch.from_numpy(t) if isinstance(t, np.ndarray) else t
                            for t in _inputs("bert_like_d64", dead_row=True))
    o, lse = torch_fa.flash_attention_reference(q, k, v, mask, return_lse=True)
    want = torch_fa.flash_attention_bwd_reference(q, k, v, mask, o, lse, do)
    one = emulated_bwd(q, k, v, mask, o, lse, do, mm_1xtf32)
    three = emulated_bwd(q, k, v, mask, o, lse, do, mm_3xtf32)
    for g1, g3, e, n in zip(one, three, want, ("dq", "dk", "dv")):
        assert _rel(g1, e) > BWD_TOL, (n, _rel(g1, e))
        assert _rel(g3, e) <= BWD_TOL / 10, (n, _rel(g3, e))


@pytest.mark.parametrize("x,want", [
    (1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10),        # a tie: away from zero
    (-(1.0 + 2.0 ** -11), -(1.0 + 2.0 ** -10)),
    (1.0 + 2.0 ** -12, 1.0),                      # below half an ulp: down
    (1.0 + 3 * 2.0 ** -11, 1.0 + 2.0 ** -9),      # a tie on an odd ulp: away
    (2.0 - 2.0 ** -12, 2.0),                      # carries into the exponent
])
def test_tf32_rounds_as_cvt_rna(x, want):
    got = tf32(torch.tensor([x], dtype=torch.float32))
    assert float(got[0]) == want
    assert int(got.view(torch.int32)[0]) & 0x1FFF == 0


def test_split_keeps_float32_accuracy():
    """big + small stands for x within 2^-22 of |x|; big alone within 2^-11."""
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(4096).astype(np.float32))
    big = tf32(x)
    small = tf32(x - big)
    assert float(((x - big) / x).abs().max()) <= 2.0 ** -11
    assert float(((x - big - small) / x).abs().max()) <= 2.0 ** -22
