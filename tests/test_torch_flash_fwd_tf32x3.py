"""The numeric design of the flash attention forward kernel
(sparkdl_torch/csrc/flash_attention.cu), emulated in plain torch.

The kernel runs its float32 products on the tensor cores as 3xTF32 (the
split and the rounding of tests/test_torch_flash_bwd_tf32x3.py, as
``cvt.rna.tf32.f32`` rounds). Its design, as emulated here:

- S = q·kᵀ sums each 8-column k-step's three passes from zero and adds it
  to the running score in float32 (``mma_tf32x3_rn``);
- an online softmax over key tiles of the kernel's own width (32 keys;
  16 checked too): the running max starts at the -1e30 sentinel, a tile
  rescales the running sum and the output by exp(m_old - m_new);
- P = exp(s - m) goes into the P·V product split into TF32 big and small
  halves, each 8-key k-step summed from zero too and added to the rescaled
  output in float32 (the backward rebuilds p and reads O through
  delta = rowsum(dO·O), so O must agree with p closely).

Keys past Lk score -inf in the kernel and carry exactly zero weight, so the
emulation's last tile is simply short; causal tiles the kernel skips carry
exactly zero weight for rows with a valid key, and the kernel visits them
for the rows without one, so the emulation visits every tile.

Held to the port's plain forward within chip_smoke.py's ATTN_TOL (1e-5 x
max|ref|, output and lse, rows without a valid key included) and to the
JAX Pallas forward in interpret mode within ATTN_TOL on rows with a valid
key (the JAX kernel averages rows without one over its own padded blocks;
see tests/test_torch_flash_attention.py). One TF32 pass misses ATTN_TOL:
that is why the kernel takes three. The sums here round as float32 does on
the CPU; how the tensor cores round a running sum (why S is summed from
zero at each k-step) shows only on the card, in chip_smoke.py.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import ATTN_TOL
from sparkdl_torch.ops import flash_attention as torch_fa
from sparkdl_tpu.ops.flash_attention import flash_attention as jax_flash_attention
from test_torch_flash_bwd_tf32x3 import mm_1xtf32, mm_3xtf32

NEG = torch_fa.NEG_INF


def mm_steps(a, b, mm):
    """a @ b as the kernel's products: each 8-wide k-step through mm,
    summed from zero, added to the running sum in float32, in order."""
    out = None
    for k0 in range(0, a.shape[-1], 8):
        part = mm(a[..., k0:k0 + 8], b[..., k0:k0 + 8, :])
        out = part if out is None else out + part
    return out


def emulated_fwd(q, k, v, kv_mask, mm, *, causal=False, q_offset=0, bl=32):
    """(o, lse) as the kernel computes them, every product through mm;
    float32 [B, L, H, D] in, o [B, Lq, H, D] and lse [B, H, Lq] out."""
    b, lq, h, d = q.shape
    lk = k.shape[1]
    scale = 1.0 / math.sqrt(d)
    qh, kh, vh = (t.float().transpose(1, 2) for t in (q, k, v))
    keep = torch_fa._keep_mask(b, lq, lk, kv_mask, causal, q_offset, q.device)
    m = torch.full((b, h, lq), NEG)
    l = torch.zeros((b, h, lq))
    acc = torch.zeros((b, h, lq, d))
    for k0 in range(0, lk, bl):
        cols = slice(k0, min(k0 + bl, lk))
        s = mm_steps(qh, kh[:, :, cols].transpose(-1, -2), mm) * scale
        s = torch.where(keep[..., cols], s, NEG)
        m_new = torch.maximum(m, s.amax(-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + mm_steps(p, vh[:, :, cols], mm)
        m = m_new
    l = l.clamp_min(1e-30)
    return (acc / l[..., None]).transpose(1, 2), m + torch.log(l)


CASES = {
    # name: (b, lq, lk, h, d, causal, q_offset, mask): "left" pads each row's
    # start by a random length (causal rows before the first real key have
    # none), "dead" pads each row's end and leaves the last batch row no key
    "causal_left_pad": (2, 40, 40, 2, 32, True, 0, "left"),
    "cached_prefill_offset": (2, 12, 29, 2, 64, True, 17, "left"),
    "ragged_l37_dead_row": (2, 37, 37, 1, 64, False, 0, "dead"),
}


def _inputs(name):
    b, lq, lk, h, d, causal, q_offset, kind = CASES[name]
    r = np.random.default_rng(len(name))
    q = r.standard_normal((b, lq, h, d)).astype(np.float32)
    k, v = (r.standard_normal((b, lk, h, d)).astype(np.float32) for _ in "kv")
    mask = np.zeros((b, lk), bool)
    for i in range(b):
        if kind == "left":  # the first row: only its last two keys are real
            mask[i, lk - 2 if i == 0 else r.integers(1, lk):] = True
        else:
            mask[i, :r.integers(1, lk + 1)] = True
    if kind == "dead":
        mask[-1] = False
    return q, k, v, mask, causal, q_offset


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("bl", [16, 32])
@pytest.mark.parametrize("name", sorted(CASES))
def test_3xtf32_matches_the_plain_forward(name, bl):
    """Output and lse, rows without a valid key included (uniform average,
    lse -1e30), at the kernel's key-tile width and at 16."""
    q, k, v, mask, causal, q_offset = _inputs(name)
    tq, tk, tv, tm = (torch.from_numpy(t) for t in (q, k, v, mask))
    want, wlse = torch_fa.flash_attention_reference(tq, tk, tv, tm, causal=causal,
                                                    q_offset=q_offset, return_lse=True)
    got, lse = emulated_fwd(tq, tk, tv, tm, mm_3xtf32, causal=causal, q_offset=q_offset, bl=bl)
    dead = wlse <= torch_fa.DEAD_LSE
    assert bool(dead.any())
    assert torch.equal(lse <= torch_fa.DEAD_LSE, dead)
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    assert _rel(got, want) <= ATTN_TOL, _rel(got, want)
    assert _rel(lse[~dead], wlse[~dead]) <= ATTN_TOL, _rel(lse[~dead], wlse[~dead])


@pytest.mark.parametrize("name", sorted(CASES))
def test_3xtf32_matches_the_jax_forward(name):
    """Against the JAX Pallas forward (interpret mode), on rows with a
    valid key."""
    q, k, v, mask, causal, q_offset = _inputs(name)
    want = np.asarray(jax_flash_attention(
        *(jnp.asarray(t) for t in (q, k, v)), jnp.asarray(mask), causal=causal,
        q_offset=q_offset, block_q=16, block_k=16))
    tq, tk, tv, tm = (torch.from_numpy(t) for t in (q, k, v, mask))
    got, lse = emulated_fwd(tq, tk, tv, tm, mm_3xtf32, causal=causal, q_offset=q_offset)
    live = (lse > torch_fa.DEAD_LSE).transpose(1, 2).numpy()  # [B, Lq, H]
    g, w = got.numpy()[live], want[live]
    assert np.abs(g - w).max() / np.abs(w).max() <= ATTN_TOL


def test_one_tf32_pass_misses_the_tolerance():
    """One TF32 pass keeps ~3 digits: at D = 64, L = 128 the output misses
    ATTN_TOL, which three passes hold with room to spare."""
    r = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(r.standard_normal((1, 128, 2, 64)).astype(np.float32))
               for _ in range(3))
    want = torch_fa.flash_attention_reference(q, k, v)
    one, _ = emulated_fwd(q, k, v, None, mm_1xtf32)
    three, _ = emulated_fwd(q, k, v, None, mm_3xtf32)
    assert _rel(one, want) > ATTN_TOL, _rel(one, want)
    assert _rel(three, want) <= ATTN_TOL / 10, _rel(three, want)
