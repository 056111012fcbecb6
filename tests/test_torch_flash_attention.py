"""The port's flash attention forward (sparkdl_torch/ops/flash_attention.py)
against the JAX package's (sparkdl_tpu/ops/flash_attention.py).

On CPU tensors the port's wrapper runs its plain PyTorch version; the CUDA
kernel is held against that plain version on the card by chip_smoke.py.
Here the port is held against the JAX Pallas kernel in interpret mode on
the same numpy inputs.

Tolerances: float32, max |diff| <= 1e-5 * max |ref| (both sides compute in
float32; only the summation order differs). bfloat16, 2**-6 * max |ref|:
two bfloat16 steps, since each side rounds its probabilities and its
output to bfloat16 at its own place. Rows whose keys are all masked (left
pad rows) are compared for finiteness only: there the JAX kernel averages
over its own padded key blocks, the port over the Lk keys.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparkdl_tpu.ops.flash_attention import flash_attention as jax_flash_attention
from sparkdl_torch.ops import flash_attention as torch_fa

F32_TOL, BF16_TOL = 1e-5, 2.0 ** -6


def _inputs(b, lq, lk, h, d, seed, pad=True):
    r = np.random.default_rng(seed)
    q, k, v = (r.standard_normal((b, n, h, d)).astype(np.float32)
               for n in (lq, lk, lk))
    mask = None
    if pad:  # left padding of random length, at least one real key
        mask = np.zeros((b, lk), bool)
        for i in range(b):
            mask[i, r.integers(0, lk):] = True
    return q, k, v, mask


def _live_rows(mask, b, lq, lk, causal, q_offset):
    """[B, Lq] bool: rows with at least one key to attend."""
    keep = np.ones((b, lq, lk), bool)
    if mask is not None:
        keep &= mask[:, None, :]
    if causal:
        keep &= np.arange(lk)[None, None, :] <= (
            q_offset + np.arange(lq))[None, :, None]
    return keep.any(-1)


def _torch(a, dtype=torch.float32):
    return None if a is None else torch.from_numpy(a).to(dtype)


def _assert_rows_close(got, want, live, tol):
    got = np.asarray(got.float() if torch.is_tensor(got) else got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    g, w = got[live], want[live]
    err = np.abs(g - w).max() / np.abs(w).max()
    assert err <= tol, err


CASES = {
    # name: (b, lq, lk, h, d, causal, q_offset, key mask)
    "causal_masked": (2, 24, 24, 2, 64, True, 0, True),
    "noncausal_masked": (2, 20, 20, 3, 64, False, 0, True),
    "noncausal_nomask": (1, 16, 16, 2, 16, False, 0, False),
    "cached_prefill_offset": (2, 13, 29, 2, 64, True, 16, True),
    "ragged_lengths_d16": (3, 11, 11, 1, 16, True, 0, True),
    "offset_no_mask_d16": (1, 7, 19, 2, 16, True, 12, False),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_matches_jax_kernel_f32(name):
    b, lq, lk, h, d, causal, q_offset, pad = CASES[name]
    q, k, v, mask = _inputs(b, lq, lk, h, d, seed=len(name), pad=pad)
    want = jax_flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if mask is None else jnp.asarray(mask),
        causal=causal, q_offset=q_offset, block_q=8, block_k=8)
    before = torch_fa.flash_attention.launches
    got = torch_fa.flash_attention(
        _torch(q), _torch(k), _torch(v),
        None if mask is None else torch.from_numpy(mask),
        causal=causal, q_offset=q_offset)
    assert torch_fa.flash_attention.launches == before  # CPU: plain version
    live = _live_rows(mask, b, lq, lk, causal, q_offset)
    _assert_rows_close(got, want, live, F32_TOL)


def test_matches_jax_kernel_bf16():
    b, lq, lk, h, d = 2, 24, 24, 2, 64
    q, k, v, mask = _inputs(b, lq, lk, h, d, seed=5)
    want = jax_flash_attention(
        *(jnp.asarray(t, jnp.bfloat16) for t in (q, k, v)), jnp.asarray(mask),
        causal=True, block_q=8, block_k=8)
    got = torch_fa.flash_attention(
        *(_torch(t, torch.bfloat16) for t in (q, k, v)),
        torch.from_numpy(mask), causal=True)
    assert got.dtype == torch.bfloat16
    live = _live_rows(mask, b, lq, lk, True, 0)
    _assert_rows_close(got, np.asarray(want, np.float32), live, BF16_TOL)


def test_all_masked_rows_are_uniform_and_finite():
    """A query row with no valid key (a left-pad row) gets equal weight on
    every key: the mean of v, never NaN."""
    q, k, v, _ = _inputs(1, 6, 6, 1, 16, seed=9, pad=False)
    mask = np.array([[False, False, False, True, True, True]])
    got = torch_fa.flash_attention(_torch(q), _torch(k), _torch(v),
                                   torch.from_numpy(mask), causal=True)
    # rows 0-2 see only pad keys (causally), rows 3-5 real ones
    np.testing.assert_allclose(got[0, :3].numpy(),
                               np.broadcast_to(v[0].mean(0), (3, 1, 16)),
                               rtol=1e-5, atol=1e-6)
    assert torch.isfinite(got).all()


def test_lse_matches_numpy():
    b, lq, lk, h, d = 2, 9, 21, 2, 16
    q, k, v, mask = _inputs(b, lq, lk, h, d, seed=11)
    _, lse = torch_fa.flash_attention(
        _torch(q), _torch(k), _torch(v), torch.from_numpy(mask),
        causal=True, q_offset=12, return_lse=True)
    s = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64), k) / math.sqrt(d)
    keep = mask[:, None, None, :] & (
        np.arange(lk)[None, :] <= 12 + np.arange(lq)[:, None])[None, None]
    s = np.where(keep, s, -np.inf)
    live = np.broadcast_to(keep.any(-1), (b, h, lq))
    want = np.log(np.exp(s - s.max(-1, keepdims=True)).sum(-1)) + s.max(-1)
    assert lse.shape == (b, h, lq) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy()[live], want[live], rtol=1e-5,
                               atol=1e-5)
    assert (lse.numpy()[~live] <= -1e29).all()


@pytest.mark.parametrize("bad,match", [
    (dict(q=(1, 4, 2, 16), k=(1, 4, 3, 16)), "matching q"),
    (dict(q=(1, 4, 2, 160), k=(1, 4, 2, 160)), "head dim"),
    (dict(q=(1, 4, 2, 16), k=(1, 0, 2, 16)), "at least one key"),
    (dict(q=(1, 4, 2, 16), k=(1, 4, 2, 16), mask=(1, 5)), "kv_mask"),
])
def test_rejects_bad_shapes(bad, match):
    q = torch.zeros(bad["q"])
    k = torch.zeros(bad["k"])
    mask = torch.ones(bad["mask"], dtype=torch.bool) if "mask" in bad else None
    with pytest.raises(ValueError, match=match):
        torch_fa.flash_attention(q, k, k, mask)


def test_rejects_mixed_dtypes_and_mixed_devices():
    q = torch.zeros((1, 4, 2, 16))
    with pytest.raises(TypeError, match="float32"):
        torch_fa.flash_attention(q, q.to(torch.bfloat16), q)
    with pytest.raises(ValueError, match="q_offset"):
        torch_fa.flash_attention(q, q, q, causal=True, q_offset=-1)
    with pytest.raises(ValueError, match="CPU or all on one CUDA device"):
        torch_fa.flash_attention(q, q.to("meta"), q.to("meta"))
