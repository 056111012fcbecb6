"""The port's flash decode (sparkdl_torch/ops/flash_decode.py) against the
JAX package's (sparkdl_tpu/ops/flash_decode.py): the JAX Pallas kernel in
interpret mode and its dense ``reference_decode``, on the same numpy
inputs, at the fill levels of tests/ops/test_flash_decode.py, with and
without ragged ``start``.

On CPU tensors the port's wrapper runs its plain PyTorch version; the CUDA
kernel is held against that plain version on the card by chip_smoke.py.

Tolerances: float32, max |diff| <= 1e-5 * max |ref| (float32 on both
sides, summation order differs). bfloat16, 2**-6 * max |ref| (two bfloat16
steps: each side rounds to bfloat16 at its own place).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparkdl_tpu.ops.flash_decode import flash_decode as jax_flash_decode
from sparkdl_tpu.ops.flash_decode import reference_decode as jax_reference
from sparkdl_torch.ops import flash_decode as torch_fd

F32_TOL, BF16_TOL = 1e-5, 2.0 ** -6


def _mk(b, lmax, h, d, seed):
    r = np.random.default_rng(seed)
    return tuple(r.standard_normal(s).astype(np.float32)
                 for s in ((b, 1, h, d), (b, lmax, h, d), (b, lmax, h, d)))


def _assert_close(got, want, tol):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= tol, err


@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("idx", [0, 1, 63, 100, 255])
def test_matches_jax_at_fill_levels(idx, ragged):
    q, ck, cv = _mk(2, 256, 3, 64, seed=idx)
    # ragged: one row starts at 0, one inside the written prefix
    start = np.array([0, idx // 2], np.int32) if ragged else None
    js = None if start is None else jnp.asarray(start)
    want_kernel = jax_flash_decode(q, ck, cv, idx, start=js, block_k=64)
    want_dense = jax_reference(q, ck, cv, idx, start=js)
    before = torch_fd.flash_decode.launches
    got = torch_fd.flash_decode(
        *(torch.from_numpy(t) for t in (q, ck, cv)), idx,
        start=None if start is None else torch.from_numpy(start))
    assert torch_fd.flash_decode.launches == before  # CPU: plain version
    _assert_close(got, want_kernel, F32_TOL)
    _assert_close(got, want_dense, F32_TOL)


def test_head_dim_32_and_odd_cache_length():
    q, ck, cv = _mk(1, 96, 2, 32, seed=3)
    for idx in (0, 42, 95):
        want = jax_flash_decode(q, ck, cv, idx, block_k=64)
        got = torch_fd.flash_decode(*(torch.from_numpy(t) for t in (q, ck, cv)),
                                    idx)
        _assert_close(got, want, F32_TOL)


def test_bf16():
    q, ck, cv = _mk(2, 128, 2, 64, seed=4)
    start = np.array([5, 40], np.int32)
    qb, kb, vb = (jnp.asarray(t, jnp.bfloat16) for t in (q, ck, cv))
    want = jax_reference(qb, kb, vb, 100, start=jnp.asarray(start))
    got = torch_fd.flash_decode(
        *(torch.from_numpy(t).to(torch.bfloat16) for t in (q, ck, cv)), 100,
        start=torch.from_numpy(start))
    assert got.dtype == torch.bfloat16
    _assert_close(got, np.asarray(want, np.float32), BF16_TOL)


def test_row_with_no_valid_column_is_uniform():
    """start > idx leaves no valid column: every score is the -1e30
    sentinel and the softmax is uniform over the whole cache, as in the
    JAX dense path."""
    q, ck, cv = _mk(2, 16, 1, 16, seed=5)
    start = np.array([0, 9], np.int32)
    want = jax_reference(q, ck, cv, 4, start=jnp.asarray(start))
    got = torch_fd.flash_decode(*(torch.from_numpy(t) for t in (q, ck, cv)), 4,
                                start=torch.from_numpy(start))
    _assert_close(got, want, F32_TOL)
    np.testing.assert_allclose(got[1, 0].numpy(), cv[1].mean(0), rtol=1e-5,
                               atol=1e-6)


def test_rejects_bad_arguments():
    q, ck, cv = (torch.from_numpy(t) for t in _mk(1, 8, 2, 16, seed=6))
    with pytest.raises(ValueError, match="single-query"):
        torch_fd.flash_decode(torch.zeros((1, 2, 2, 16)), ck, cv, 0)
    with pytest.raises(ValueError, match="outside the cache"):
        torch_fd.flash_decode(q, ck, cv, 8)
    with pytest.raises(TypeError, match="host int"):
        torch_fd.flash_decode(q, ck, cv, torch.tensor(3))
    with pytest.raises(ValueError, match="int32"):
        torch_fd.flash_decode(q, ck, cv, 3, start=torch.zeros(1, dtype=torch.int64))
    with pytest.raises(TypeError, match="float32"):
        torch_fd.flash_decode(q, ck.to(torch.bfloat16), cv, 3)
