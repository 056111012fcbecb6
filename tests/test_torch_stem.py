"""The port's InceptionV3 stem (sparkdl_torch/ops/stem_fused.py) against
the JAX package's (sparkdl_tpu/ops/stem_fused.py).

On CPU tensors the port's wrapper runs its plain PyTorch version; the
CUDA kernel itself is held against that plain version on the card by
chip_smoke.py. Here the plain version is held against the JAX reference
(XLA convs) and against the JAX Pallas kernel in interpret mode, on the
same numpy inputs.

Tolerance: max |diff| <= 1e-5 * max |ref|. Both sides compute in float32;
only the order of the 288-term conv sums differs (~1e-7 relative).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparkdl_tpu.ops import stem_fused as jax_stem
from sparkdl_torch.models.convert import flax_to_torch
from sparkdl_torch.ops import _dispatch
from sparkdl_torch.ops import stem_fused as torch_stem

torch.set_num_threads(2)
TOL = 1e-5


def _random_folded(seed=0):
    r = np.random.default_rng(seed)
    f = {}
    for i, (ci, co) in enumerate(((3, 32), (32, 32), (32, 64)), start=1):
        f[f"k{i}"] = r.standard_normal((3, 3, ci, co)).astype(np.float32) * 0.1
        f[f"s{i}"] = (0.5 + r.random(co)).astype(np.float32)
        f[f"b{i}"] = r.standard_normal(co).astype(np.float32) * 0.1
    return f


def _torch_folded(folded):
    return {k: torch.from_numpy(v) for k, v in folded.items()}


def _pixels(size, pixel_dtype, seed=3, batch=2):
    x = np.random.default_rng(seed).integers(0, 256, (batch, size, size, 3),
                                             dtype=np.uint8)
    return x if pixel_dtype == "u8" else x.astype(np.float32)


def _assert_close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = np.abs(want).max()
    assert scale > 0
    assert np.abs(got - want).max() <= tol * scale, np.abs(got - want).max() / scale


@pytest.mark.parametrize("pixel_dtype", ["u8", "f32"])
@pytest.mark.parametrize("size", [59, 75])
def test_plain_stem_matches_jax_reference(size, pixel_dtype):
    folded = _random_folded()
    x = _pixels(size, pixel_dtype)
    want = jax_stem.stem_reference(jnp.asarray(x), folded)
    got = torch_stem.stem_reference(torch.from_numpy(x), _torch_folded(folded))
    _assert_close(got, want)


def test_wrapper_on_cpu_matches_jax_kernel_interpret():
    """The JAX Pallas kernel itself (interpret mode) vs the port's wrapper
    on CPU tensors, which runs the plain version and counts no launch."""
    folded = _random_folded(1)
    x = _pixels(59, "u8", seed=4)
    want = jax_stem.inception_stem_fused(
        jnp.asarray(x), jax_stem.pack_stem_params(folded),
        dtype=jnp.float32, interpret=True)
    before = torch_stem.inception_stem_fused.launches
    got = torch_stem.inception_stem_fused(torch.from_numpy(x),
                                          _torch_folded(folded), dtype=torch.float32)
    assert torch_stem.inception_stem_fused.launches == before
    assert got.dtype == torch.float32
    _assert_close(got, want)


def test_wrapper_default_dtype_is_the_references():
    """bfloat16, as the JAX kernel's (ROADMAP C17); the featurizer passes
    its dtype, so no path's output depends on the default."""
    import inspect

    def default(fn):
        return inspect.signature(fn).parameters["dtype"].default

    assert default(jax_stem.inception_stem_fused) == jnp.bfloat16
    assert default(torch_stem.inception_stem_fused) == torch.bfloat16
    folded = _torch_folded(_random_folded(3))
    x = torch.from_numpy(_pixels(59, "u8", seed=6))
    assert torch_stem.inception_stem_fused(x, folded).dtype == torch.bfloat16


def test_wrapper_bf16_output_on_cpu():
    folded = _torch_folded(_random_folded(2))
    x = torch.from_numpy(_pixels(59, "f32", seed=5))
    got = torch_stem.inception_stem_fused(x, folded, dtype=torch.bfloat16)
    want = torch_stem.stem_reference(x, folded)
    assert got.dtype == torch.bfloat16
    # one bf16 rounding of the f32 result: 2^-8 relative at most
    _assert_close(got.float(), want, tol=2.0 ** -8)


@pytest.mark.parametrize("size", [11, 59, 75, 299])
def test_output_size_matches_jax_geometry(size):
    hs = (size + 1) // 2
    rp_jax = ((hs - 3) - 3) // 2 + 1
    assert torch_stem.stem_out_size(size) == rp_jax


@pytest.mark.parametrize("tf_fold", [False, True])
def test_fold_stem_params_matches_jax(tf_fold):
    """Same variables through both packages' folds (and, with tf_fold, the
    'tf' preprocess fold first): equal to float32 rounding."""
    from sparkdl_torch.ops.fold import fold_tf_preprocess as torch_fold_tf
    from sparkdl_tpu.ops.fold import fold_tf_preprocess as jax_fold_tf

    r = np.random.default_rng(6)
    params, stats = {}, {}
    for i, (ci, co) in enumerate(((3, 32), (32, 32), (32, 64))):
        params[f"conv{i:03d}"] = {
            "kernel": r.standard_normal((3, 3, ci, co)).astype(np.float32)}
        params[f"bn{i:03d}"] = {"bias": r.standard_normal(co).astype(np.float32)}
        stats[f"bn{i:03d}"] = {
            "mean": r.standard_normal(co).astype(np.float32),
            "var": (0.5 + r.random(co)).astype(np.float32)}
    variables = {"params": params, "batch_stats": stats}
    sd = flax_to_torch(variables)
    if tf_fold:
        jvars = {"params": {k: {f: jnp.asarray(a) for f, a in v.items()}
                            for k, v in params.items()},
                 "batch_stats": {k: {f: jnp.asarray(a) for f, a in v.items()}
                                 for k, v in stats.items()}}
        variables = jax_fold_tf(jvars)
        sd = torch_fold_tf(sd)
    want = jax_stem.fold_stem_params(variables)
    got = torch_stem.fold_stem_params(sd)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-6, atol=1e-6)


def _bad_inputs():
    ok = _torch_folded(_random_folded())
    x = torch.zeros((1, 59, 59, 3), dtype=torch.uint8)
    bad_k = dict(ok, k2=torch.zeros((3, 3, 32, 16)))
    bad_s = dict(ok, s3=torch.zeros(64, dtype=torch.float64))
    return [
        ("int32 pixels", x.int(), ok, torch.float32, TypeError),
        ("float64 pixels", x.double(), ok, torch.float32, TypeError),
        ("NCHW", x.permute(0, 3, 1, 2), ok, torch.float32, ValueError),
        ("non-square", x[:, :58], ok, torch.float32, ValueError),
        ("too small", x[:, :10, :10], ok, torch.float32, ValueError),
        ("rank 3", x[0], ok, torch.float32, ValueError),
        ("float16 output", x, ok, torch.float16, TypeError),
        ("wrong kernel shape", x, bad_k, torch.float32, ValueError),
        ("float64 scale", x, bad_s, torch.float32, ValueError),
    ]


@pytest.mark.parametrize("case", _bad_inputs(), ids=lambda c: c[0])
def test_wrapper_rejects_bad_input(case):
    _, x, folded, dtype, exc = case
    with pytest.raises(exc):
        torch_stem.inception_stem_fused(x, folded, dtype=dtype)


def test_wrapper_never_falls_back_off_cpu(monkeypatch):
    """A tensor off the CPU takes the kernel route or raises: a device that
    is neither CPU nor CUDA raises, and a CUDA route on a machine without
    CUDA raises from the kernel loader — never the plain version."""
    folded = _torch_folded(_random_folded())
    with pytest.raises(ValueError, match="CPU or all on one CUDA"):
        torch_stem.inception_stem_fused(
            torch.zeros((1, 59, 59, 3), device="meta"), folded)
    # route CPU tensors to the kernel, as a CUDA tensor would be routed
    monkeypatch.setattr(torch_stem, "on_cuda", lambda *t: True)
    before = torch_stem.inception_stem_fused.launches
    with pytest.raises(RuntimeError, match="CUDA"):
        torch_stem.inception_stem_fused(torch.zeros((1, 59, 59, 3)), folded)
    assert torch_stem.inception_stem_fused.launches == before


def test_cuda_requests_raise_without_cuda():
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="CUDA"):
        _dispatch.load_library("stem_fused")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _dispatch.resolve_device("cuda")
    with pytest.raises(ValueError):
        _dispatch.resolve_device("mps")
    assert _dispatch.resolve_device("cpu").type == "cpu"


def test_kernel_sources_are_hashed_and_listed():
    names = [p.name for p in _dispatch.sources()]
    assert "stem_fused.cu" in names
    path = _dispatch.library_path("stem_fused")
    assert path.parent == _dispatch.BUILD_DIR and path.suffix == ".so"
    assert "sm_90a" in " ".join(_dispatch.NVCC_FLAGS)
