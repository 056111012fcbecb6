"""The port's InceptionV3 (sparkdl_torch/models/) against the JAX
package's Flax module and branch-merged forward, on the same weights.

Weights have the exact tree of the Flax module's init, with values from a
numpy seed (torch_parity.inception_variables), carried over with the
weight bridge (models/convert.py). Inputs are numpy arrays from a seed,
at 75x75, batch 2.

Tolerance through the network: max |diff| <= 1e-4 * max |ref|
(torch_parity.NET_TOL: float32 on both sides, only summation order and
the BN folds differ, ~1e-6 relative).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import (
    assert_close,
    inception_variables,
    to_jax,
    torch_inception,
    without_top,
)

from sparkdl_torch.models import convert
from sparkdl_torch.models.common import conv2d_tf
from sparkdl_torch.models.inception import InceptionV3 as TorchInceptionV3
from sparkdl_torch.models.inception_fused import (
    fused_inception_v3_features,
    prepare_fused_inception_v3,
)
from sparkdl_torch.ops.fold import fold_tf_preprocess as torch_fold_tf
from sparkdl_torch.ops.preprocess import preprocess_tf

torch.set_num_threads(2)
SIZE = 75


@pytest.fixture(scope="module")
def variables():
    return inception_variables(size=SIZE)


@pytest.fixture(scope="module")
def pixels():
    return np.random.default_rng(8).integers(
        0, 256, (2, SIZE, SIZE, 3)).astype(np.float32)


def test_bridge_round_trips_every_namer_key(variables):
    module = TorchInceptionV3(include_top=True)
    sd = convert.flax_to_torch(variables, module=module)
    assert set(sd) == set(module.state_dict())
    assert sum(k.endswith(".running_var") for k in sd) == 94
    back = convert.torch_to_flax(sd)
    for coll in ("params", "batch_stats"):
        assert set(back[coll]) == set(variables[coll])
        for name, fields in variables[coll].items():
            assert set(back[coll][name]) == set(fields)
            for field, a in fields.items():
                np.testing.assert_array_equal(back[coll][name][field], a)
    # layouts: conv HWIO -> OIHW, dense [in, out] -> [out, in]
    k = variables["params"]["conv005"]["kernel"]
    np.testing.assert_array_equal(sd["conv005.weight"].numpy(),
                                  k.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sd["dense000.weight"].numpy(),
                                  variables["params"]["dense000"]["kernel"].T)
    assert torch.all(sd["bn010.weight"] == 1)


def _with(variables, coll, name, **fields):
    out = {c: {k: dict(v) for k, v in variables[c].items()} for c in variables}
    out[coll][name].update(fields)
    return out


def test_bridge_refuses_leftovers_and_gaps(variables):
    with pytest.raises(ValueError, match="unconsumed"):
        convert.flax_to_torch(_with(variables, "params", "conv003",
                                    extra=np.zeros(1, np.float32)))
    with pytest.raises(ValueError, match="unknown layer"):
        convert.flax_to_torch({"params": {"head": {"kernel": np.zeros((2, 2))}}})
    gap = _with(variables, "batch_stats", "bn004")
    del gap["batch_stats"]["bn004"]["var"]
    with pytest.raises(ValueError, match="bn004"):
        convert.flax_to_torch(gap)
    with pytest.raises(ValueError, match="missing"):
        convert.flax_to_torch(without_top(variables),
                              module=TorchInceptionV3(include_top=True))
    with pytest.raises(ValueError, match="unexpected"):
        convert.flax_to_torch(variables, module=TorchInceptionV3(include_top=False))


@pytest.mark.parametrize("size,kernel,stride", [
    (8, 3, 2), (9, 3, 2), (8, 4, 2), (7, 1, 2), (8, 3, 1), (9, 7, 1)])
def test_tf_same_padding_matches_flax(size, kernel, stride):
    """TF "SAME" is asymmetric at stride 2 on even sizes; the helper pads
    after, as Flax/XLA do."""
    import flax.linen as nn

    r = np.random.default_rng(size * 10 + kernel)
    x = r.standard_normal((1, size, size, 5)).astype(np.float32)
    conv = nn.Conv(6, (kernel, kernel), strides=(stride, stride),
                   padding="SAME", use_bias=False)
    v = conv.init(jax.random.PRNGKey(1), jnp.asarray(x))
    want = conv.apply(v, jnp.asarray(x))
    w = torch.from_numpy(np.array(v["params"]["kernel"]).transpose(3, 2, 0, 1))
    got = conv2d_tf(torch.from_numpy(x).permute(0, 3, 1, 2), w, None, stride,
                    "SAME").permute(0, 2, 3, 1)
    assert_close(got.numpy(), want, tol=1e-5)


@pytest.mark.parametrize("include_top", [False, True])
def test_module_matches_flax(variables, pixels, include_top):
    from sparkdl_tpu.models.inception import InceptionV3

    x = pixels / 127.5 - 1.0  # 'tf' preprocessed
    jvars = variables if include_top else without_top(variables)
    want_f, want_p = InceptionV3(include_top=include_top).apply(
        to_jax(jvars), jnp.asarray(x), train=False)
    with torch.inference_mode():
        got_f, got_p = torch_inception(variables, include_top)(torch.from_numpy(x))
    assert_close(got_f.numpy(), want_f)
    if include_top:
        assert_close(got_p.numpy(), want_p)
        np.testing.assert_array_equal(got_p.numpy().argmax(-1),
                                      np.asarray(want_p).argmax(-1))
    else:
        assert got_p is None and want_p is None


def test_fold_tf_preprocess_matches_jax(variables):
    from sparkdl_tpu.ops.fold import fold_tf_preprocess as jax_fold_tf

    want = jax.device_get(jax_fold_tf(to_jax(without_top(variables))))
    got = torch_fold_tf(convert.flax_to_torch(without_top(variables)))
    np.testing.assert_allclose(
        got["conv000.weight"].numpy(),
        want["params"]["conv000"]["kernel"].transpose(3, 2, 0, 1), rtol=1e-6)
    np.testing.assert_allclose(got["bn000.running_mean"].numpy(),
                               want["batch_stats"]["bn000"]["mean"],
                               rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="bias"):
        torch_fold_tf(dict(got, **{"conv000.bias": torch.zeros(32)}))
    with pytest.raises(ValueError, match="running mean"):
        torch_fold_tf({"conv000.weight": got["conv000.weight"]})


def test_fused_features_match_jax_fused(variables, pixels):
    """Raw pixels through the folded, branch-merged forwards of both
    packages; the port's stem goes through inception_stem_fused (its plain
    version on CPU tensors)."""
    from sparkdl_tpu.models.inception_fused import (
        fused_inception_v3_features as jax_fused,
    )
    from sparkdl_tpu.ops.fold import fold_tf_preprocess as jax_fold_tf

    jvars = jax_fold_tf(to_jax(without_top(variables)))
    want = jax_fused(jvars, jnp.asarray(pixels), dtype=jnp.float32)
    params = prepare_fused_inception_v3(
        torch_fold_tf(convert.flax_to_torch(without_top(variables))))
    with torch.inference_mode():
        got = fused_inception_v3_features(params, torch.from_numpy(pixels))
    assert got.dtype == torch.float32 and got.shape == (2, 2048)
    assert_close(got.numpy(), want)


def test_fused_matches_module_on_preprocessed_input(variables, pixels):
    model = torch_inception(variables, include_top=False)
    params = prepare_fused_inception_v3(torch_fold_tf(model.state_dict()))
    x = torch.from_numpy(pixels)
    with torch.inference_mode():
        want, _ = model(preprocess_tf(x))
        got = fused_inception_v3_features(params, x)
    assert_close(got.numpy(), want.numpy())


def test_random_init_follows_flax_defaults():
    """build_torch_model's random init: Flax's lecun-normal kernels (same
    spread as the JAX module's init), zero biases, BN mean 0 / var 1;
    reproducible from the seed."""
    from sparkdl_torch.models.registry import build_torch_model

    a = build_torch_model("InceptionV3", "random", include_top=True,
                          device="cpu", seed=3)
    b = build_torch_model("InceptionV3", "random", include_top=True,
                          device="cpu", seed=3)
    c = build_torch_model("InceptionV3", None, include_top=True,
                          device="cpu", seed=4)
    for k in ("conv000.weight", "conv050.weight", "dense000.weight"):
        assert torch.equal(a.state_dict()[k], b.state_dict()[k])
        assert not torch.equal(a.state_dict()[k], c.state_dict()[k])
    w = a.conv050.weight
    fan_in = w[0].numel()
    assert abs(w.std().item() * np.sqrt(fan_in) - 1.0) < 0.05
    assert w.abs().max().item() <= 2 / np.sqrt(fan_in) / 0.8796 + 1e-6
    assert torch.all(a.bn050.running_mean == 0) and torch.all(a.bn050.running_var == 1)
    assert torch.all(a.bn050.bias == 0) and torch.all(a.dense000.bias == 0)
    assert not a.training


@pytest.mark.parametrize("name,weights,exc", [
    ("ResNet50", "/some/file.h5", NotImplementedError),
    ("ViTB16", "imagenet", ValueError),
    ("NoSuchNet", None, ValueError),
    ("InceptionV3", "imagenet", NotImplementedError),
    ("InceptionV3", "/some/file.h5", NotImplementedError),
])
def test_registry_refuses_what_is_not_ported(name, weights, exc):
    from sparkdl_torch.models.registry import build_torch_model

    with pytest.raises(exc):
        build_torch_model(name, weights, device="cpu")
