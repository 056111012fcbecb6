"""The port's image zoo (ResNet50, Xception; VGG in test_torch_vgg.py, ViT
in test_torch_vit.py) against the JAX package's, on the same numpy
weights through the weight bridge (models/convert.py): each module's
features and probabilities, the named-image transformers over
LocalDataFrame rows, the TF-SAME max-pool and depthwise conv against
Flax's, the preprocess modes and the registry.

Tolerances, as max |diff| <= tol * max |ref|: 1e-5 for a module on one
batch (float32 on both sides, only summation order differs), 1e-4 through
the transformers (torch_parity.NET_TOL: host resize and batching on top),
1e-6 for a single pool or depthwise conv.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import (
    assert_close,
    named_image_parity,
    to_jax,
    zoo_jax_builder,
    zoo_torch_module,
    zoo_variables,
)

from sparkdl_torch import DeepImageFeaturizer, LocalDataFrame
from sparkdl_torch.models import common, convert
from sparkdl_torch.transformers import named_image as torch_ni

MODEL_TOL = 1e-5
OP_TOL = 1e-6
#: ViT-B/16's cases are in test_torch_vit.py and VGG's in test_torch_vgg.py
ZOO = ("ResNet50", "Xception")


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

# Xception at 71 px pools odd maps only (33, 17, 9, 5); at 89 px the first
# and last SAME pools see even ones (42 and 6).
@pytest.mark.parametrize("name,size,batch", [
    ("ResNet50", 64, 2),
    ("Xception", 71, 2),
    ("Xception", 89, 2),
])
def test_module_matches_flax(name, size, batch):
    variables = zoo_variables(zoo_jax_builder(name)(include_top=True), 3, size,
                               gamma=(1.0, 0.1))
    x = np.random.default_rng(5).standard_normal((batch, size, size, 3)).astype(np.float32)
    jf, jp = zoo_jax_builder(name)(include_top=True).apply(to_jax(variables), x)
    with torch.no_grad():
        f, p = zoo_torch_module(name, variables, True)(torch.from_numpy(x))
        f_headless, p_headless = zoo_torch_module(name, variables, False)(torch.from_numpy(x))
    assert_close(f.numpy(), jf, MODEL_TOL)
    assert_close(p.numpy(), jp, MODEL_TOL)
    assert p_headless is None
    assert_close(f_headless.numpy(), f.numpy(), OP_TOL)


@pytest.mark.parametrize("size", [7, 8, 9, 10])
@pytest.mark.parametrize("window,stride", [(3, 2), (2, 2), (3, 1)])
def test_same_max_pool_matches_flax(size, window, stride):
    """TF-SAME max-pooling pads with -inf, more on the bottom/right: on
    all-negative inputs a zero pad cell would win at the edges."""
    x = -np.abs(np.random.default_rng(size).standard_normal(
        (2, size, size + 1, 3))).astype(np.float32) - 0.5
    want = fnn.max_pool(jnp.asarray(x), (window, window), (stride, stride), "SAME")
    got = common.max_pool(torch.from_numpy(x).permute(0, 3, 1, 2), window, stride, "SAME")
    assert_close(got.permute(0, 2, 3, 1).numpy(), want, OP_TOL)


@pytest.mark.parametrize("size", [9, 10])
@pytest.mark.parametrize("stride", [1, 2])
def test_depthwise_conv_matches_flax(size, stride):
    """A separable conv's depthwise half (groups=C, TF-SAME) and its
    kernel through the bridge: (kh, kw, 1, C) -> (C, 1, kh, kw)."""
    r = np.random.default_rng(size + stride)
    x = r.standard_normal((2, size, size, 6)).astype(np.float32)
    k = r.standard_normal((3, 3, 1, 6)).astype(np.float32)
    conv = fnn.Conv(6, (3, 3), (stride, stride), "SAME", feature_group_count=6,
                    use_bias=False)
    want = conv.apply({"params": {"kernel": jnp.asarray(k)}}, jnp.asarray(x))
    sd = convert.flax_to_torch({"params": {"sepdw000": {"kernel": k}}})
    got = common.conv2d_tf(torch.from_numpy(x).permute(0, 3, 1, 2),
                           sd["sepdw000.weight"], None, stride, "SAME", groups=6)
    assert_close(got.permute(0, 2, 3, 1).numpy(), want, OP_TOL)


def test_bridge_round_trips_separable_convs():
    from sparkdl_tpu.models.xception import Xception

    variables = zoo_variables(Xception(include_top=True), 1, 71)
    back = convert.torch_to_flax(convert.flax_to_torch(variables))
    flat = jax.tree_util.tree_leaves_with_path
    assert [p for p, _ in flat(back)] == [p for p, _ in flat(variables)]
    for (_, a), (_, b) in zip(flat(back), flat(variables)):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# the named-image transformers, against the JAX ones
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,cls_name", [
    (n, c) for n in ZOO for c in ("DeepImageFeaturizer", "DeepImagePredictor")])
def test_named_image_transformer_matches_jax(monkeypatch, name, cls_name):
    named_image_parity(monkeypatch, name, cls_name)


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------

def test_registry_matches_the_jax_zoo():
    import importlib

    from sparkdl_torch.models import registry

    jreg = importlib.import_module("sparkdl_tpu.models.registry")
    assert registry.SUPPORTED_MODELS == jreg.SUPPORTED_MODELS
    for name in registry.SUPPORTED_MODELS:
        ours, theirs = registry.get_entry(name), jreg.get_entry(name)
        for field in ("input_size", "preprocess", "feature_dim", "num_classes",
                      "features_need_top", "source"):
            assert getattr(ours, field) == getattr(theirs, field), (name, field)


@pytest.mark.parametrize("name", ["Xception", "ResNet50", "VGG16"])
def test_registry_builds_random_models(name):
    """Random init from the seed, reproducible ('random' and None alike);
    the features have the entry's width (VGG's fc2 without the head)."""
    from sparkdl_torch.models.registry import build_torch_model, get_entry

    a = build_torch_model(name, "random", include_top=False, device="cpu", seed=1)
    assert not a.training and not a.include_top
    if name != "VGG16":  # 138M parameters: build it once
        b = build_torch_model(name, None, include_top=False, device="cpu", seed=1)
        for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
            assert ka == kb and torch.equal(va, vb)
    size = get_entry(name).input_size[0]
    with torch.no_grad():
        f, _ = a(torch.zeros(1, size, size, 3))
    assert f.shape == (1, get_entry(name).feature_dim) and torch.isfinite(f).all()


def test_featurizer_builds_zoo_models_by_name():
    """The real loader (registry, random weights) behind the featurizer."""
    from sparkdl_torch.image import imageArrayToStructBGR

    img = np.random.default_rng(0).integers(0, 256, (40, 48, 3), dtype=np.uint8)
    df = LocalDataFrame.from_rows([{"image": imageArrayToStructBGR(img)}])
    torch_ni._named_model_runner.cache_clear()
    torch_ni._load_named_model.cache_clear()
    try:
        for name in ("ResNet50", "Xception"):
            f = DeepImageFeaturizer(inputCol="image", outputCol="f", modelName=name,
                                    weights="random", batchSize=1,
                                    device="cpu").transform(df).first()["f"]
            assert f.shape == (2048,) and np.isfinite(f).all()
    finally:
        torch_ni._named_model_runner.cache_clear()
        torch_ni._load_named_model.cache_clear()


def test_preprocessors_make_host_constants_once(monkeypatch):
    """The preprocess modes run inside the runner's CUDA-graph capture,
    which refuses a host->device copy: after the first call on a (device,
    dtype), which the runner's eager warm-up makes, they build no tensor
    from host values, and give the same bits. Each mode gives what the
    JAX package's gives (within OP_TOL x max|ref|)."""
    from sparkdl_tpu.ops.preprocess import PREPROCESSORS as JAX_PREPROCESSORS

    from sparkdl_torch.ops.preprocess import PREPROCESSORS

    x = np.random.default_rng(0).uniform(0, 255, (2, 5, 4, 3)).astype(np.float32)
    first = {mode: fn(torch.from_numpy(x)) for mode, fn in PREPROCESSORS.items()}

    def refuse(*a, **k):
        raise AssertionError("a tensor made from host values")

    monkeypatch.setattr(torch, "tensor", refuse)
    monkeypatch.setattr(torch, "as_tensor", refuse)
    for mode, fn in PREPROCESSORS.items():
        got = fn(torch.from_numpy(x))
        assert torch.equal(got, first[mode]), mode
        assert_close(got.numpy(), np.asarray(JAX_PREPROCESSORS[mode](jnp.asarray(x))),
                     OP_TOL)
