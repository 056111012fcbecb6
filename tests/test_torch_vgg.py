"""The port's VGG16 and VGG19 (sparkdl_torch/models/vgg.py) against the
JAX package's, on the same numpy weights through the weight bridge: each
module's fc2 features and probabilities at its fixed 224 px, and both
named-image transformers over LocalDataFrame rows against the JAX ones.

Tolerances, as max |diff| <= tol * max |ref|: 1e-5 for a module on one
image (float32 on both sides, only summation order differs), 1e-4 through
the transformers (torch_parity.NET_TOL: host resize and batching on top),
1e-6 between the headless and the full module's features.
"""

import numpy as np
import pytest
import torch
from torch_parity import (
    NET_TOL,
    assert_close,
    named_image_parity,
    to_jax,
    zoo_jax_builder,
    zoo_torch_module,
    zoo_variables,
)

torch.set_num_threads(2)
MODEL_TOL = 1e-5
OP_TOL = 1e-6


@pytest.mark.parametrize("name", ["VGG16", "VGG19"])
def test_module_matches_flax(name):
    """fc1's weights fix the input at 224 px: one image."""
    variables = zoo_variables(zoo_jax_builder(name)(include_top=True), 3, 224,
                              gamma=(1.0, 0.1))
    x = np.random.default_rng(5).standard_normal((1, 224, 224, 3)).astype(np.float32)
    jf, jp = zoo_jax_builder(name)(include_top=True).apply(to_jax(variables), x)
    with torch.no_grad():
        f, p = zoo_torch_module(name, variables, True)(torch.from_numpy(x))
        f_headless, p_headless = zoo_torch_module(name, variables, False)(
            torch.from_numpy(x))
    assert f.shape == (1, 4096)
    assert_close(f.numpy(), jf, MODEL_TOL)
    assert_close(p.numpy(), jp, MODEL_TOL)
    assert p_headless is None
    assert_close(f_headless.numpy(), f.numpy(), OP_TOL)


@pytest.mark.parametrize("name,cls_name", [
    (n, c) for n in ("VGG16", "VGG19")
    for c in ("DeepImageFeaturizer", "DeepImagePredictor")])
def test_named_image_transformer_matches_jax(monkeypatch, name, cls_name):
    named_image_parity(monkeypatch, name, cls_name, NET_TOL)
