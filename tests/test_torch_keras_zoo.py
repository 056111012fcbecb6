"""Keras weights for the port's zoo (sparkdl_torch/models/keras_loader.py,
models/registry.py) against Keras' own forward and the JAX package's
converter and zoo, on keras.applications models built with
``weights=None`` and seeded numpy weights (no download).

- The converter, three ways: Keras forward = the port's zoo module = the
  JAX zoo module, at tests/models/test_zoo_oracle.py's tolerance
  (rtol = atol = 2e-4; float32 everywhere, Keras and XLA sum in other
  orders than oneDNN). InceptionV3 (``layer_order="auto_suffix"``) at
  75 px and ResNet50 at 64 px run in tier 1; Xception and VGG16 are
  ``slow``, as their JAX counterparts are.
- The builder's ResNet50 (models/keras_graph.py) equals the zoo's under
  the same weights (1e-5 relative: both torch, other op orders).
- ``DeepImageFeaturizer(weights=<.keras file>)`` equals the JAX
  featurizer over the same file, row by row (1e-4 relative,
  torch_parity.NET_TOL), and ``weights="imagenet"`` without cached
  weights falls back to Keras' random init with a warning, as the JAX
  package does (the download is refused in the test, never attempted).
"""

import importlib
import logging

import numpy as np
import pytest
import torch
from torch_parity import NET_TOL, assert_close, zoo_rows

keras = pytest.importorskip("keras")

from sparkdl_torch.models.keras_graph import KerasGraphModule  # noqa: E402
from sparkdl_torch.models.keras_loader import (  # noqa: E402
    check_variables_match,
    load_keras_weights,
    read_keras_model,
)
from sparkdl_torch.models.registry import build_torch_model, get_entry  # noqa: E402

ZOO_TOL = 2e-4


def _seed_weights(model, seed):
    """Lecun-scaled kernels, BN statistics away from 0/1, for a deep net
    whose activations stay tame."""
    r = np.random.default_rng(seed)
    for lyr in model.layers:
        w = lyr.get_weights()
        if not w:
            continue
        if type(lyr).__name__ == "BatchNormalization":
            n = len(w)
            w = [(0.5 + r.random(a.shape)) if i == n - 1
                 else (1.0 + 0.1 * r.standard_normal(a.shape)) if i == 0 and lyr.scale
                 else 0.1 * r.standard_normal(a.shape) for i, a in enumerate(w)]
        else:
            w = [r.standard_normal(a.shape) / np.sqrt(np.prod(a.shape[:-1]))
                 if a.ndim > 1 else 0.1 * r.standard_normal(a.shape) for a in w]
        lyr.set_weights([np.asarray(a, np.float32) for a in w])
    return model


def _keras_app(name, **kw):
    mod, attr = get_entry(name).keras_builder_path.split(":")
    builder = getattr(importlib.import_module(f"keras.applications.{mod}"), attr)
    return _seed_weights(builder(weights=None, **kw), seed=len(name))


@pytest.fixture(scope="module")
def inception():
    return _keras_app("InceptionV3", include_top=False, pooling="avg")


@pytest.fixture(scope="module")
def resnet():
    return _keras_app("ResNet50", include_top=True, input_shape=(64, 64, 3))


def _images(size, n=2, seed=7):
    r = np.random.default_rng(seed)
    return (r.random((n, size, size, 3)) * 2.0 - 1.0).astype(np.float32)


def _three_way(name, kmodel, x, include_top, layer_order, features=None):
    """(keras output(s), port output(s), JAX output(s)): features, and
    probs with the top."""
    from sparkdl_tpu.models.keras_loader import keras_to_flax_variables
    from sparkdl_tpu.models.registry import get_entry as jax_entry

    kout = [np.asarray(kmodel(x, training=False))]
    if features is not None:
        kout.insert(0, np.asarray(features(x, training=False)))
    module = get_entry(name).builder(include_top=include_top, num_classes=1000)
    load_keras_weights(module, read_keras_model(kmodel), layer_order)
    with torch.inference_mode():
        ours = [t.numpy() for t in module.eval()(torch.from_numpy(x)) if t is not None]
    jmodule = jax_entry(name).flax_builder(include_top=include_top)
    theirs = [np.asarray(t) for t in jmodule.apply(
        keras_to_flax_variables(kmodel, layer_order=layer_order), x, train=False)
        if t is not None]
    return kout, ours, theirs


def _check(kout, ours, theirs):
    assert len(kout) == len(ours) == len(theirs)
    for k, o, t in zip(kout, ours, theirs):
        np.testing.assert_allclose(o, k, rtol=ZOO_TOL, atol=ZOO_TOL)
        np.testing.assert_allclose(o, t, rtol=ZOO_TOL, atol=ZOO_TOL)


def test_inception_v3_three_way(inception):
    _check(*_three_way("InceptionV3", inception, _images(75), False, "auto_suffix"))


def test_resnet50_three_way(resnet):
    features = keras.Model(resnet.inputs, resnet.get_layer("avg_pool").output)
    _check(*_three_way("ResNet50", resnet, _images(64), True, "topo", features))


@pytest.mark.slow
def test_xception_three_way():
    kmodel = _keras_app("Xception", include_top=False, pooling="avg",
                        input_shape=(71, 71, 3))
    _check(*_three_way("Xception", kmodel, _images(71), False, "topo"))


@pytest.mark.slow
def test_vgg16_three_way():
    kmodel = _keras_app("VGG16", include_top=True)
    fc2 = keras.Model(kmodel.inputs, kmodel.get_layer("fc2").output)
    _check(*_three_way("VGG16", kmodel, _images(224, n=1) * 0.1, True, "topo", fc2))


def test_builder_resnet50_equals_zoo(resnet):
    """The same Keras graph run by the layer builder and loaded into the
    zoo's hand-written ResNet50."""
    graph = read_keras_model(resnet)
    zoo = load_keras_weights(get_entry("ResNet50").builder(include_top=True),
                             graph, "topo").eval()
    x = torch.from_numpy(_images(64, seed=3))
    with torch.inference_mode():
        want_f, want_p = zoo(x)
        got_p = KerasGraphModule(graph, device="cpu")(x)
    assert_close(got_p.numpy(), want_p.numpy(), 1e-5)
    assert want_f.shape == (2, 2048)


def test_registry_loads_a_file_and_drops_the_head(resnet, tmp_path):
    path = str(tmp_path / "resnet.keras")
    resnet.save(path)
    x = _images(64, seed=5)
    top = build_torch_model("ResNet50", path, include_top=True, device="cpu")
    bare = build_torch_model("ResNet50", path, include_top=False, device="cpu")
    assert not hasattr(bare, "dense000")
    with torch.inference_mode():
        f_top, p_top = top(torch.from_numpy(x))
        f_bare, p_bare = bare(torch.from_numpy(x))
    np.testing.assert_array_equal(f_top.numpy(), f_bare.numpy())
    assert p_bare is None
    np.testing.assert_allclose(p_top.numpy(), np.asarray(resnet(x)), rtol=ZOO_TOL,
                               atol=ZOO_TOL)


def test_conversion_mismatch_is_loud(resnet):
    with pytest.raises(ValueError, match="conversion mismatch"):
        check_variables_match(
            {"params": {"conv000": {"kernel": np.zeros((3, 3, 3, 8))}}},
            {"params": {"conv000": {"kernel": np.zeros((3, 3, 3, 16))}}},
        )
    with pytest.raises(ValueError, match="conversion mismatch"):
        load_keras_weights(get_entry("InceptionV3").builder(include_top=False),
                           read_keras_model(resnet), "auto_suffix")


def test_featurizer_over_a_keras_file_matches_jax(inception, tmp_path):
    """DeepImageFeaturizer(weights=<.keras file>) in both packages, over
    the same saved InceptionV3 and rows at 299 px (one resized, one
    undefined); the port on the CPU, its stem the kernel's plain version."""
    from sparkdl_torch import DeepImageFeaturizer, LocalDataFrame
    from sparkdl_torch.transformers import named_image as torch_ni
    from sparkdl_tpu.dataframe import LocalDataFrame as JaxFrame
    from sparkdl_tpu.transformers import named_image as jax_ni

    path = str(tmp_path / "inception.keras")
    inception.save(path)
    rows = zoo_rows(299)
    kw = dict(inputCol="image", outputCol="out", modelName="InceptionV3",
              weights=path, batchSize=4)
    for ni in (jax_ni, torch_ni):
        ni._named_model_runner.cache_clear()
        ni._load_named_model.cache_clear()
    try:
        want = {r["id"]: r["out"] for r in jax_ni.DeepImageFeaturizer(**kw)
                .transform(JaxFrame.from_rows(rows, 1)).collect()}
        got = {r["id"]: r["out"] for r in DeepImageFeaturizer(device="cpu", **kw)
               .transform(LocalDataFrame.from_rows(rows, 2)).collect()}
    finally:
        for ni in (jax_ni, torch_ni):
            ni._named_model_runner.cache_clear()
            ni._load_named_model.cache_clear()
    assert got[-1] is None and want[-1] is None
    assert_close(np.stack([got[i] for i in (0, 1, 2)]),
                 np.stack([np.asarray(want[i]) for i in (0, 1, 2)]), NET_TOL)


def test_imagenet_default_falls_back_to_random_init(monkeypatch, caplog):
    """The featurizer's default weights='imagenet' where the weights are
    not cached: the download fails (here: refused before any connection)
    and Keras' random init serves, with a warning."""
    import keras.src.utils.file_utils as file_utils

    from sparkdl_torch import DeepImageFeaturizer, LocalDataFrame
    from sparkdl_torch.image import imageArrayToStructBGR
    from sparkdl_torch.transformers import named_image as torch_ni

    asked = []

    def refuse(fname=None, origin=None, **kw):
        asked.append(fname)
        raise Exception(f"URL fetch failure on {origin}: refused in the test")

    monkeypatch.setattr(file_utils, "get_file", refuse)
    torch_ni._named_model_runner.cache_clear()
    torch_ni._load_named_model.cache_clear()
    img = np.random.default_rng(0).integers(0, 256, (80, 80, 3), dtype=np.uint8)
    df = LocalDataFrame.from_rows([{"image": imageArrayToStructBGR(img)}])
    try:
        with caplog.at_level(logging.WARNING, logger="sparkdl_torch.models.registry"):
            out = DeepImageFeaturizer(inputCol="image", outputCol="f",
                                      modelName="InceptionV3", batchSize=1,
                                      device="cpu").transform(df).first()["f"]
    finally:
        torch_ni._named_model_runner.cache_clear()
        torch_ni._load_named_model.cache_clear()
    assert asked and "random init" in caplog.text
    assert out.shape == (2048,) and np.isfinite(out).all()


def test_chip_smoke_resnet50_graph_is_keras_own():
    """chip_smoke.py's [keras] phase writes ResNet50's graph in code (the
    card has no Keras): it is keras.applications' own, layer for layer
    (classes, names, order, connections, every config value it sets),
    and computes what Keras computes with the same weights."""
    import importlib.util
    import json
    from pathlib import Path

    from sparkdl_torch.models.keras_graph import _history

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    graph = chip_smoke.resnet50_keras_graph(seed=3, size=64)
    kmodel = keras.applications.ResNet50(  # the input named as in a fresh process
        weights=None, include_top=False, pooling="avg",
        input_tensor=keras.Input((64, 64, 3), name="input_layer"))
    kcfg = json.loads(json.dumps(kmodel.get_config()))
    assert [(e["class_name"], e["config"]["name"]) for e in graph.layers] == \
        [(e["class_name"], e["config"]["name"]) for e in kcfg["layers"]]
    for ours, theirs in zip(graph.layers, kcfg["layers"]):
        for key, value in ours["config"].items():
            assert theirs["config"][key] == value, (ours["config"]["name"], key)
        assert _history(ours["inbound_nodes"]) == _history(theirs["inbound_nodes"])
    def single(spec):  # Keras writes one input as [name, 0, 0] or [[name, 0, 0]]
        return spec[0] if not isinstance(spec[0], str) else spec

    for key in ("input_layers", "output_layers"):
        assert single(kcfg[key]) == single(graph.config[key])
    for lyr in kmodel.layers:
        assert (lyr.name in graph.weights) == bool(lyr.get_weights())
        if lyr.get_weights():
            lyr.set_weights(graph.weights[lyr.name])
    x = _images(64, seed=11) * 100.0
    with torch.inference_mode():
        got = KerasGraphModule(graph, device="cpu")(torch.from_numpy(x)).numpy()
    assert_close(got, np.asarray(kmodel(x, training=False)), 1e-5)
