"""The port's Keras builder (sparkdl_torch/models/keras_graph.py) against
Keras' own forward, layer by layer, and the Keras reader
(models/keras_loader.py) it is fed by.

Every layer of the surface runs in at least one small model built here
with seeded weights (no download); Keras computes the reference on the
same numpy input. Tolerance: max |diff| <= 1e-5 * max |ref| (float32 on
both sides; only the convolutions' summation order differs).
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch_parity import assert_close

keras = pytest.importorskip("keras")
from keras import layers as L  # noqa: E402

from sparkdl_torch.models.keras_graph import LAYER_SURFACE, KerasGraphModule  # noqa: E402
from sparkdl_torch.models.keras_loader import KerasGraph, read_keras_model  # noqa: E402

TOL = 1e-5
REPO = Path(__file__).resolve().parent.parent


def _seeded(model, seed):
    """Seeded weights (BN variances positive) in place of Keras' init."""
    r = np.random.default_rng(seed)
    for lyr in model.layers:
        w = lyr.get_weights()
        if type(lyr).__name__ == "BatchNormalization":
            w = [(0.5 + r.random(a.shape)).astype(np.float32) if i == len(w) - 1
                 else (0.3 * r.standard_normal(a.shape)).astype(np.float32)
                 for i, a in enumerate(w)]
        else:
            w = [(0.3 * r.standard_normal(a.shape)).astype(np.float32) for a in w]
        lyr.set_weights(w)
    return model


def _functional():
    inp = keras.Input((9, 9, 3))
    a = L.Conv2D(4, 1, name="a")(inp)
    b = L.Conv2D(4, 3, padding="same", name="b")(inp)
    y = L.Add()([a, b])
    z = L.Concatenate(axis=-1)([y, a])
    return keras.Model(inp, L.GlobalAveragePooling2D()(z), name="branches")


#: (id, layers after Input((9, 9, 3))) — or a builder of a functional model
CASES = [
    ("conv_same_stride2_flatten_dense",
     lambda: [L.Conv2D(4, 3, strides=2, padding="same", activation="relu"),
              L.Flatten(), L.Dense(3)]),
    ("conv_valid_groups_bn_unscaled_sigmoid_softmax",
     lambda: [L.Conv2D(6, 3, groups=3, use_bias=False),
              L.BatchNormalization(center=False, scale=False, epsilon=1e-2),
              L.Activation("sigmoid"), L.Softmax()]),
    ("depthwise_same_bn_relu6",
     lambda: [L.DepthwiseConv2D(3, depth_multiplier=2, padding="same"),
              L.BatchNormalization(), L.ReLU(max_value=6.0)]),
    ("leaky_thresholded_relu",
     lambda: [L.ReLU(negative_slope=0.2, threshold=0.1)]),
    ("separable_stride2_maxpool_same_global_avg",
     lambda: [L.SeparableConv2D(5, 3, strides=2, padding="same"),
              L.MaxPooling2D(3, 2, padding="same"), L.GlobalAveragePooling2D()]),
    ("zero_pad_avgpool_same_stride2_global_max",
     lambda: [L.ZeroPadding2D(((1, 2), (0, 1))), L.AveragePooling2D(3, 2, padding="same"),
              L.GlobalMaxPooling2D(keepdims=True)]),
    ("avgpool_valid_reshape_dense_rank3_dropout_tanh",
     lambda: [L.AveragePooling2D(2), L.Reshape((4, 12)),
              L.Dense(5, activation="softmax"), L.Dropout(0.5), L.Activation("tanh")]),
    ("maxpool_valid_flatten_dense_linear",
     lambda: [L.MaxPooling2D(2), L.Flatten(), L.Dense(4, activation="linear")]),
    ("functional_add_concatenate", _functional),
]


@pytest.fixture(scope="module")
def x():
    return np.random.default_rng(0).standard_normal((2, 9, 9, 3)).astype(np.float32)


def _build(make, seed):
    made = make()
    if isinstance(made, list):
        made = keras.Sequential([keras.Input((9, 9, 3))] + made)
    return _seeded(made, seed)


@pytest.mark.parametrize("case", range(len(CASES)), ids=[c[0] for c in CASES])
def test_surface_matches_keras(case, x):
    model = _build(CASES[case][1], seed=case)
    want = np.asarray(model(x, training=False))
    graph = read_keras_model(model)
    module = KerasGraphModule(graph, device="cpu").eval()
    with torch.inference_mode():
        got = module(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    assert_close(got, want, TOL)
    # the weights go back in Keras' layouts and order, unchanged
    back = module.keras_weights()
    assert set(back) == set(graph.weights)
    for name, ws in graph.weights.items():
        for a, b in zip(ws, back[name], strict=True):
            np.testing.assert_array_equal(a, b)


def test_the_cases_cover_the_surface():
    seen = {"InputLayer"}
    for _, make in CASES:
        made = make()
        seen |= {type(lyr).__name__ for lyr in (made if isinstance(made, list)
                                                else made.layers)}
    assert LAYER_SURFACE <= seen


def test_flatten_after_conv_keeps_keras_order(x):
    """Flatten reads the conv output in Keras' NHWC order: the Dense after
    it sees channel-fastest features (an NCHW flatten scrambles them)."""
    model = _build(lambda: [L.Conv2D(2, 1, use_bias=False), L.Flatten()], seed=3)
    with torch.inference_mode():
        got = KerasGraphModule(read_keras_model(model), device="cpu")(
            torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(model(x)), rtol=1e-6, atol=1e-6)
    assert got.shape == (2, 9 * 9 * 2)


@pytest.mark.parametrize("layer,what", [
    (lambda: L.LayerNormalization(), "LayerNormalization"),
    (lambda: L.Conv2D(2, 3, dilation_rate=2), "dilation_rate"),
    (lambda: L.Conv2D(2, 1, kernel_regularizer="l2"), "kernel_regularizer"),
    (lambda: L.Activation("gelu"), "gelu"),
])
def test_outside_the_surface_raises_naming_a3(layer, what):
    model = keras.Sequential([keras.Input((5, 5, 3)), layer()])
    with pytest.raises(NotImplementedError, match=rf"(?s){what}.*ROADMAP A3"):
        KerasGraphModule(read_keras_model(model), device="cpu")


def test_shared_layer_raises_naming_a3():
    inp = keras.Input((4,))
    dense = L.Dense(4)
    model = keras.Model(inp, dense(dense(inp)))
    with pytest.raises(NotImplementedError, match="shared layer.*A3"):
        KerasGraphModule(read_keras_model(model), device="cpu")


def test_graph_from_a_saved_file(tmp_path, x):
    model = _build(CASES[0][1], seed=7)
    for suffix in (".keras", ".h5"):
        path = str(tmp_path / f"m{suffix}")
        model.save(path)
        graph = read_keras_model(path)
        assert graph.input_shape == (None, 9, 9, 3) and graph.sequential
        with torch.inference_mode():
            got = KerasGraphModule(graph, device="cpu")(torch.from_numpy(x)).numpy()
        assert_close(got, np.asarray(model(x)), TOL)
    with pytest.raises(FileNotFoundError):
        read_keras_model(str(tmp_path / "missing.keras"))


_KERAS_FREE = """
import sys
sys.modules["keras"] = None  # any `import keras` now raises ImportError
import numpy as np
import torch
import sparkdl_torch
from sparkdl_torch import (KerasImageFileEstimator, KerasImageFileTransformer,
                           KerasTransformer, registerKerasImageUDF)
from sparkdl_torch.models.keras_graph import KerasGraphModule
from sparkdl_torch.models.keras_loader import KerasGraph
from sparkdl_torch.udf import applyUDF, getUDF
graph = KerasGraph(config=CONFIG, weights=WEIGHTS)
module = KerasGraphModule(graph, device="cpu")
y = module(torch.ones(2, 4, 4, 3))
assert y.shape == (2, 2), y.shape
udf = registerKerasImageUDF("keras_free", graph, device="cpu")
assert getUDF("keras_free")(np.zeros((4, 4, 3), np.uint8)).shape == (2,)
try:
    import keras
except ImportError:
    print("KERAS-FREE OK")
"""


def test_keras_free_import_and_run():
    """With keras blocked, the package, its lazy Keras names, and a
    KerasGraph written as data (the card's path) import and run."""
    model = _seeded(keras.Sequential([keras.Input((4, 4, 3)), L.Flatten(),
                                      L.Dense(2, activation="softmax")]), 1)
    graph = read_keras_model(model)
    weights = {k: [a.tolist() for a in v] for k, v in graph.weights.items()}
    code = (_KERAS_FREE.replace("CONFIG", repr(graph.config))
            .replace("WEIGHTS", "{k: [np.asarray(a, np.float32) for a in v] "
                                f"for k, v in {weights!r}.items()}}"))
    env = dict(os.environ)
    env.pop("PYTHONSTARTUP", None)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "KERAS-FREE OK" in proc.stdout


def test_keras_graph_is_plain_data():
    graph = KerasGraph(config={"name": "m", "layers": [
        {"class_name": "InputLayer", "config": {"name": "in", "batch_shape": [None, 3]}},
        {"class_name": "Dense", "config": {"name": "d", "units": 2, "activation": "relu"}},
    ]}, weights={"d": [np.eye(3, 2, dtype=np.float32), np.zeros(2, np.float32)]})
    assert graph.sequential and graph.input_shape == (None, 3)
    with torch.inference_mode():
        y = KerasGraphModule(graph, device="cpu")(torch.tensor([[1.0, -2.0, 3.0]]))
    assert y.tolist() == [[1.0, 0.0]]
