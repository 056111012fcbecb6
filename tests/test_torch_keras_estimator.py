"""The port's KerasImageFileEstimator (torch training of the Keras graph)
against the JAX package's (Keras' own ``model.fit``), on the reference
test's fixture: 9 labelled 6x6 images, batch 4 (so the last batch is
partial), ``kerasFitParams={"epochs": 2, "shuffle": False}``.

Tolerances, max |diff| after two epochs:
- predictions of the tuned ``.keras`` files: rtol 1e-4, atol 1e-5. SGD
  and RMSprop are the same update in both; Adam adds its epsilon (1e-7)
  after the bias correction in Keras and before it in torch, which moves
  the predictions by ~2e-6 over 6 steps;
- a BatchNormalization model's moving statistics after fit: rtol 1e-5,
  atol 1e-6 (the batch moments of the same activations; both move them
  by the layer's momentum with the biased variance).
"""

import numpy as np
import pytest
import torch
from PIL import Image

keras = pytest.importorskip("keras")

from sparkdl_torch import KerasImageFileEstimator, LocalDataFrame  # noqa: E402
from sparkdl_torch.estimators.keras_image_file_estimator import (  # noqa: E402
    KERAS_LOSSES,
    fit_keras_graph,
    keras_loss,
)
from sparkdl_torch.transformers.keras_image import KerasImageFileTransformer  # noqa: E402

SIZE = 6
N_CLASSES = 3


@pytest.fixture(scope="module")
def base_model_file(tmp_path_factory):
    model = keras.Sequential([
        keras.layers.Input((SIZE, SIZE, 3)),
        keras.layers.Flatten(),
        keras.layers.Dense(N_CLASSES, activation="softmax"),
    ])
    path = str(tmp_path_factory.mktemp("est") / "base.keras")
    model.save(path)
    return path


@pytest.fixture(scope="module")
def bn_model_file(tmp_path_factory):
    model = keras.Sequential([
        keras.layers.Input((SIZE, SIZE, 3)),
        keras.layers.Conv2D(4, 3, padding="same"),
        keras.layers.BatchNormalization(momentum=0.9),
        keras.layers.ReLU(),
        keras.layers.GlobalAveragePooling2D(),
        keras.layers.Dense(N_CLASSES, activation="softmax"),
    ])
    path = str(tmp_path_factory.mktemp("est_bn") / "bn.keras")
    model.save(path)
    return path


@pytest.fixture(scope="module")
def rows(tmp_path_factory):
    d = tmp_path_factory.mktemp("est_uris")
    rng = np.random.default_rng(1)
    out = []
    for i in range(9):
        p = d / f"x{i}.png"
        Image.fromarray(rng.integers(0, 256, (SIZE, SIZE, 3), dtype=np.uint8)).save(p)
        onehot = np.zeros(N_CLASSES, np.float32)
        onehot[i % N_CLASSES] = 1.0
        out.append({"uri": str(p), "label": onehot})
    return out


def _loader(uri: str) -> np.ndarray:
    return np.asarray(Image.open(uri).convert("RGB"), dtype=np.float32) / 255.0


def _kw(model_file, optimizer, **fit):
    return dict(inputCol="uri", outputCol="preds", labelCol="label",
                modelFile=model_file, imageLoader=_loader,
                kerasLoss="categorical_crossentropy", kerasOptimizer=optimizer,
                kerasFitParams={"epochs": 2, "shuffle": False, "verbose": 0, **fit},
                batchSize=4)


def _fit_both(model_file, optimizer, rows):
    import sparkdl_tpu
    from sparkdl_tpu.dataframe.local import LocalDataFrame as JaxFrame

    theirs = sparkdl_tpu.KerasImageFileEstimator(**_kw(model_file, optimizer)).fit(
        JaxFrame.from_rows(rows, 2))
    ours = KerasImageFileEstimator(device="cpu", **_kw(model_file, optimizer)).fit(
        LocalDataFrame.from_rows(rows, 2))
    return ours, theirs


@pytest.mark.parametrize("optimizer", ["adam", "sgd", "rmsprop"])
def test_tuned_model_matches_jax(base_model_file, rows, optimizer):
    ours, theirs = _fit_both(base_model_file, optimizer, rows)
    assert isinstance(ours, KerasImageFileTransformer)
    assert ours.getOrDefault("device") == "cpu"
    x = np.stack([_loader(r["uri"]) for r in rows])
    load = keras.models.load_model
    want = np.asarray(load(theirs.getOrDefault("modelFile"))(x))
    got = np.asarray(load(ours.getOrDefault("modelFile"))(x))
    assert np.abs(got - np.asarray(load(base_model_file)(x))).max() > 1e-3  # trained
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    preds = np.stack([r["preds"] for r in ours.transform(
        LocalDataFrame.from_rows(rows, 2)).collect()])
    np.testing.assert_allclose(preds, got, rtol=1e-5, atol=1e-6)


def test_batchnorm_moving_statistics_match_keras(bn_model_file, rows):
    ours, theirs = _fit_both(bn_model_file, "sgd", rows)

    def bn_weights(t):
        model = keras.models.load_model(t.getOrDefault("modelFile"))
        lyr = next(lyr for lyr in model.layers
                   if type(lyr).__name__ == "BatchNormalization")
        return lyr.get_weights()

    base = bn_weights(KerasImageFileTransformer(modelFile=bn_model_file))
    for name, got, want, before in zip(("gamma", "beta", "moving_mean", "moving_var"),
                                       bn_weights(ours), bn_weights(theirs), base):
        assert np.abs(want - before).max() > 1e-4, name  # moved by the fit
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6, err_msg=name)


def test_fit_multiple_param_maps(base_model_file, rows):
    est = KerasImageFileEstimator(device="cpu", **_kw(base_model_file, "adam"))
    models = est.fit(LocalDataFrame.from_rows(rows, 2), [
        {"kerasFitParams": {"epochs": 1, "verbose": 0}},
        {"kerasFitParams": {"epochs": 3, "verbose": 0, "batch_size": 2}},
    ])
    files = [m.getOrDefault("modelFile") for m in models]
    assert len(files) == 2 and files[0] != files[1]


@pytest.mark.parametrize("bad,match", [
    (dict(kerasFitParams={"epochs": 1, "validation_split": 0.2}), "validation_split"),
    (dict(kerasOptimizer="adagrad"), "adagrad"),
    (dict(kerasLoss="hinge"), "hinge"),
])
def test_outside_the_map_raises_naming_a3(base_model_file, rows, bad, match):
    kw = {**_kw(base_model_file, "adam"), **bad}
    with pytest.raises(NotImplementedError, match=f"{match}.*ROADMAP A3"):
        KerasImageFileEstimator(device="cpu", **kw).fit(LocalDataFrame.from_rows(rows, 1))


def test_fit_without_labels_rejected(base_model_file, rows):
    est = KerasImageFileEstimator(inputCol="uri", outputCol="preds",
                                  modelFile=base_model_file, imageLoader=_loader,
                                  kerasLoss="categorical_crossentropy", device="cpu")
    with pytest.raises((ValueError, KeyError)):
        est.fit(LocalDataFrame.from_rows(rows, 1).select("uri"))


@pytest.mark.parametrize("name", sorted(KERAS_LOSSES))
def test_losses_match_keras(name):
    """Per-example losses against Keras' on probabilities that do not sum
    to 1 and touch 0 (the renormalization and the clipping)."""
    r = np.random.default_rng(4)
    y_pred = r.random((5, 4)).astype(np.float32)
    y_pred[0, 1] = 0.0
    if name == "sparse_categorical_crossentropy":
        y_true = r.integers(0, 4, (5,)).astype(np.float32)
    else:
        y_true = np.eye(4, dtype=np.float32)[r.integers(0, 4, 5)]
    want = np.asarray(keras.losses.get(name)(y_true, y_pred))
    got = keras_loss(name)(torch.from_numpy(y_pred), torch.from_numpy(y_true)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_shuffled_fit_is_seeded(base_model_file, rows):
    from sparkdl_torch.models.keras_graph import KerasGraphModule
    from sparkdl_torch.models.keras_loader import read_keras_model

    x = np.stack([_loader(r["uri"]) for r in rows])
    y = np.stack([r["label"] for r in rows])
    runs = []
    for _ in range(2):
        module = KerasGraphModule(read_keras_model(base_model_file), device="cpu")
        history = fit_keras_graph(module, x, y, epochs=2, batch_size=4, shuffle=True)
        runs.append((history["loss"], module.keras_weights()))
    assert len(runs[0][0]) == 2 and runs[0][0] == runs[1][0]
    for name, ws in runs[0][1].items():
        for a, b in zip(ws, runs[1][1][name]):
            np.testing.assert_array_equal(a, b)
