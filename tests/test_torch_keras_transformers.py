"""The port's KerasTransformer, KerasImageFileTransformer and
registerKerasImageUDF against the JAX package's, on the same saved Keras
files, the same rows and the same image structs, error rows included.

Both packages read the same file; the reference runs it in Keras (jax
backend), the port as torch ops on the CPU. Tolerances are the reference
tests' own: tests/transformers/test_keras_tensor.py (rtol 1e-5, atol
1e-6), tests/transformers/test_keras_image.py and
tests/udf/test_keras_image_model.py (rtol 1e-4, atol 1e-5).
"""

import numpy as np
import pytest
from PIL import Image

keras = pytest.importorskip("keras")

from sparkdl_torch import (  # noqa: E402
    KerasImageFileTransformer,
    KerasTransformer,
    LocalDataFrame,
    registerKerasImageUDF,
)
from sparkdl_torch.udf import applyUDF, getUDF, listUDFs  # noqa: E402

SIZE = 8


@pytest.fixture(scope="module")
def mlp_file(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("models") / "mlp.h5")
    keras.Sequential([
        keras.layers.Input((10,)),
        keras.layers.Dense(32, activation="relu"),
        keras.layers.Dense(8, activation="relu"),
        keras.layers.Dense(3, activation="softmax"),
    ]).save(path)
    return path


@pytest.fixture(scope="module")
def cnn_file(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("keras") / "cnn.keras")
    keras.Sequential([
        keras.layers.Input((SIZE, SIZE, 3)),
        keras.layers.Conv2D(4, 3, activation="relu"),
        keras.layers.GlobalAveragePooling2D(),
        keras.layers.Dense(5, activation="softmax"),
    ]).save(path)
    return path


@pytest.fixture(scope="module")
def image_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("uris")
    rng = np.random.default_rng(9)
    paths = []
    for i in range(7):
        p = d / f"img{i}.png"
        Image.fromarray(rng.integers(0, 256, (SIZE * 2, SIZE * 2, 3),
                                     dtype=np.uint8)).save(p)
        paths.append(str(p))
    return paths


def _loader(uri: str) -> np.ndarray:
    img = Image.open(uri).convert("RGB").resize((SIZE, SIZE), Image.BILINEAR)
    return np.asarray(img, dtype=np.float32) / 255.0


def _both(cls_name, rows, partitions, **kw):
    """Rows out of the JAX transformer and the port's (device cpu), in
    order."""
    import sparkdl_tpu
    from sparkdl_tpu.dataframe import LocalDataFrame as JaxFrame

    import sparkdl_torch

    want = getattr(sparkdl_tpu, cls_name)(**kw).transform(
        JaxFrame.from_rows(rows, 1)).collect()
    got = getattr(sparkdl_torch, cls_name)(device="cpu", **kw).transform(
        LocalDataFrame.from_rows(rows, partitions)).collect()
    assert [r["id"] for r in got] == [r["id"] for r in rows]
    return got, want


def _assert_rows(got, want, col, rtol, atol):
    for g, w in zip(got, want, strict=True):
        if w[col] is None:
            assert g[col] is None
        else:
            assert g[col].dtype == np.float32
            np.testing.assert_allclose(g[col], w[col], rtol=rtol, atol=atol)


def test_keras_transformer_matches_jax(mlp_file):
    r = np.random.default_rng(0)
    rows = [{"id": i, "feat": x} for i, x in
            enumerate(r.standard_normal((23, 10)).astype(np.float32))]
    rows[5]["feat"] = np.zeros((2, 5), np.float32)  # not 1-D: None in both
    rows[9]["feat"] = list(map(float, rows[9]["feat"]))  # lists are accepted
    got, want = _both("KerasTransformer", rows, 3, inputCol="feat",
                      outputCol="pred", modelFile=mlp_file, batchSize=8)
    assert want[5]["pred"] is None and sum(w["pred"] is None for w in want) == 1
    _assert_rows(got, want, "pred", 1e-5, 1e-6)


def test_keras_transformer_params():
    t = KerasTransformer(inputCol="x", outputCol="y")
    assert t.getBatchSize() == 256 and t.getOrDefault("device") == "cuda"
    with pytest.raises(ValueError, match="does not exist"):
        KerasTransformer(inputCol="x", outputCol="y", modelFile="/nope/missing.h5")
    with pytest.raises(ValueError):
        KerasTransformer(inputCol="x", outputCol="y", device="tpu")


def test_keras_image_file_transformer_matches_jax(cnn_file, image_files):
    rows = [{"id": i, "uri": u} for i, u in enumerate(image_files)]
    rows.insert(3, {"id": -1, "uri": "/nope/missing.png"})  # unreadable: None
    got, want = _both("KerasImageFileTransformer", rows, 2, inputCol="uri",
                      outputCol="preds", modelFile=cnn_file, imageLoader=_loader,
                      batchSize=3)
    assert want[3]["preds"] is None
    _assert_rows(got, want, "preds", 1e-4, 1e-5)
    assert KerasImageFileTransformer(inputCol="u", outputCol="p").getBatchSize() == 32


def test_keras_image_file_transformer_loader_with_batch_dim(cnn_file, image_files):
    rows = [{"id": 0, "uri": image_files[0]}]
    got, want = _both("KerasImageFileTransformer", rows, 1, inputCol="uri",
                      outputCol="preds", modelFile=cnn_file,
                      imageLoader=lambda u: _loader(u)[None])
    _assert_rows(got, want, "preds", 1e-4, 1e-5)


@pytest.fixture(scope="module")
def udf_model():
    r = np.random.default_rng(5)
    model = keras.Sequential([keras.layers.Input((SIZE, SIZE, 3)),
                              keras.layers.Flatten(),
                              keras.layers.Dense(4, activation="softmax")])
    model.set_weights([(0.01 * r.standard_normal(w.shape)).astype(np.float32)
                       for w in model.get_weights()])
    return model


@pytest.fixture(scope="module")
def image_rows():
    from sparkdl_torch.image import imageArrayToStructBGR

    rng = np.random.default_rng(2)
    rows = [{"image": imageArrayToStructBGR(
        rng.integers(0, 256, (SIZE, SIZE, 3), dtype=np.uint8))} for _ in range(4)]
    rows.append({"image": imageArrayToStructBGR(  # another size: resized
        rng.integers(0, 256, (SIZE + 5, SIZE - 2, 3), dtype=np.uint8))})
    return rows


@pytest.mark.parametrize("scaled", [False, True])
def test_udf_matches_jax(udf_model, image_rows, scaled):
    from sparkdl_tpu import registerKerasImageUDF as jax_register
    from sparkdl_tpu.dataframe import LocalDataFrame as JaxFrame
    from sparkdl_tpu.udf.registry import applyUDF as jax_apply

    name = f"port_score{'_scaled' if scaled else ''}"
    ours = registerKerasImageUDF(name, udf_model, device="cpu",
                                 preprocessor=(lambda x: x / 255.0) if scaled else None)
    jax_register(name, udf_model, preprocessor=(lambda x: x / 255.0) if scaled else None)
    assert name in listUDFs() and getUDF(name) is ours
    got = applyUDF(name, LocalDataFrame.from_rows(image_rows, 2), "image",
                   "probs").collect()
    want = jax_apply(name, JaxFrame.from_rows(image_rows, 1), "image",
                     "probs").collect()
    assert len(got) == len(want) == len(image_rows)
    for g, w in zip(got, want):
        assert g["probs"].shape == (4,)
        np.testing.assert_allclose(g["probs"], w["probs"], rtol=1e-4, atol=1e-5)


def test_udf_from_file_and_graph(udf_model, image_rows, tmp_path):
    from sparkdl_torch.models.keras_loader import read_keras_model

    path = str(tmp_path / "m.keras")
    udf_model.save(path)
    want = registerKerasImageUDF("port_from_model", udf_model, device="cpu")(
        image_rows[0]["image"])
    for source in (path, read_keras_model(path)):
        got = registerKerasImageUDF("port_from_file", source, device="cpu")(
            image_rows[0]["image"])
        np.testing.assert_array_equal(got, want)
    with pytest.raises(KeyError, match="no UDF named"):
        getUDF("definitely_not_registered")
