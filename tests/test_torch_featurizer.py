"""The slice end to end: sparkdl_torch's DeepImageFeaturizer and
DeepImagePredictor against sparkdl_tpu's, over the same image structs at
the real 299x299 input (one row at another size, so the host resize runs
too, and one undefined row).

Both packages' model loaders are monkeypatched to serve the same numpy
weights (torch_parity.inception_variables, bridged to torch with
models/convert.py), so no new ``weights`` source is added. The port runs
with device="cpu", where its stem is the kernel's plain version.

Tolerance: max |diff| <= 1e-4 * max |ref| (torch_parity.NET_TOL).
"""

import json
import os

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

from sparkdl_torch import DeepImageFeaturizer, DeepImagePredictor, LocalDataFrame
from sparkdl_torch.transformers import named_image as torch_ni

torch.set_num_threads(2)
BATCH = 4
_REAL_LOADER = torch_ni._load_named_model


@pytest.fixture(scope="module")
def variables():
    return inception_variables(seed=11)


@pytest.fixture(scope="module")
def rows():
    from sparkdl_torch.image import imageArrayToStructBGR, undefined_image

    r = np.random.default_rng(12)
    shapes = [(299, 299), (260, 320), (299, 299)]
    out = [{"id": i, "image": imageArrayToStructBGR(
        r.integers(0, 256, (h, w, 3), dtype=np.uint8), origin=f"img{i}")}
        for i, (h, w) in enumerate(shapes)]
    out.insert(1, {"id": -1, "image": undefined_image("broken")})
    return out


@pytest.fixture(scope="module")
def jax_named_image(variables):
    """sparkdl_tpu's named_image with its loader serving ``variables``
    (module-scoped: its runners, and their compiles, are reused)."""
    from sparkdl_tpu.models.inception import InceptionV3
    from sparkdl_tpu.transformers import named_image

    def load(model_name, weights, include_top, weights_token=0.0):
        v = variables if include_top else without_top(variables)
        return InceptionV3(include_top=include_top), to_jax(v)

    named_image._named_model_runner.cache_clear()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(named_image, "_load_named_model", load)
        yield named_image
    named_image._named_model_runner.cache_clear()


@pytest.fixture(scope="module")
def torch_loader(variables):
    """sparkdl_torch's loader serving the same weights, on the CPU."""
    def load(model_name, weights, include_top, device):
        assert device == "cpu"
        return torch_inception(variables, include_top)

    torch_ni._named_model_runner.cache_clear()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch_ni, "_load_named_model", load)
        yield
    torch_ni._named_model_runner.cache_clear()


def _jax_features(jax_named_image, rows, cls_name, **kw):
    from sparkdl_tpu.dataframe import LocalDataFrame as JaxFrame

    t = getattr(jax_named_image, cls_name)(
        inputCol="image", outputCol="out", modelName="InceptionV3",
        weights="random", batchSize=BATCH, **kw)
    return {r["id"]: r["out"] for r in t.transform(JaxFrame.from_rows(rows, 1)).collect()}


def _torch_features(rows, cls, batch_size=BATCH, partitions=1, **kw):
    t = cls(inputCol="image", outputCol="out", modelName="InceptionV3",
            weights="random", batchSize=batch_size, device="cpu", **kw)
    out = t.transform(LocalDataFrame.from_rows(rows, partitions)).collect()
    assert [r["id"] for r in out] == [r["id"] for r in rows]
    return {r["id"]: r["out"] for r in out}


@pytest.fixture(scope="module")
def jax_featurized(jax_named_image, rows):
    return _jax_features(jax_named_image, rows, "DeepImageFeaturizer")


def _assert_rows_match(got, want):
    assert set(got) == set(want)
    assert got[-1] is None and want[-1] is None
    ids = sorted(i for i in want if i >= 0)
    for i in ids:
        assert got[i].dtype == np.float32 and got[i].shape == want[i].shape
    assert_close(np.stack([got[i] for i in ids]),
                 np.stack([np.asarray(want[i]) for i in ids]))


def test_featurizer_matches_jax(jax_featurized, rows, torch_loader):
    got = _torch_features(rows, DeepImageFeaturizer)
    assert all(got[i].shape == (2048,) for i in (0, 1, 2))
    _assert_rows_match(got, jax_featurized)


@pytest.mark.parametrize("batch_size,partitions", [(2, 1), (1, 2), (8, 3)])
def test_featurizer_ragged_tail_and_buckets(jax_featurized, rows, torch_loader,
                                            batch_size, partitions):
    """3 valid rows through batch sizes that leave a padded tail, across
    partitions: the same features as the JAX featurizer's."""
    got = _torch_features(rows, DeepImageFeaturizer, batch_size, partitions)
    _assert_rows_match(got, jax_featurized)


def test_predictor_matches_jax(jax_named_image, rows, torch_loader):
    want = _jax_features(jax_named_image, rows, "DeepImagePredictor")
    got = _torch_features(rows, DeepImagePredictor)
    _assert_rows_match(got, want)
    for i in (0, 1, 2):
        assert got[i].shape == (1000,)
        assert abs(float(got[i].sum()) - 1.0) < 1e-4
        assert int(np.argmax(got[i])) == int(np.argmax(want[i]))
    top = _torch_features(rows, DeepImagePredictor, decodePredictions=True,
                          topK=3)
    assert top[-1] is None
    assert [c for c, _, _ in top[0]] == list(np.argsort(got[0])[::-1][:3])
    assert top[0][0][1] == f"class_{top[0][0][0]}"


@pytest.fixture
def class_index_home(tmp_path, monkeypatch, jax_named_image):
    """A temporary HOME, with both packages' cached class index cleared
    before and after the test (the JAX package's code stays as it is)."""
    caches = (torch_ni._imagenet_class_index, jax_named_image._imagenet_class_index)
    monkeypatch.setenv("HOME", str(tmp_path))
    for cache in caches:
        cache.cache_clear()
    yield tmp_path
    for cache in caches:
        cache.cache_clear()


def test_predictor_reads_the_local_class_index_as_jax_does(
        class_index_home, jax_named_image, rows, torch_loader):
    """With ~/.keras/models/imagenet_class_index.json present, the port
    names classes as the JAX package does: by the index where it has the
    class, by ``class_{idx}`` where it has not (every 7th is left out)."""
    models = class_index_home / ".keras" / "models"
    models.mkdir(parents=True)
    index = {str(i): [f"n{i:08d}", f"label_{i}"] for i in range(1000) if i % 7}
    (models / "imagenet_class_index.json").write_text(json.dumps(index))
    for idx in (0, 1, 6, 7, 500, 999):
        assert torch_ni._class_description(idx) == jax_named_image._class_description(idx)
    assert torch_ni._class_description(1) == "label_1"
    assert torch_ni._class_description(7) == "class_7"

    want = _jax_features(jax_named_image, rows, "DeepImagePredictor",
                         decodePredictions=True, topK=20)
    got = _torch_features(rows, DeepImagePredictor, decodePredictions=True, topK=20)
    assert got[-1] is None and want[-1] is None
    for i in (0, 1, 2):
        assert got[i][0][:2] == want[i][0][:2]
        assert all(d == jax_named_image._class_description(c) for c, d, _ in got[i])
        assert any(d.startswith("label_") for _, d, _ in got[i])


def test_predictor_without_a_class_index_names_classes_by_index(
        class_index_home, jax_named_image, rows, torch_loader):
    """Without the file, both packages give ``class_{idx}``."""
    for idx in (0, 1, 999):
        assert torch_ni._class_description(idx) == f"class_{idx}"
        assert jax_named_image._class_description(idx) == f"class_{idx}"
    top = _torch_features(rows, DeepImagePredictor, decodePredictions=True, topK=3)
    assert all(d == f"class_{c}" for c, d, _ in top[0])


@pytest.mark.parametrize("settings", [
    dict(prefetch=0, chain_k=1, async_fetch=False),
    dict(chain_k=2), dict(prefetch=1, async_fetch=False), dict(autotune=True)])
def test_featurizer_through_every_feed_setting(jax_featurized, rows,
                                               torch_loader, monkeypatch,
                                               settings):
    """The featurizer's runner under other feed settings (the serial
    feed, a forced chain, no readahead, the autotuner): bitwise the
    default runner's features, and so within tolerance of the JAX
    featurizer's."""
    import dataclasses

    base = _torch_features(rows, DeepImageFeaturizer, 1, 1)
    orig = torch_ni._named_model_runner
    monkeypatch.setattr(torch_ni, "_named_model_runner",
                        lambda *key: dataclasses.replace(orig(*key), **settings))
    got = _torch_features(rows, DeepImageFeaturizer, 1, 1)
    assert got[-1] is None
    for i in (0, 1, 2):
        np.testing.assert_array_equal(got[i], base[i])
    _assert_rows_match(got, jax_featurized)
    if settings.get("autotune"):
        from sparkdl_torch.ingest import default_tuner

        default_tuner().stop()


def _write_pngs(root, r):
    from PIL import Image

    for i, (h, w) in enumerate([(299, 299), (64, 80)]):
        Image.fromarray(r.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(
            os.path.join(root, f"img{i}.png"))
    Image.fromarray(r.integers(0, 256, (50, 40), dtype=np.uint8)).save(
        os.path.join(root, "gray.png"))
    with open(os.path.join(root, "zz_corrupt.png"), "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\nnot really a png")


def test_read_images_with_custom_fn_matches_jax(tmp_path, jax_named_image,
                                                torch_loader):
    from sparkdl_torch.image import PIL_decode_bytes, readImagesWithCustomFn
    from sparkdl_torch.image.schema import UNDEFINED_MODE
    from sparkdl_tpu.image import PIL_decode_bytes as jax_decode
    from sparkdl_tpu.image import readImagesWithCustomFn as jax_read

    _write_pngs(str(tmp_path), np.random.default_rng(13))
    ours = readImagesWithCustomFn(str(tmp_path), PIL_decode_bytes, numPartition=2)
    theirs = jax_read(str(tmp_path), jax_decode, numPartition=2)
    assert ours.num_partitions == 2
    a, b = ours.collect(), theirs.collect()
    assert [dict(r["image"]) for r in a] == [dict(r["image"]) for r in b]
    assert [r["image"]["mode"] == UNDEFINED_MODE for r in a] == [
        False, False, False, True]

    feats = {r["filePath"]: r["features"] for r in DeepImageFeaturizer(
        inputCol="image", outputCol="features", modelName="InceptionV3",
        weights="random", batchSize=BATCH, device="cpu").transform(ours).collect()}
    want = {r["filePath"]: r["features"] for r in jax_named_image.DeepImageFeaturizer(
        inputCol="image", outputCol="features", modelName="InceptionV3",
        weights="random", batchSize=BATCH).transform(theirs).collect()}
    corrupt = str(tmp_path / "zz_corrupt.png")
    assert feats[corrupt] is None and want[corrupt] is None
    valid = sorted(p for p in want if p != corrupt)
    assert_close(np.stack([feats[p] for p in valid]),
                 np.stack([np.asarray(want[p]) for p in valid]))


def test_featurizer_defaults_and_device_param():
    t = DeepImageFeaturizer(inputCol="image", outputCol="f",
                            modelName="InceptionV3")
    assert t.getBatchSize() == 64
    assert t.getOrDefault("weights") == "imagenet"
    assert t.getOrDefault("device") == "cuda"
    with pytest.raises(ValueError):
        DeepImageFeaturizer(modelName="InceptionV3", device="tpu")
    assert DeepImageFeaturizer(modelName="ResNet50").getModelName() == "ResNet50"
    with pytest.raises(ValueError):
        DeepImageFeaturizer(modelName="NoSuchNet")
    assert t.copy({"batchSize": 8}).getBatchSize() == 8


def test_cuda_featurizer_raises_without_cuda(rows, monkeypatch):
    """The default device is CUDA; without it the transform raises rather
    than running on the CPU."""
    monkeypatch.setattr(torch_ni, "_load_named_model", _REAL_LOADER)
    t = DeepImageFeaturizer(inputCol="image", outputCol="f",
                            modelName="InceptionV3", weights="random")
    torch_ni._named_model_runner.cache_clear()
    with pytest.raises(RuntimeError, match="CUDA"):
        t.transform(LocalDataFrame.from_rows(rows, 1))
