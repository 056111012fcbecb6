"""DeepImagePredictor / DeepImageFeaturizer — named-model transformers.

Apply a named ImageNet model to an image column: the Predictor emits
class probabilities (optionally top-K decoded), the Featurizer emits
penultimate-layer features for transfer learning (fc2 for VGG, the
final-LayerNorm CLS token for ViT-B/16). The model is any of the
registry's (``models/registry.py``), a torch module on ``device``
(``cuda`` unless the caller passes ``device="cpu"``), fed by the shared
bucketed runner. Models whose features need the classifier head (VGG)
are built with it (``build_torch_model``).

InceptionV3 featurization runs the branch-merged forward
(models/inception_fused.py) with the 'tf' preprocess folded into the stem
weights, so its stem is the hand-written CUDA kernel eating raw pixels.
"""

from __future__ import annotations

import functools
from typing import Any

import numpy as np
import torch

from sparkdl_torch.dataframe import transform_partitions
from sparkdl_torch.image.imageIO import imageStructToArray
from sparkdl_torch.image.schema import UNDEFINED_MODE, is_image_struct
from sparkdl_torch.models.registry import get_entry
from sparkdl_torch.ops.preprocess import PREPROCESSORS
from sparkdl_torch.param import (
    HasBatchSize,
    HasInputCol,
    HasOutputCol,
    Param,
    SparkDLTypeConverters,
    Transformer,
)
from sparkdl_torch.transformers._inference import (
    BatchedRunner,
    run_partition_with_passthrough,
)


@functools.lru_cache(maxsize=8)
def _load_named_model(model_name: str, weights: "str | None", include_top: bool,
                      device: str):
    """Per-process cache so executors build each model once per device."""
    from sparkdl_torch.models.registry import build_torch_model

    return build_torch_model(model_name, weights=weights,
                             include_top=include_top, device=device)


@functools.lru_cache(maxsize=16)
def _named_model_runner(model_name: str, weights: "str | None",
                        include_top: bool, head: str, batch_size: int,
                        device: str) -> BatchedRunner:
    """Per-process runner cache: one runner (and one set of prepared
    weights) per (model, head, batch size, device)."""
    # a model whose features need its head (VGG) is one model for both
    include_top = include_top or get_entry(model_name).features_need_top
    module = _load_named_model(model_name, weights, include_top, device)

    if model_name == "InceptionV3" and head == "features":
        # Featurization fast path: 'tf' preprocess folded into the stem,
        # the stem as one CUDA kernel on raw pixels, branch heads merged.
        from sparkdl_torch.models.inception_fused import (
            fused_inception_v3_features,
            prepare_fused_inception_v3,
        )
        from sparkdl_torch.ops.fold import fold_tf_preprocess

        params = prepare_fused_inception_v3(
            fold_tf_preprocess(module.state_dict()))
        preprocess = PREPROCESSORS["identity"]

        def apply_fn(batch):
            return fused_inception_v3_features(
                params, preprocess(batch["img"]), dtype=torch.float32)
    else:
        preprocess = PREPROCESSORS[get_entry(model_name).preprocess]

        def apply_fn(batch):
            features, probs = module(preprocess(batch["img"]))
            return features if head == "features" else probs

    return BatchedRunner(apply_fn, batch_size=batch_size, device=device)


def _resize_host(arr: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """Per-row host resize (PIL bilinear) for ragged image sizes — rows
    already at the model's size skip it."""
    from PIL import Image

    h, w = size
    if arr.shape[-1] == 1:  # grayscale -> 3-channel, whatever the size
        arr = np.repeat(arr, 3, axis=-1)
    if arr.shape[:2] == (h, w):
        return arr.astype(np.float32)
    if arr.dtype != np.uint8:
        arr = np.clip(arr, 0, 255).astype(np.uint8)
    img = Image.fromarray(arr).resize((w, h), Image.BILINEAR)
    return np.asarray(img, dtype=np.float32)


def _image_to_rgb_array(value: Any) -> np.ndarray:
    """Accept an image struct (BGR, Spark convention) or ndarray (RGB)."""
    if is_image_struct(value):
        if value["mode"] == UNDEFINED_MODE:
            raise ValueError("undefined image")
        arr = imageStructToArray(value)
        if arr.shape[-1] >= 3:  # stored BGR -> RGB
            arr = arr[..., 2::-1] if arr.shape[-1] == 3 else np.concatenate(
                [arr[..., 2::-1], arr[..., 3:]], axis=-1
            )
        return np.asarray(arr[..., :3])
    arr = np.asarray(value)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    return arr[..., :3]


def _model_name(value: Any) -> str:
    name = SparkDLTypeConverters.toString(value)
    get_entry(name)  # raises for unknown models
    return name


class _NamedImageTransformer(Transformer, HasInputCol, HasOutputCol, HasBatchSize):
    """Shared engine for the named-model transformers."""

    modelName = Param(None, "modelName", "name of the pretrained model",
                      _model_name)
    weights = Param(
        None, "weights",
        "'imagenet', a Keras .h5/.keras file, or 'random' for random init "
        "(HF-sourced ViTB16 takes only 'random'; None in the constructor "
        "means unset -> default)",
    )
    device = Param(None, "device", "'cuda' (default) or 'cpu'",
                   SparkDLTypeConverters.toDevice)

    _include_top: bool = True

    def __init__(self, inputCol=None, outputCol=None, modelName=None,
                 batchSize=None, weights=None, device=None):
        super().__init__()
        self._setDefault(batchSize=64, weights="imagenet", device="cuda")
        self._set(inputCol=inputCol, outputCol=outputCol, modelName=modelName,
                  batchSize=batchSize, weights=weights, device=device)

    def setModelName(self, value: str):
        return self._set(modelName=value)

    def getModelName(self) -> str:
        return self.getOrDefault("modelName")

    #: which head of (features, probs) the subclass emits
    _head: str = "probs"

    def _postprocess(self, out: np.ndarray):
        return out

    def _output_schema(self) -> list[tuple[str, str]]:
        return [(self.getOutputCol(), "array<float>")]

    def _transform(self, dataset):
        model_name = self.getModelName()
        weights = self.getOrDefault("weights")
        batch_size = self.getBatchSize()
        device = self.getOrDefault("device")
        input_col = self.getInputCol()
        output_col = self.getOutputCol()
        include_top = self._include_top
        head = self._head
        postprocess = self._postprocess

        size = get_entry(model_name).input_size

        def partition_fn(rows):
            rows = list(rows)
            if not rows:
                return iter(())
            runner = _named_model_runner(
                model_name, weights, include_top, head, batch_size, device)

            def extract(row):
                arr = _image_to_rgb_array(row[input_col])
                return {"img": _resize_host(arr, size)}

            return run_partition_with_passthrough(
                rows, extract, runner, output_col, postprocess,
                input_cols=(input_col,),
            )

        return transform_partitions(dataset, partition_fn, self._output_schema())


class DeepImageFeaturizer(_NamedImageTransformer):
    """Transfer-learning featurizer: penultimate-layer activations."""

    _include_top = False
    _head = "features"

    def _postprocess(self, out):
        return np.asarray(out, dtype=np.float32)


class DeepImagePredictor(_NamedImageTransformer):
    """Class-probability predictor with optional top-K decoding."""

    decodePredictions = Param(
        None, "decodePredictions",
        "emit top-K (class, description, probability) instead of raw probabilities",
        SparkDLTypeConverters.toBoolean,
    )
    topK = Param(None, "topK", "K for decodePredictions",
                 SparkDLTypeConverters.toInt)

    _include_top = True

    def __init__(self, inputCol=None, outputCol=None, modelName=None,
                 batchSize=None, weights=None, decodePredictions=None,
                 topK=None, device=None):
        super().__init__(inputCol, outputCol, modelName, batchSize, weights,
                         device)
        self._setDefault(decodePredictions=False, topK=5)
        self._set(decodePredictions=decodePredictions, topK=topK)

    def _postprocess(self, out):
        probs = np.asarray(out, dtype=np.float32)
        if not self.getOrDefault("decodePredictions"):
            return probs
        k = self.getOrDefault("topK")
        top = np.argsort(probs)[::-1][:k]
        return [(int(i), _class_description(int(i)), float(probs[i])) for i in top]

    def _output_schema(self):
        if self.getOrDefault("decodePredictions"):
            return [(self.getOutputCol(),
                     "array<struct<class:int,description:string,probability:float>>")]
        return [(self.getOutputCol(), "array<float>")]


@functools.lru_cache(maxsize=1)
def _imagenet_class_index() -> "dict[int, tuple[str, str]] | None":
    """ImageNet class index if cached locally (zero-egress: no download)."""
    import json
    import os

    path = os.path.join(
        os.path.expanduser("~"), ".keras", "models", "imagenet_class_index.json"
    )
    if not os.path.exists(path):
        return None
    with open(path) as f:
        raw = json.load(f)
    return {int(k): (v[0], v[1]) for k, v in raw.items()}


def _class_description(idx: int) -> str:
    """The class's ImageNet name where the local class index has it, else
    ``class_{idx}``."""
    index = _imagenet_class_index()
    if index and idx in index:
        return index[idx][1]
    return f"class_{idx}"
