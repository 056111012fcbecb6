"""KerasImageFileTransformer — Keras inference over a column of image URIs.

The port of ``sparkdl_tpu.transformers.keras_image``: a user-supplied
``imageLoader(uri) -> np.ndarray`` runs per row (load + preprocess to the
model's input shape), then the Keras model, run as torch ops
(``models/keras_graph``) on ``device``, scores the loaded batch through
the shared bucketed runner. A row whose loader raises gets None.
"""

from __future__ import annotations

import os

import numpy as np

from sparkdl_torch.dataframe import transform_partitions
from sparkdl_torch.param import (
    HasBatchSize,
    HasInputCol,
    HasOutputCol,
    Param,
    SparkDLTypeConverters,
    Transformer,
)
from sparkdl_torch.transformers._inference import run_partition_with_passthrough
from sparkdl_torch.transformers.keras_tensor import _keras_runner


class CanLoadImage:
    """Mixin: the ``imageLoader`` param shared by the image-file APIs."""

    imageLoader = Param(
        None, "imageLoader",
        "callable uri -> np.ndarray loading and preprocessing one image",
    )

    def getImageLoader(self):
        return self.getOrDefault("imageLoader")

    def loadImage(self, uri: str) -> np.ndarray:
        loader = self.getImageLoader()
        if loader is None:
            raise ValueError("imageLoader is not set")
        return np.asarray(loader(uri))


class KerasImageFileTransformer(
    Transformer, CanLoadImage, HasInputCol, HasOutputCol, HasBatchSize
):
    modelFile = Param(
        None, "modelFile", "path to the Keras model (.h5 or .keras)",
        SparkDLTypeConverters.toExistingFilePath,
    )
    device = Param(None, "device", "'cuda' (default) or 'cpu'",
                   SparkDLTypeConverters.toDevice)

    def __init__(self, inputCol=None, outputCol=None, modelFile=None,
                 imageLoader=None, batchSize=None, device=None):
        super().__init__()
        self._setDefault(batchSize=32, device="cuda")
        self._set(inputCol=inputCol, outputCol=outputCol, modelFile=modelFile,
                  imageLoader=imageLoader, batchSize=batchSize, device=device)

    def setModelFile(self, value: str):
        return self._set(modelFile=value)

    def getModelFile(self) -> str:
        return self.getOrDefault("modelFile")

    def _transform(self, dataset):
        model_file = self.getModelFile()
        mtime = os.path.getmtime(model_file)
        batch_size = self.getBatchSize()
        device = self.getOrDefault("device")
        input_col = self.getInputCol()
        output_col = self.getOutputCol()
        loader = self.getImageLoader()
        if loader is None:
            raise ValueError("imageLoader is not set")

        def partition_fn(rows):
            rows = list(rows)
            if not rows:
                return iter(())
            runner = _keras_runner(model_file, mtime, batch_size, device)

            def extract(row):
                arr = np.asarray(loader(row[input_col]), dtype=np.float32)
                # loaders may emit a leading batch dim of 1; strip it
                if arr.ndim == 4 and arr.shape[0] == 1:
                    arr = arr[0]
                return {"x": arr}

            return run_partition_with_passthrough(
                rows, extract, runner, output_col,
                lambda o: np.asarray(o, dtype=np.float32).reshape(-1),
                input_cols=(input_col,),
            )

        return transform_partitions(
            dataset, partition_fn, [(output_col, "array<float>")]
        )
