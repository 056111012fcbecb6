"""KerasTransformer — batch inference with a user Keras model over a
column of 1-D numeric arrays.

The port of ``sparkdl_tpu.transformers.keras_tensor``. The reference runs
the Keras model itself (Keras 3 on its jax backend, ``stateless_call``);
the port reads the model file once into a ``KerasGraph``
(``models/keras_loader.read_keras_model``, the only place Keras is
imported) and runs it as torch ops (``models/keras_graph``) through the
shared bucketed runner, on ``device`` (``cuda`` unless the caller passes
``device="cpu"``). A layer outside the port's surface raises, naming
ROADMAP A3. The reference's ``_EagerRunner`` exists only for non-jax Keras
backends; the port always runs torch, so it has no counterpart.
"""

from __future__ import annotations

import functools
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
from sparkdl_torch.transformers._inference import (
    BatchedRunner,
    run_partition_with_passthrough,
)


@functools.lru_cache(maxsize=16)
def _keras_runner(model_file: str, mtime: float, batch_size: int,
                  device: str) -> BatchedRunner:
    """Per-process runner cache: the model file is read and built once per
    (file, mtime, batch size, device), its CUDA graphs shared across
    partitions."""
    from sparkdl_torch.models.keras_graph import KerasGraphModule
    from sparkdl_torch.models.keras_loader import read_keras_model

    graph = read_keras_model(model_file)

    def make_apply(dev):
        module = KerasGraphModule(graph, device=dev).eval()
        return lambda batch: module(batch["x"])

    # with the default "cuda": a batch spread over the cards, a copy of
    # the module on each
    return BatchedRunner(make_apply(device), batch_size=batch_size,
                         device=device, replicate=make_apply)


class KerasTransformer(Transformer, HasInputCol, HasOutputCol, HasBatchSize):
    modelFile = Param(
        None, "modelFile", "path to the Keras model (.h5 or .keras)",
        SparkDLTypeConverters.toExistingFilePath,
    )
    device = Param(None, "device", "'cuda' (default) or 'cpu'",
                   SparkDLTypeConverters.toDevice)

    def __init__(self, inputCol=None, outputCol=None, modelFile=None,
                 batchSize=None, device=None):
        super().__init__()
        self._setDefault(batchSize=256, device="cuda")
        self._set(inputCol=inputCol, outputCol=outputCol, modelFile=modelFile,
                  batchSize=batchSize, device=device)

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

        def partition_fn(rows):
            rows = list(rows)
            if not rows:
                return iter(())
            runner = _keras_runner(model_file, mtime, batch_size, device)

            def extract(row):
                arr = np.asarray(row[input_col], dtype=np.float32)
                if arr.ndim != 1:
                    raise ValueError(
                        f"KerasTransformer input must be 1-D, got {arr.shape}"
                    )
                return {"x": arr}

            return run_partition_with_passthrough(
                rows, extract, runner, output_col,
                lambda o: np.asarray(o, dtype=np.float32),
                input_cols=(input_col,),
            )

        return transform_partitions(
            dataset, partition_fn, [(output_col, "array<float>")]
        )
