"""registerKerasImageUDF — deploy a Keras image model as a SQL-style UDF.

The port of ``sparkdl_tpu.udf.keras_image_model``: compose (image-struct
converter ⊕ optional user preprocessor ⊕ model) into one function and
register it under a name, so ``SELECT my_udf(image) FROM t`` scores
images. The composition is a host decode (image struct -> RGB array,
resized to the model's input) feeding one device call (preprocessor ->
the model as torch ops, ``models/keras_graph``) on ``device``.
"""

from __future__ import annotations

import functools
from typing import Callable

import numpy as np
import torch

from sparkdl_torch.udf.registry import registerUDF


def registerKerasImageUDF(
    udf_name: str,
    keras_model_or_file,
    preprocessor: "Callable | None" = None,
    spark_session=None,
    device="cuda",
) -> Callable:
    """Register ``udf_name`` scoring image structs with a Keras model.

    ``keras_model_or_file``: a ``keras.Model``, a path to .h5/.keras, or a
    ``models.keras_loader.KerasGraph`` (the port's in-memory form of a
    Keras model, which needs no Keras). ``preprocessor``: optional torch
    function of the float32 RGB batch [B, H, W, 3] on ``device`` -> model
    input. ``device``: ``cuda`` (default) or ``cpu``. Returns the
    registered callable (image struct / ndarray -> np.ndarray of floats).
    """
    from sparkdl_torch.models.keras_graph import KerasGraphModule
    from sparkdl_torch.models.keras_loader import KerasGraph, read_keras_model

    graph = keras_model_or_file
    if not isinstance(graph, KerasGraph):
        graph = read_keras_model(keras_model_or_file)
    in_shape = graph.input_shape
    module = KerasGraphModule(graph, device=device).eval()
    dev = next(module.parameters()).device
    target_hw = None
    if len(in_shape) == 4 and in_shape[1] is not None and in_shape[2] is not None:
        target_hw = (int(in_shape[1]), int(in_shape[2]))

    def _apply(batch: np.ndarray) -> np.ndarray:
        with torch.inference_mode():
            x = torch.from_numpy(batch).to(dev)
            if preprocessor is not None:
                x = preprocessor(x)
            return module(x).float().cpu().numpy()

    @functools.wraps(_apply)
    def udf(image) -> np.ndarray:
        from sparkdl_torch.transformers.named_image import (
            _image_to_rgb_array,
            _resize_host,
        )

        arr = _image_to_rgb_array(image)
        if target_hw is not None:
            arr = _resize_host(arr, target_hw)
        return _apply(np.asarray(arr, np.float32)[None])[0]

    udf.__name__ = udf_name
    registerUDF(udf_name, udf, spark_session=spark_session)
    return udf
