"""sparkdl_torch — Deep Learning Pipelines on PyTorch and CUDA.

The PyTorch/H100 port of ``sparkdl_tpu``: the same transformer names and
Param surface, with the models as ``torch.nn`` code and every TPU kernel
of a ported path rewritten by hand for Hopper (``csrc/``). Nothing here
imports JAX, Flax or ``sparkdl_tpu``; Keras only where a Keras model or
file is read, and TensorFlow only where a TF graph or artifact is read.
Imports are lazy so that light uses (image IO, params) load neither the
models nor the kernels.
"""

from sparkdl_torch.version import __version__

_LAZY = {
    # name -> module path
    "DeepImageFeaturizer": "sparkdl_torch.transformers.named_image",
    "DeepImagePredictor": "sparkdl_torch.transformers.named_image",
    "DeepTextFeaturizer": "sparkdl_torch.transformers.text",
    "DeepTextGenerator": "sparkdl_torch.transformers.text_generator",
    "GraphFunction": "sparkdl_torch.graph.builder",
    "IsolatedSession": "sparkdl_torch.graph.builder",
    "KerasImageFileEstimator": "sparkdl_torch.estimators.keras_image_file_estimator",
    "KerasImageFileTransformer": "sparkdl_torch.transformers.keras_image",
    "KerasTransformer": "sparkdl_torch.transformers.keras_tensor",
    "LocalDataFrame": "sparkdl_torch.dataframe.local",
    "Pipeline": "sparkdl_torch.param.shared_params",
    "PipelineModel": "sparkdl_torch.param.shared_params",
    "TFImageTransformer": "sparkdl_torch.transformers.tf_image",
    "TFInputGraph": "sparkdl_torch.graph.input",
    "TFTransformer": "sparkdl_torch.transformers.tf_tensor",
    "readImages": "sparkdl_torch.image.imageIO",
    "readImagesWithCustomFn": "sparkdl_torch.image.imageIO",
    "registerKerasImageUDF": "sparkdl_torch.udf.keras_image_model",
}

__all__ = sorted(_LAZY) + ["__version__"]


def __getattr__(name: str):
    if name in _LAZY:
        import importlib

        mod = importlib.import_module(_LAZY[name])
        obj = getattr(mod, name)
        globals()[name] = obj
        return obj
    raise AttributeError(f"module 'sparkdl_torch' has no attribute {name!r}")


def __dir__():
    return __all__
