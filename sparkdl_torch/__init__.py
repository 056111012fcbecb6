"""sparkdl_torch — Deep Learning Pipelines on PyTorch and CUDA.

The PyTorch/H100 port of ``sparkdl_tpu``: the same transformer names and
Param surface, with the models as ``torch.nn`` code and every TPU kernel
of a ported path rewritten by hand for Hopper (``csrc/``). Nothing here
imports JAX, Flax or ``sparkdl_tpu``. Imports are lazy so that light uses
(image IO, params) load neither the models nor the kernels.
"""

from sparkdl_torch.version import __version__

_LAZY = {
    # name -> module path
    "DeepImageFeaturizer": "sparkdl_torch.transformers.named_image",
    "DeepImagePredictor": "sparkdl_torch.transformers.named_image",
    "DeepTextGenerator": "sparkdl_torch.transformers.text_generator",
    "LocalDataFrame": "sparkdl_torch.dataframe.local",
    "readImages": "sparkdl_torch.image.imageIO",
    "readImagesWithCustomFn": "sparkdl_torch.image.imageIO",
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
