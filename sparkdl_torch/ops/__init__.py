"""The port's ops: model input preprocessing. The kernels' wrappers live
in their modules (``flash_attention``, ``stem_fused``, ``flash_decode``,
``fused_gemm_bn``), which keep those names: ``ops.flash_attention`` is
the module, its wrapper ``ops.flash_attention.flash_attention``."""

from sparkdl_torch.ops.preprocess import (
    PREPROCESSORS,
    preprocess_caffe,
    preprocess_identity,
    preprocess_tf,
    preprocess_torch,
    resize_images,
)

__all__ = [
    "PREPROCESSORS",
    "preprocess_caffe",
    "preprocess_identity",
    "preprocess_tf",
    "preprocess_torch",
    "resize_images",
]
