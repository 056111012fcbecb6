"""Model input preprocessing on tensors.

The keras.applications ``preprocess_input`` modes the named-model
registry uses: 'tf' (Inception/Xception), 'caffe' (ResNet/VGG), 'torch'.
Inputs are RGB float tensors in [0, 255] with shape (..., H, W, 3);
outputs are what each model family expects. :func:`resize_images` is
the batched device resize.
"""

from __future__ import annotations

import functools

import torch

_CAFFE_MEAN_BGR = (103.939, 116.779, 123.68)
_TORCH_MEAN = (0.485, 0.456, 0.406)
_TORCH_STD = (0.229, 0.224, 0.225)


def preprocess_tf(x: torch.Tensor) -> torch.Tensor:
    """Scale [0,255] -> [-1, 1]."""
    return x / 127.5 - 1.0


@functools.lru_cache(maxsize=None)
def _constant(values: tuple, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """``values`` as a tensor, made once per (device, dtype). A new one
    would be a host->device copy, which a CUDA-graph capture refuses; the
    runner's eager warm-up makes it before its capture."""
    with torch.inference_mode(False):
        return torch.tensor(values, dtype=dtype, device=device)


def preprocess_caffe(x: torch.Tensor) -> torch.Tensor:
    """RGB -> BGR, subtract ImageNet channel means (no scaling)."""
    return x.flip(-1) - _constant(_CAFFE_MEAN_BGR, x.device, x.dtype)


def preprocess_torch(x: torch.Tensor) -> torch.Tensor:
    mean = _constant(_TORCH_MEAN, x.device, x.dtype)
    std = _constant(_TORCH_STD, x.device, x.dtype)
    return (x / 255.0 - mean) / std


def preprocess_identity(x: torch.Tensor) -> torch.Tensor:
    return x


PREPROCESSORS = {
    "tf": preprocess_tf,
    "caffe": preprocess_caffe,
    "torch": preprocess_torch,
    "identity": preprocess_identity,
}


def resize_images(x: torch.Tensor, height: int, width: int,
                  method: str = "bilinear") -> torch.Tensor:
    """Batched image resize on the tensor's device: ``x`` (..., H, W, C)
    to (..., ``height``, ``width``, C), bilinear with half-pixel centers
    and antialias off (the TF1-style resize of the reference's graphs;
    ``jax.image.resize(..., antialias=False)`` in the reference)."""
    import torch.nn.functional as F

    if method not in ("bilinear", "linear"):
        raise ValueError(f"unsupported resize method {method!r} (bilinear)")
    lead = x.shape[:-3]
    nchw = x.reshape(-1, *x.shape[-3:]).permute(0, 3, 1, 2)
    out = F.interpolate(nchw, size=(height, width), mode="bilinear",
                        align_corners=False, antialias=False)
    return out.permute(0, 2, 3, 1).reshape(*lead, height, width, x.shape[-1])
