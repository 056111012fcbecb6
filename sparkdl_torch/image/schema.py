"""Spark-compatible image struct schema.

An image is a struct of (origin, height, width, nChannels, mode, data)
where ``mode`` is the OpenCV type code and ``data`` the raw row-major
bytes, in **BGR** channel order for 3/4-channel images — the convention of
``pyspark.ml.image.ImageSchema``, so pipelines written for Spark's image
DataFrames run unchanged.
"""

from __future__ import annotations

import dataclasses

import numpy as np

# OpenCV type codes: code = depth + ((channels - 1) << 3)
# depth: CV_8U = 0, CV_32F = 5
_CV_8U, _CV_32F = 0, 5


def _ocv(depth: int, channels: int) -> int:
    return depth + ((channels - 1) << 3)


@dataclasses.dataclass(frozen=True)
class OcvType:
    name: str
    mode: int
    nChannels: int
    dtype: str


#: Supported OpenCV pixel types, keyed by mode code.
OCV_TYPES = {
    t.mode: t
    for t in [
        OcvType("CV_8UC1", _ocv(_CV_8U, 1), 1, "uint8"),
        OcvType("CV_8UC3", _ocv(_CV_8U, 3), 3, "uint8"),
        OcvType("CV_8UC4", _ocv(_CV_8U, 4), 4, "uint8"),
        OcvType("CV_32FC1", _ocv(_CV_32F, 1), 1, "float32"),
        OcvType("CV_32FC3", _ocv(_CV_32F, 3), 3, "float32"),
        OcvType("CV_32FC4", _ocv(_CV_32F, 4), 4, "float32"),
    ]
}

OCV_BY_NAME = {t.name: t for t in OCV_TYPES.values()}

#: Sentinel for "decode failed" rows, mirroring ImageSchema.undefinedImageType.
UNDEFINED_MODE = -1

IMAGE_FIELD_NAMES = ("origin", "height", "width", "nChannels", "mode", "data")


class ImageSchema:
    """The names ``pyspark.ml.image.ImageSchema`` exposes, without pyspark."""

    imageFields = list(IMAGE_FIELD_NAMES)
    undefinedImageType = UNDEFINED_MODE
    ocvTypes = {t.name: t.mode for t in OCV_TYPES.values()}


def ocv_type_for(dtype: np.dtype, channels: int) -> OcvType:
    dtype = np.dtype(dtype)
    if dtype == np.uint8:
        depth = _CV_8U
    elif dtype == np.float32:
        depth = _CV_32F
    else:
        raise ValueError(
            f"unsupported image dtype {dtype}; expected uint8 or float32"
        )
    mode = _ocv(depth, channels)
    if mode not in OCV_TYPES:
        raise ValueError(f"unsupported channel count {channels} for {dtype}")
    return OCV_TYPES[mode]


def image_struct(
    data: bytes,
    height: int,
    width: int,
    mode: int,
    nChannels: int,
    origin: str = "",
) -> dict:
    return {
        "origin": origin,
        "height": int(height),
        "width": int(width),
        "nChannels": int(nChannels),
        "mode": int(mode),
        "data": data,
    }


def is_image_struct(value) -> bool:
    if not isinstance(value, dict):
        return False
    return {"height", "width", "nChannels", "mode", "data"}.issubset(value.keys())
