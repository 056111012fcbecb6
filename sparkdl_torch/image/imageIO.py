"""Image decode and numpy <-> struct conversion.

``imageArrayToStruct`` / ``imageStructToArray`` round-trip numpy arrays
through the Spark image struct, the native libjpeg/libpng decoder
(``native/decode.py``) or PIL decodes bytes, and
``readImagesWithCustomFn`` builds an image DataFrame from files with a
user decode function. Structs hold BGR; arrays handed to and from models
are RGB unless stated otherwise.
"""

from __future__ import annotations

import io
import os
from typing import Callable, Sequence

import numpy as np
from PIL import Image

from sparkdl_torch.image.schema import (
    OCV_TYPES,
    UNDEFINED_MODE,
    image_struct,
    ocv_type_for,
)


def imageArrayToStruct(arr: np.ndarray, origin: str = "") -> dict:
    """Convert an (H, W, C) or (H, W) numpy array to an image struct.

    The array is stored as-is (no channel flip): callers that hold RGB data
    and want Spark-convention BGR structs use :func:`imageArrayToStructBGR`.
    """
    if arr.ndim == 2:
        arr = arr[:, :, None]
    if arr.ndim != 3:
        raise ValueError(f"expected 2-D or 3-D image array, got shape {arr.shape}")
    if arr.dtype not in (np.uint8, np.float32):
        if np.issubdtype(arr.dtype, np.floating):
            arr = arr.astype(np.float32)
        elif np.issubdtype(arr.dtype, np.integer):
            arr = arr.astype(np.uint8)
        else:
            raise ValueError(f"unsupported image array dtype {arr.dtype}")
    height, width, channels = arr.shape
    ocv = ocv_type_for(arr.dtype, channels)
    data = np.ascontiguousarray(arr).tobytes()
    return image_struct(data, height, width, ocv.mode, channels, origin)


def imageArrayToStructBGR(arr_rgb: np.ndarray, origin: str = "") -> dict:
    """RGB array in, Spark-convention BGR struct out."""
    return imageArrayToStruct(rgb_to_bgr(arr_rgb), origin)


def imageStructToArray(img: dict) -> np.ndarray:
    """Convert an image struct back to an (H, W, C) numpy array (as stored,
    i.e. BGR for Spark-convention structs)."""
    mode = img["mode"]
    if mode == UNDEFINED_MODE:
        raise ValueError(f"cannot convert undefined image (origin={img.get('origin')!r})")
    if mode not in OCV_TYPES:
        raise ValueError(f"unsupported OpenCV mode {mode}")
    ocv = OCV_TYPES[mode]
    shape = (img["height"], img["width"], img["nChannels"])
    return np.frombuffer(img["data"], dtype=ocv.dtype).reshape(shape)


def rgb_to_bgr(arr: np.ndarray) -> np.ndarray:
    if arr.ndim == 3 and arr.shape[-1] >= 3:
        return arr[..., ::-1] if arr.shape[-1] == 3 else np.concatenate(
            [arr[..., 2::-1], arr[..., 3:]], axis=-1
        )
    return arr


bgr_to_rgb = rgb_to_bgr  # the flip is an involution


def PIL_decode_bytes(raw: bytes, origin: str = "") -> dict | None:
    """Decode encoded image bytes (jpeg/png/...) to a BGR image struct, or
    None (-> undefined image row) if PIL cannot decode them."""
    try:
        img = Image.open(io.BytesIO(raw))
        img = img.convert("RGB") if img.mode not in ("RGB", "L") else img
        arr = np.asarray(img)
    except Exception:  # any undecodable payload becomes an undefined row
        return None
    return imageArrayToStructBGR(arr, origin) if arr.ndim == 3 else imageArrayToStruct(arr, origin)


def native_decode_bytes(raw: bytes, origin: str = "") -> dict | None:
    """Like :func:`PIL_decode_bytes` but via the native libjpeg/libpng
    decoder (``native.decode``): threaded C decode instead of PIL. Defers
    to PIL when the native library is unavailable, for formats the native
    path does not cover (e.g. GIF), and for grayscale sources (PIL keeps
    them 1-channel CV_8UC1; the native decoder always emits RGB —
    deferring keeps the struct schema independent of which decoder a host
    happens to have)."""
    from sparkdl_torch.native import decode as _native_decode

    if _native_decode.available():
        info = _native_decode.image_info(raw)
        if info is not None and info[2] == 3:
            # Pass the probed dims: skips a second header parse.
            arr = _native_decode.decode_resize(raw, info[0], info[1])
            if arr is not None:
                return imageArrayToStructBGR(arr, origin)
    return PIL_decode_bytes(raw, origin)


def undefined_image(origin: str = "") -> dict:
    return image_struct(b"", -1, -1, UNDEFINED_MODE, -1, origin)


def readImages(path: str | Sequence[str], numPartition: int | None = None,
               dataframe_backend: str = "local"):
    """Read images with the default decoder into BGR structs (Spark's
    ``ImageSchema.readImages``): native libjpeg/libpng where the library
    builds, PIL otherwise — the same structs either way
    (:func:`native_decode_bytes` defers to PIL for anything the native
    path would represent differently)."""
    return readImagesWithCustomFn(path, native_decode_bytes, numPartition,
                                  dataframe_backend)


def readImagesWithCustomFn(
    path: str | Sequence[str],
    decode_f: Callable[[bytes], np.ndarray | dict | None] | None = None,
    numPartition: int | None = None,
    dataframe_backend: str = "local",
):
    """Read image files into an image DataFrame of ``dataframe_backend``
    (``"local"``, the one backend).

    Applies ``decode_f(bytes)`` per file; files the decoder rejects
    (returns None / raises) become "undefined image" rows, so nothing is
    dropped. ``path`` may be a directory, a glob-free file path, or an
    explicit list of paths.
    """
    from sparkdl_torch.dataframe import make_dataframe

    paths = _expand_paths(path)
    if decode_f is None:
        decode_f = PIL_decode_bytes
    rows = []
    for p in paths:
        with open(p, "rb") as f:
            raw = f.read()
        try:
            decoded = decode_f(raw)
        except Exception:  # a decoder that raises marks the row undefined
            decoded = None
        if decoded is None:
            img = undefined_image(origin=p)
        elif isinstance(decoded, np.ndarray):
            img = imageArrayToStruct(decoded, origin=p)
        else:
            img = dict(decoded)
            if not img.get("origin"):
                img["origin"] = p
        rows.append({"filePath": p, "image": img})
    return make_dataframe(rows, backend=dataframe_backend,
                          num_partitions=numPartition)


def _expand_paths(path: str | Sequence[str]) -> list[str]:
    if isinstance(path, (list, tuple)):
        return [str(p) for p in path]
    if os.path.isdir(path):
        out = []
        for root, _, files in os.walk(path):
            for name in sorted(files):
                out.append(os.path.join(root, name))
        return sorted(out)
    return [path]
