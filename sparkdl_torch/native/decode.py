"""Native JPEG/PNG decode + resize (ctypes over csrc/sdl_decode.cc).

Host-side image ingest without a Python loop in the hot path:
libjpeg/libpng + threads behind a C ABI, with
``imageIO.PIL_decode_bytes`` as the pure-Python path when the library
cannot build (a host without the libjpeg or libpng headers).

Resize sampling is plain half-pixel bilinear, the same as the JAX
package's on-device resize.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from sparkdl_torch.native import _lib


def available() -> bool:
    return _lib.decode_available()


def _info_from_buf(lib, buf, n) -> "tuple[int, int, int] | None":
    h = ctypes.c_int32()
    w = ctypes.c_int32()
    ch = ctypes.c_int32()
    rc = lib.sdl_image_info(
        buf, n, ctypes.byref(h), ctypes.byref(w), ctypes.byref(ch)
    )
    return (h.value, w.value, ch.value) if rc == 0 else None


def image_info(raw: bytes) -> "tuple[int, int, int] | None":
    """(height, width, source channels) from the header; None if not a
    known format. Channels describe the FILE (1 grayscale / 3 RGB /
    4 RGBA); :func:`decode_resize` always emits 3-channel RGB."""
    lib = _lib.decode_lib()
    if lib is None:
        return None
    buf = (ctypes.c_uint8 * len(raw)).from_buffer_copy(raw)
    return _info_from_buf(lib, buf, len(raw))


def decode_resize(raw: bytes, height: "int | None" = None,
                  width: "int | None" = None) -> "np.ndarray | None":
    """Decode one JPEG/PNG to RGB uint8 [H, W, 3]; None on failure.

    Without height/width, decodes at native size (header probe first);
    specifying only one of the two is a misuse and raises.
    """
    if (height is None) != (width is None):
        raise ValueError(
            "pass both height and width, or neither (native size); got "
            f"height={height}, width={width}"
        )
    lib = _lib.decode_lib()
    if lib is None:
        return None
    buf = (ctypes.c_uint8 * len(raw)).from_buffer_copy(raw)  # one copy only
    if height is None:
        info = _info_from_buf(lib, buf, len(raw))
        if info is None:
            return None
        height, width, _ = info
    out = np.empty((height, width, 3), np.uint8)
    rc = lib.sdl_decode_resize(
        buf, len(raw), height, width,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    return out if rc == 0 else None


def decode_resize_batch(
    raws: "list[bytes]", height: int, width: int,
    n_threads: "int | None" = None,
) -> "tuple[np.ndarray, np.ndarray]":
    """Threaded batch decode into [N, height, width, 3] RGB uint8.

    Returns (batch, statuses); statuses[i] == 0 marks a good row, failed
    rows are zeroed. Raises RuntimeError when the native lib is missing —
    callers choose their own fallback (this is the hot path; silently
    degrading to a Python loop would hide a deployment problem).
    """
    lib = _lib.decode_lib()
    if lib is None:
        raise RuntimeError(
            "native decode library unavailable; use imageIO.PIL_decode_bytes"
        )
    n = len(raws)
    out = np.zeros((n, height, width, 3), np.uint8)
    statuses = np.zeros(n, np.int32)
    if n == 0:
        return out, statuses
    if n_threads is None:
        n_threads = min(8, os.cpu_count() or 1)
    bufs = [(ctypes.c_uint8 * len(r)).from_buffer_copy(r) for r in raws]
    ptrs = (ctypes.POINTER(ctypes.c_uint8) * n)(
        *[ctypes.cast(b, ctypes.POINTER(ctypes.c_uint8)) for b in bufs]
    )
    lens = (ctypes.c_uint64 * n)(*[len(r) for r in raws])
    lib.sdl_decode_resize_batch(
        n, ptrs, lens, height, width,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        n_threads, statuses.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return out, statuses
