"""Build-on-first-use loaders and ctypes signatures for the host libraries.

The binding layer is ctypes over a plain C ABI, as for the CUDA kernels.
Each library is compiled at first use with ``g++`` into
``sparkdl_torch/_build/`` (listed in ``.gitignore``); its file name
carries a hash of its source and flags, so an edited source is rebuilt
and an unchanged one is loaded as it is. Environments without a
toolchain (or without a library's link dependencies) get
``lib() -> None`` for that library and the pure-Python paths take over:
the staging ring (``csrc/sdl_bridge.cc``) and the image decoder
(``csrc/sdl_decode.cc``, links libjpeg and libpng) fail independently.
``SPARKDL_TORCH_DISABLE_NATIVE`` set to anything disables both.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from typing import Callable, Sequence

logger = logging.getLogger(__name__)

_HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-pthread")


class NativeLib:
    """One lazily-built native library: compile, cache, declare, fall back."""

    def __init__(self, name: str, source: str,
                 declare: Callable[[ctypes.CDLL], ctypes.CDLL],
                 link_flags: Sequence[str] = ()):
        self.name = name
        self._src = os.path.join(_HERE, "csrc", source)
        self._declare = declare
        self._link_flags = list(link_flags)
        self._lock = threading.Lock()
        self._lib: ctypes.CDLL | None = None
        self._tried = False
        #: why the library is unavailable (the compiler's output or the
        #: load error), else None
        self.build_error: "str | None" = None

    def path(self) -> str:
        h = hashlib.sha256()
        with open(self._src, "rb") as f:
            h.update(f.read())
        h.update(" ".join(CXX_FLAGS + tuple(self._link_flags)).encode())
        return os.path.join(BUILD_DIR, f"lib{self.name}-{h.hexdigest()[:16]}.so")

    def _compile(self, so: str) -> bool:
        os.makedirs(BUILD_DIR, exist_ok=True)
        # per-process tmp name: concurrent first uses (several executor
        # processes on one host) must not write through the same tmp inode;
        # whichever os.replace lands last wins, both are valid builds.
        tmp = f"{so}.tmp.{os.getpid()}"
        cmd = [os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", tmp, self._src,
               *self._link_flags]
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
            os.replace(tmp, so)  # atomic publish
            return True
        except (OSError, subprocess.SubprocessError) as e:
            detail = getattr(e, "stderr", b"") or b""
            self.build_error = f"{e}: {detail.decode(errors='replace')[:2000]}"
            logger.warning("%s native build failed (%s); using the "
                           "pure-Python path", self.name, self.build_error)
            return False

    def lib(self) -> ctypes.CDLL | None:
        """The loaded library, building it if needed; None if unavailable."""
        if self._lib is not None or self._tried:
            return self._lib
        with self._lock:
            if self._lib is not None or self._tried:
                return self._lib
            self._tried = True
            if os.environ.get("SPARKDL_TORCH_DISABLE_NATIVE"):
                logger.info("%s disabled via SPARKDL_TORCH_DISABLE_NATIVE",
                            self.name)
                return None
            so = self.path()
            if not os.path.exists(so) and not self._compile(so):
                return None
            for attempt in (1, 2):
                try:
                    self._lib = self._declare(ctypes.CDLL(so))
                    self.build_error = None
                    break
                except (OSError, AttributeError) as e:
                    # a build copied from another host (its libjpeg is
                    # not this one's) or a corrupt file: build it here
                    # once; if that fails too, use the Python path
                    # instead of erroring in every batch assembly.
                    self.build_error = f"could not load {so}: {e}"
                    logger.warning("%s", self.build_error)
                    if attempt == 2 or not self._compile(so):
                        break
            return self._lib

    def available(self) -> bool:
        return self.lib() is not None


def _declare_bridge(lib: ctypes.CDLL) -> ctypes.CDLL:
    c = ctypes
    lib.sdl_ring_create.restype = c.c_void_p
    lib.sdl_ring_create.argtypes = [c.c_uint64, c.c_uint32]
    lib.sdl_ring_destroy.argtypes = [c.c_void_p]
    lib.sdl_ring_slot_bytes.restype = c.c_uint64
    lib.sdl_ring_slot_bytes.argtypes = [c.c_void_p]
    lib.sdl_ring_n_slots.restype = c.c_uint32
    lib.sdl_ring_n_slots.argtypes = [c.c_void_p]
    lib.sdl_ring_slot_ptr.restype = c.POINTER(c.c_uint8)
    lib.sdl_ring_slot_ptr.argtypes = [c.c_void_p, c.c_uint32]
    lib.sdl_ring_acquire_write.restype = c.c_int64
    lib.sdl_ring_acquire_write.argtypes = [c.c_void_p, c.c_double]
    lib.sdl_ring_commit_write.argtypes = [c.c_void_p, c.c_uint32, c.c_uint64, c.c_uint64]
    lib.sdl_ring_abort_write.argtypes = [c.c_void_p, c.c_uint32]
    lib.sdl_ring_acquire_read.restype = c.c_int64
    lib.sdl_ring_acquire_read.argtypes = [c.c_void_p, c.c_double]
    lib.sdl_ring_slot_rows.restype = c.c_uint64
    lib.sdl_ring_slot_rows.argtypes = [c.c_void_p, c.c_uint32]
    lib.sdl_ring_slot_used.restype = c.c_uint64
    lib.sdl_ring_slot_used.argtypes = [c.c_void_p, c.c_uint32]
    lib.sdl_ring_release_read.argtypes = [c.c_void_p, c.c_uint32]
    lib.sdl_ring_close.argtypes = [c.c_void_p]
    lib.sdl_ring_closed.restype = c.c_int
    lib.sdl_ring_closed.argtypes = [c.c_void_p]
    lib.sdl_pack_rows.argtypes = [
        c.POINTER(c.c_uint8), c.POINTER(c.POINTER(c.c_uint8)),
        c.POINTER(c.c_uint64), c.c_uint64, c.c_uint64, c.c_uint64,
        c.c_uint64, c.c_uint32,
    ]
    lib.sdl_u8_to_f32.argtypes = [
        c.POINTER(c.c_float), c.POINTER(c.c_uint8), c.c_uint64,
        c.c_float, c.c_float, c.c_uint32,
    ]
    return lib


def _declare_decode(lib: ctypes.CDLL) -> ctypes.CDLL:
    c = ctypes
    lib.sdl_image_info.restype = c.c_int32
    lib.sdl_image_info.argtypes = [
        c.POINTER(c.c_uint8), c.c_uint64,
        c.POINTER(c.c_int32), c.POINTER(c.c_int32), c.POINTER(c.c_int32),
    ]
    lib.sdl_decode_resize.restype = c.c_int32
    lib.sdl_decode_resize.argtypes = [
        c.POINTER(c.c_uint8), c.c_uint64, c.c_int32, c.c_int32,
        c.POINTER(c.c_uint8),
    ]
    lib.sdl_decode_resize_batch.restype = None
    lib.sdl_decode_resize_batch.argtypes = [
        c.c_uint64, c.POINTER(c.POINTER(c.c_uint8)),
        c.POINTER(c.c_uint64), c.c_int32, c.c_int32,
        c.POINTER(c.c_uint8), c.c_int32, c.POINTER(c.c_int32),
    ]
    return lib


BRIDGE = NativeLib("sdlbridge", "sdl_bridge.cc", _declare_bridge)
DECODE = NativeLib("sdldecode", "sdl_decode.cc", _declare_decode,
                   link_flags=("-ljpeg", "-lpng"))


def lib() -> ctypes.CDLL | None:
    """The staging-bridge library, or None where it cannot be built."""
    return BRIDGE.lib()


def available() -> bool:
    return BRIDGE.available()


def decode_lib() -> ctypes.CDLL | None:
    return DECODE.lib()


def decode_available() -> bool:
    return DECODE.available()
