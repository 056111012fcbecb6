"""Kernel dispatch and the kernel build shared by every op in ``ops/``.

Dispatch is decided by where the tensors are, never by trying: a wrapper
runs its kernel's plain PyTorch version for CPU tensors and its
hand-written kernel for CUDA tensors. Anything else raises, and so does a
kernel that cannot be built or launched — there is no quiet fallback.

Build: each ``csrc/<name>.cu`` is compiled at first use by ``nvcc`` into a
shared library with a plain C interface, loaded with ``ctypes``, under
``sparkdl_torch/_build/`` (listed in ``.gitignore``). The library's file
name carries a content hash of every ``csrc/`` source, so an edited
source is rebuilt and an unchanged one is loaded as it is.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: ``cpu`` or ``cuda`` only, and
    ``cuda`` only where CUDA is present — asking for it on a machine
    without it raises instead of running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"device must be 'cpu' or 'cuda', got {device!r}")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device={device!r} was requested but CUDA is not available; "
            "pass device='cpu' to run on the CPU"
        )
    return dev


def on_cuda(*tensors: torch.Tensor) -> bool:
    """True for tensors all on one CUDA device (launch the kernel), False
    for CPU tensors (run the plain version); raises for anything else or
    a mix."""
    devices = {t.device for t in tensors}
    if len(devices) == 1:
        kind = next(iter(devices)).type
        if kind in ("cpu", "cuda"):
            return kind == "cuda"
    raise ValueError(
        f"expected all tensors on the CPU or all on one CUDA device, got "
        f"{sorted(str(t.device) for t in tensors)}"
    )


def refuse_grad(name: str, *tensors) -> None:
    """Raise where a gradient is wanted through a forward-only kernel
    wrapper: with grad mode on and an input that requires grad, its output
    would come back detached on CUDA (the kernel fills a fresh tensor),
    so both devices refuse instead."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} has no backward (nor has its JAX counterpart): call it "
            "under torch.no_grad() or torch.inference_mode(), or on inputs "
            "that do not require grad")


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _source_digest() -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh", ".h"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
        "PATH): the CUDA kernels of sparkdl_torch cannot be built"
    )


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{_source_digest()}.so"


def build_all() -> dict[str, tuple[float, str]]:
    """Build every ``csrc/*.cu`` that is not built yet, one ``nvcc`` per
    source, all started together. Returns {name: (seconds, compiler
    log)}; raises with the compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    pending = {}
    for src in sources():
        out = library_path(src.stem)
        if out.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        pending[src.stem] = (proc, tmp, out, time.perf_counter())
    done, failed = {}, []
    for name, (proc, tmp, out, t0) in pending.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"--- nvcc {name}.cu (exit {proc.returncode}) ---\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
        done[name] = (time.perf_counter() - t0, log)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return done


def load_library(name: str) -> ctypes.CDLL:
    """The ctypes handle of ``csrc/<name>.cu``'s library, built if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    f"kernel library {name!r} needs CUDA, which is not available"
                )
            path = library_path(name)
            if not path.exists():
                build_all()
            lib = ctypes.CDLL(str(path))
            _LIBS[name] = lib
        return lib


def stream_handle() -> int:
    """PyTorch's current CUDA stream, as the int a ctypes c_void_p takes."""
    return torch.cuda.current_stream().cuda_stream


# -- launch counts ------------------------------------------------------------
#
# Each kernel wrapper counts its launches in attributes of its own
# (``inception_stem_fused.launches``, ...), adding one where it launches
# its kernel. A CUDA graph replay launches the captured kernels without
# calling the wrappers, so the graph runner (runtime/dispatch.py) takes
# back what the wrappers counted during a capture, where nothing ran, and
# adds it again for every replay.

_COUNTERS: "list[tuple[object, str]]" = []


def count_launches(fn, *names: str) -> None:
    """Register ``fn``'s launch-count attributes (each set to 0)."""
    for name in names:
        setattr(fn, name, 0)
        _COUNTERS.append((fn, name))


def launch_counts() -> "dict[tuple[object, str], int]":
    """Every registered launch count, keyed by (wrapper, attribute)."""
    return {key: getattr(*key) for key in _COUNTERS}


def launch_delta(before: dict, after: dict) -> "dict[tuple[object, str], int]":
    """What each count gained from ``before`` to ``after`` (a count
    registered in between started at 0)."""
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v != before.get(k, 0)}


def add_launches(delta: dict, times: int = 1) -> None:
    """Add ``times`` x ``delta`` to the counts (negative to take back)."""
    for (fn, name), d in delta.items():
        setattr(fn, name, getattr(fn, name) + d * times)
