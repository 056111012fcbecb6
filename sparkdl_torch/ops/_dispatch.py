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

import contextlib
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
    for CPU tensors (run the plain version) and for meta tensors (the
    plain version on shapes only: FLOP counts); raises for anything else
    or a mix."""
    devices = {t.device for t in tensors}
    if len(devices) == 1:
        kind = next(iter(devices)).type
        if kind in ("cpu", "cuda", "meta"):
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
# (``inception_stem_fused.launches``, ...), adding one through
# :func:`note_launch` where it launches its kernel. A CUDA graph replay
# launches the captured kernels without calling the wrappers, so the graph
# runner (runtime/dispatch.py) collects what the wrappers launched into the
# stream it was capturing (:func:`capture_tally`: those launches only
# recorded a node, and go to the graph's tally instead of the counts) and
# adds the tally for every replay. Launches other threads make meanwhile
# on other streams (replicas of a ReplicaPool that share a card) count as
# they happen; the counts take their additions under one lock.

_COUNT_LOCK = threading.Lock()
#: The tally of the capture in progress; graph-cache misses take turns, so
#: there is at most one (runtime/dispatch.py ``_CAPTURE_LOCK``).
_CAPTURE = {"tally": None}


def _stream_capturing() -> bool:
    return torch.cuda.is_current_stream_capturing()


def note_launch(fn, name: str = "launches") -> None:
    """One launch of ``fn``'s kernel: its ``name`` count grows by one, or,
    when the kernel went into a stream being captured, the capture's tally
    does. The capturing thread is not the only one: autograd's worker
    thread runs a captured backward on its forward's stream."""
    capturing = _CAPTURE["tally"] is not None and _stream_capturing()
    with _COUNT_LOCK:
        if capturing:
            tally = _CAPTURE["tally"]
            tally[(fn, name)] = tally.get((fn, name), 0) + 1
        else:
            setattr(fn, name, getattr(fn, name) + 1)


@contextlib.contextmanager
def capture_tally():
    """The launches made into a capturing stream inside the block, as a
    ``{(wrapper, attribute): n}`` dict, kept out of the counts."""
    tally: dict = {}
    with _COUNT_LOCK:
        outer, _CAPTURE["tally"] = _CAPTURE["tally"], tally
    try:
        yield tally
    finally:
        with _COUNT_LOCK:
            _CAPTURE["tally"] = outer


_FLOPS: "dict[str, list | None]" = {"tally": None}


def note_flops(n: float) -> None:
    """A kernel's model FLOPs, for :func:`flop_tally` (the FLOPs its
    plain version's matmuls would show ``FlopCounterMode``, which does
    not see a kernel called through ctypes)."""
    tally = _FLOPS["tally"]
    if tally is not None:
        with _COUNT_LOCK:
            tally[0] += n


@contextlib.contextmanager
def flop_tally():
    """``[total]``: the FLOPs kernels noted inside the block."""
    tally = [0.0]
    outer, _FLOPS["tally"] = _FLOPS["tally"], tally
    try:
        yield tally
    finally:
        _FLOPS["tally"] = outer


def count_launches(fn, *names: str) -> None:
    """Give ``fn`` its launch-count attributes, each set to 0."""
    for name in names:
        setattr(fn, name, 0)


def add_launches(delta: dict, times: int = 1) -> None:
    """Add ``times`` x ``delta`` to the counts (negative to take back)."""
    with _COUNT_LOCK:
        for (fn, name), d in delta.items():
            setattr(fn, name, getattr(fn, name) + d * times)
