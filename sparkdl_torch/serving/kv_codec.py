"""Raw-storage codec for KV blocks: one array <-> one JSON-able dict.

The port of the raw codec in ``sparkdl_tpu.disagg.handoff`` (``_enc`` /
``_dec``). An array travels as ``{"dtype", "shape", "data"}`` with its
bytes base64-encoded, so int8 codes, their float32 scales and bfloat16
blocks round-trip bit for bit — the disk tier's spill files,
parked-session export bundles and the disaggregated tiers' KV handoffs
(``sparkdl_torch.disagg.handoff``) all use it, and either package
decodes what the other wrote.

numpy has no bfloat16 (the reference decodes it through ``ml_dtypes``,
which the port does not use). A bfloat16 block is carried as its 16-bit
patterns in a :class:`BF16Bits` array — a ``uint16`` array whose type is
the tag — and is written under ``"dtype": "bfloat16"``, exactly as the
reference writes a bfloat16 array.
"""

from __future__ import annotations

import base64

import numpy as np

__all__ = ["BF16Bits", "bf16_bits", "decode", "encode"]

BFLOAT16 = "bfloat16"


class BF16Bits(np.ndarray):
    """A ``uint16`` array of bfloat16 bit patterns (see module docstring).
    Slices and reshapes keep the type, so a block cut out of a fetched
    batch of blocks stays tagged."""


def bf16_bits(a) -> BF16Bits:
    """The 16-bit patterns of a bfloat16 block (given as any 2-byte
    integer array of them, e.g. a torch ``view(torch.int16)`` readback),
    tagged as bfloat16."""
    a = np.asarray(a)
    if a.dtype.itemsize != 2 or a.dtype.kind not in "iu":
        raise TypeError(f"bfloat16 bits come as a 2-byte integer array, "
                        f"got {a.dtype}")
    return a.view(np.uint16).view(BF16Bits)


def encode(a) -> dict:
    """One array (numpy, or :class:`BF16Bits`) -> ``{"dtype", "shape",
    "data"}``."""
    name = BFLOAT16 if isinstance(a, BF16Bits) else None
    a = np.ascontiguousarray(a)
    return {"dtype": name or a.dtype.name, "shape": list(a.shape),
            "data": base64.b64encode(a.tobytes()).decode("ascii")}


def decode(d: dict) -> np.ndarray:
    """The array :func:`encode` wrote (a :class:`BF16Bits` for
    ``"bfloat16"``); the result owns its memory."""
    raw = base64.b64decode(d["data"])
    if d["dtype"] == BFLOAT16:
        return np.frombuffer(raw, np.uint16).reshape(d["shape"]).copy().view(
            BF16Bits)
    return np.frombuffer(raw, np.dtype(d["dtype"])).reshape(d["shape"]).copy()
