"""Native (C++) host runtime: staging ring, row packing, device feeder,
image decode.

The host side of the feed: stable staging memory, threaded batch
assembly, transfer/compute overlap (``bridge.py``), and JPEG/PNG
decode+resize (``decode.py``), as ctypes-bound C++ libraries built with
g++ at first use, with pure-Python paths (same API, lower throughput)
where no toolchain is present; and zero-copy Arrow column views for the
row packer (``arrow.py``, where pyarrow is installed).
"""

from sparkdl_torch.native._lib import available
from sparkdl_torch.native import arrow, decode
from sparkdl_torch.native.bridge import (
    DeviceFeeder,
    StagingRing,
    pack_rows,
    u8_to_f32,
)

__all__ = ["available", "arrow", "decode", "DeviceFeeder", "StagingRing", "pack_rows",
           "u8_to_f32"]
