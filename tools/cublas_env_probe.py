#!/usr/bin/env python3
"""Host time of a small float32 GEMM with ``CUBLAS_WORKSPACE_CONFIG``
unset, set and unset again, in one process.

    python3 tools/cublas_env_probe.py       # one card

Each setting times 2,000 eager ``torch.mm`` calls of [128, 768] x [768,
768] (the sp chunk's q/k/v shape at sp=2) on the host clock, without a
synchronise inside the loop: what the call costs the host. A change
with the variable, in one process, shows that the setting is read on
each call, not once.
"""

from __future__ import annotations

import os
import time

import torch


def host_us(a, b, calls: int = 2000) -> float:
    for _ in range(50):
        torch.mm(a, b)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        torch.mm(a, b)
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def main() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    a = torch.randn(128, 768, device="cuda")
    b = torch.randn(768, 768, device="cuda")
    print(torch.cuda.get_device_name(0), torch.__version__)
    for setting in (None, ":4096:8", None, ":4096:8", None):
        if setting is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = setting
        print(f"CUBLAS_WORKSPACE_CONFIG={setting}: {host_us(a, b):.2f} us a torch.mm "
              "(host)", flush=True)


if __name__ == "__main__":
    main()
