#!/usr/bin/env python3
"""What the featurizer's host feed costs on one GPU, piece by piece.

    python3 tools/feed_probe.py

For one float32 batch of the main path, [64, 299, 299, 3] (68.7 MB),
prints one JSON object with the milliseconds of five runs of each:

- ``pin_memory_ms``: ``tensor.pin_memory()`` of the batch (PyTorch's
  caching host allocator: the first run allocates, the rest reuse);
- ``np_copy_ms`` / ``copy_into_pinned_ms``: a numpy copy of the batch into
  fresh memory and into page-locked memory already touched;
- ``h2d_pinned_ms`` / ``h2d_pageable_ms``: the host-to-device copy from
  page-locked and from pageable memory;
- ``register_fresh_ms`` / ``register_touched_ms`` / ``unregister_ms``:
  ``cudaHostRegister`` of 68.7 MB of fresh (untouched) and of touched
  numpy memory, and its ``cudaHostUnregister`` (three runs each);
- ``overlap_rc``: the return codes of registering two ranges that share a
  page (0, 0: CUDA takes overlapping registrations);
- ``gap_us``: the median wall time of a one-element add and a
  synchronize (the dispatch gap the chain policy calibrates);
- ``graph_B{64,16,8}``: the fused InceptionV3 forward (random weights,
  seed 0) eager and as a CUDA-graph replay: bitwise equal or not, capture
  seconds, and the milliseconds of five runs of each.

The card's name and power limit are printed first. Needs CUDA.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

B, S = 64, 299


def _times(fn, n: int = 5) -> "list[float]":
    import torch

    out = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(round((time.perf_counter() - t0) * 1e3, 3))
    return out


def host_copies(res: dict) -> None:
    import numpy as np
    import torch

    nbytes = B * S * S * 3 * 4
    x = np.random.default_rng(0).random((B, S, S, 3), dtype=np.float32)
    res["pin_memory_ms"] = _times(lambda: torch.from_numpy(x).pin_memory())
    res["np_copy_ms"] = _times(lambda: np.copyto(np.empty_like(x), x))
    pinned = torch.empty(nbytes // 4, dtype=torch.float32, pin_memory=True)
    res["copy_into_pinned_ms"] = _times(
        lambda: pinned.numpy().__setitem__(slice(None), x.reshape(-1)))
    dev = torch.empty(nbytes // 4, device="cuda")
    res["h2d_pinned_ms"] = _times(lambda: dev.copy_(pinned, non_blocking=True))
    pageable = torch.from_numpy(x.reshape(-1))
    res["h2d_pageable_ms"] = _times(lambda: dev.copy_(pageable, non_blocking=True))

    cudart = torch.cuda.cudart()
    for touched, key in ((False, "register_fresh_ms"), (True, "register_touched_ms")):
        res[key] = []
        for _ in range(3):
            a = np.empty(nbytes, np.uint8)
            if touched:
                a[::4096] = 1
            t0 = time.perf_counter()
            rc = int(cudart.cudaHostRegister(a.ctypes.data, a.nbytes, 0))
            t1 = time.perf_counter()
            rc2 = int(cudart.cudaHostUnregister(a.ctypes.data))
            t2 = time.perf_counter()
            if rc or rc2:
                raise RuntimeError(f"cudaHostRegister/Unregister: {rc}, {rc2}")
            res[key].append(round((t1 - t0) * 1e3, 3))
            res.setdefault("unregister_ms", []).append(round((t2 - t1) * 1e3, 3))
    page = 4096
    a = np.empty(12 * page, np.uint8)
    lo, hi = a.ctypes.data, a.ctypes.data + 4 * page + 100
    res["overlap_rc"] = (int(cudart.cudaHostRegister(lo, 4 * page + 100, 0)),
                         int(cudart.cudaHostRegister(hi, 2 * page, 0)))
    cudart.cudaHostUnregister(lo)
    if res["overlap_rc"][1] == 0:
        cudart.cudaHostUnregister(hi)
    z = torch.zeros((), device="cuda")
    res["gap_us"] = sorted(_times(lambda: z.add_(1.0), 31))[15] * 1e3


def graphs(res: dict) -> None:
    import numpy as np
    import torch

    from sparkdl_torch.models.inception_fused import (
        fused_inception_v3_features,
        prepare_fused_inception_v3,
    )
    from sparkdl_torch.models.registry import build_torch_model
    from sparkdl_torch.ops import _dispatch
    from sparkdl_torch.ops.fold import fold_tf_preprocess

    _dispatch.build_all()
    model = build_torch_model("InceptionV3", "random", include_top=False,
                              device="cuda", seed=0)
    params = prepare_fused_inception_v3(fold_tf_preprocess(model.state_dict()))
    for bsz in (64, 16, 8):
        x = torch.from_numpy((np.random.default_rng(1).random((bsz, S, S, 3))
                              * 255).astype(np.float32)).cuda()
        with torch.inference_mode():
            eager = fused_inception_v3_features(params, x).clone()
            static_x = x.clone()
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                for _ in range(2):
                    fused_inception_v3_features(params, static_x)
            torch.cuda.current_stream().wait_stream(side)
            g = torch.cuda.CUDAGraph()
            t0 = time.perf_counter()
            with torch.cuda.graph(g):
                static_y = fused_inception_v3_features(params, static_x)
            capture_s = time.perf_counter() - t0
            g.replay()
            torch.cuda.synchronize()
            res[f"graph_B{bsz}"] = {
                "bitwise": bool(torch.equal(eager, static_y)),
                "capture_s": round(capture_s, 3),
                "eager_ms": _times(lambda: fused_inception_v3_features(params, x)),
                "replay_ms": _times(g.replay),
            }
            del g


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("feed_probe: CUDA is not available")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip())
    res: dict = {}
    host_copies(res)
    graphs(res)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
