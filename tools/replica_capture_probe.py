#!/usr/bin/env python3
"""Two pool replicas capturing CUDA graphs on one card.

    python3 tools/replica_capture_probe.py

On one NVIDIA GPU, a ``ReplicaPool`` of two DeepImageFeaturizer
(InceptionV3) runners shares the card; every replica captures one CUDA
graph per batch bucket on first use, from its own worker thread. Each
trial builds fresh runners (no graph yet) and sends 64 requests of mixed
batch sizes from 8 threads straight at the pool, so one replica captures
while the other launches, replays or captures. Three settings, each in a
subprocess of its own (a broken capture may leave the CUDA context
unusable), one ``[capture]`` line each:

- ``as shipped``: ``runtime.dispatch`` takes one graph-cache miss (eager
  warm-up and capture) at a time in the process, on a stream from a
  priority pool the feed's copies never draw from, and tallies the
  launches made into the capturing stream (``ops._dispatch.capture_tally``);
- ``pool streams``: the same, but the warm-up and capture stream from
  PyTorch's default pool of 32 streams, which every ``DevicePut`` (one
  per batch) also draws from, round-robin;
- ``unserialized``: pool streams, the lock replaced by a no-op, and the
  tally by a process-wide before/after difference of the launch counts
  (taken back once, added per replay).

Each line gives the trials whose dispatches raised (the errors), and the
trials where ``inception_stem_fused.launches`` differed from the batches
the replicas ran (one launch each), with the largest difference.
"""

import contextlib
import json
import os
import subprocess
import sys
import threading

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

TRIALS, REQUESTS, THREADS = 12, 64, 8


def _unserialize():
    """No lock, and the launches a capture counted taken as a
    process-wide delta."""
    from sparkdl_torch.ops import _dispatch
    from sparkdl_torch.ops.stem_fused import inception_stem_fused
    from sparkdl_torch.runtime import dispatch

    key = (inception_stem_fused, "launches")

    @contextlib.contextmanager
    def global_delta():
        before = inception_stem_fused.launches
        tally = {}
        try:
            yield tally
        finally:
            gained = inception_stem_fused.launches - before
            if gained:
                tally[key] = gained
                _dispatch.add_launches(tally, -1)

    dispatch._CAPTURE_LOCK = contextlib.nullcontext()
    _dispatch.capture_tally = global_delta


def _trial(rng, runner_for) -> dict:
    import numpy as np

    from sparkdl_torch.ops.stem_fused import inception_stem_fused
    from sparkdl_torch.serving import ReplicaPool

    pool = ReplicaPool(make_runner=runner_for, n_replicas=2, max_reroutes=0)
    sizes = rng.choice([3, 8, 13, 20, 40, 64], REQUESTS).tolist()
    errors = []
    inception_stem_fused.launches = 0

    def client(part):
        for n in part:
            batch = {"img": rng_img[:n]}
            try:
                out = pool.run_batch(batch)
                if not np.isfinite(out).all():
                    errors.append("non-finite features")
            except Exception as e:  # the finding: what a dispatch raised
                errors.append(f"{type(e).__name__}: {str(e)[:120]}")

    rng_img = rng.integers(0, 256, (64, 299, 299, 3), dtype=np.uint8)
    workers = [threading.Thread(target=client, args=(sizes[j::THREADS],))
               for j in range(THREADS)]
    for w in workers:
        w.start()
    for w in workers:
        w.join(300)
    snap = pool.snapshot()
    pool.close()
    ran = sum(r["dispatched"] for r in snap["replicas"])
    return {"errors": errors, "launches": inception_stem_fused.launches,
            "batches": ran - len(errors)}


def run(mode: str) -> None:
    import numpy as np

    from sparkdl_torch.ops import _dispatch
    from sparkdl_torch.runtime import dispatch
    from sparkdl_torch.transformers.named_image import _named_model_runner

    _dispatch.build_all()
    if mode != "as shipped":
        dispatch._CAPTURE_STREAM_PRIORITY = 0
    if mode == "unserialized":
        _unserialize()

    def runner_for(device):
        return _named_model_runner.__wrapped__("InceptionV3", "random", False,
                                               "features", 64, str(device))

    rng = np.random.default_rng(0)
    results = [_trial(rng, runner_for) for _ in range(TRIALS)]
    print(json.dumps(results))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("replica_capture_probe: CUDA is not available")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    print(card)
    for mode in ("as shipped", "pool streams", "unserialized"):
        proc = subprocess.run([sys.executable, __file__, "--mode", mode],
                              capture_output=True, text=True, timeout=400)
        if proc.returncode != 0:
            print(f"[capture] {mode}: the probe process failed (rc "
                  f"{proc.returncode}): {proc.stderr[-1500:]}")
            continue
        results = json.loads(proc.stdout.strip().splitlines()[-1])
        errs = [r for r in results if r["errors"]]
        off = [r["launches"] - r["batches"] for r in results
               if r["launches"] != r["batches"]]
        first = next((r["errors"][0] for r in errs), None)
        print(f"[capture] {mode}: {TRIALS} trials of {REQUESTS} requests from "
              f"{THREADS} threads over 2 fresh replicas on one card; {card}: "
              f"{len(errs)} trial(s) with failed dispatches "
              f"({sum(len(r['errors']) for r in errs)} in all; first: {first}); "
              f"{len(off)} trial(s) where stem launches != batches run "
              f"(differences {off})")
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mode"]:
        run(sys.argv[2])
    else:
        sys.exit(main())
