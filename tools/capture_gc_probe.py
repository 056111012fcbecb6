#!/usr/bin/env python3
"""Garbage collection and CUDA-graph captures.

    python3 tools/capture_gc_probe.py

On one NVIDIA GPU, two questions, one ``[gc]`` line each:

1. Does collecting a dropped runner's garbage during a capture break the
   capture? A ``BatchedRunner`` and a ResNet50 ``DeepImageFeaturizer``
   run on the card and are dropped with their reference cycles left for
   the collector; then a small graph is captured through ``GraphCache``
   whose function calls ``gc.collect()`` while the stream captures.
2. Does an automatic collection start during a capture? With Python's
   GC thresholds at 1 (any allocation starts a collection), a capture
   allocates; ``gc.callbacks`` counts the collections that start while
   the stream captures, once with ``runtime.dispatch.no_gc`` as shipped
   (the collector off during a capture) and once with it replaced by a
   no-op.
"""

import contextlib
import gc
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from sparkdl_torch.runtime import dispatch  # noqa: E402


def drop_runners() -> None:
    """Leave a dropped runner's and a featurizer runner's cycles behind."""
    from sparkdl_torch import DeepImageFeaturizer, LocalDataFrame
    from sparkdl_torch.image import imageArrayToStructBGR
    from sparkdl_torch.transformers import named_image
    from sparkdl_torch.transformers._inference import BatchedRunner

    r = BatchedRunner(lambda b: b["x"] * 2, batch_size=64, device="cuda")
    assert len(list(r.run({"x": np.full(16, i, np.float32)} for i in range(300)))) == 300
    del r
    rng = np.random.default_rng(0)
    rows = [{"image": imageArrayToStructBGR(rng.integers(0, 256, (224, 224, 3),
                                                         dtype=np.uint8))}
            for _ in range(130)]
    f = DeepImageFeaturizer(inputCol="image", outputCol="f", modelName="ResNet50",
                            weights="random", batchSize=64)
    f.transform(LocalDataFrame.from_rows(rows, 2)).collect()
    named_image._named_model_runner.cache_clear()
    named_image._load_named_model.cache_clear()


def capture(fn) -> str:
    """Capture and replay ``fn`` on a small input: 'held' or the error."""
    x = torch.ones(64, 8, device="cuda")
    cache = dispatch.GraphCache("probe")
    try:
        cache(fn, (x,))
        cache(fn, (x,))  # the replay
        return "held"
    except RuntimeError as e:
        torch.cuda.synchronize()
        return f"FAILED ({str(e)[:120]})"


def collected_mid_capture() -> str:
    gc.disable()
    drop_runners()
    found = {}

    def fn(t):
        if torch.cuda.is_current_stream_capturing():
            found["n"] = gc.collect()
        return t * 2

    result = capture(fn)
    gc.enable()
    return f"{found.get('n')} objects collected mid-capture: capture {result}"


def automatic_collections() -> int:
    """Collections that start while the stream captures, GC thresholds 1."""
    starts = []

    def watch(phase, info):
        if phase == "start" and torch.cuda.is_current_stream_capturing():
            starts.append(info["generation"])

    def fn(t):
        junk = [[i] for i in range(2000)]  # allocations
        return t * 2 + len(junk)

    thresholds = gc.get_threshold()
    gc.callbacks.append(watch)
    gc.set_threshold(1, 1, 1)
    try:
        result = capture(fn)
    finally:
        gc.set_threshold(*thresholds)
        gc.callbacks.remove(watch)
    assert result == "held", result
    return len(starts)


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("capture_gc_probe: CUDA is not available")
    card = torch.cuda.get_device_name(0)
    print(f"[gc] a dropped BatchedRunner and ResNet50 featurizer runner, "
          f"{collected_mid_capture()}; {card}")
    shipped = automatic_collections()
    dispatch.no_gc = contextlib.nullcontext
    without = automatic_collections()
    print(f"[gc] GC thresholds 1/1/1: collections started during a capture: "
          f"{shipped} with no_gc as shipped, {without} with it a no-op; {card}")
    return 0 if shipped == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
