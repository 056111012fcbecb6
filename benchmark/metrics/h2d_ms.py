"""h2d_ms: ms a batch of the host-to-device put, from the program's
``batch.h2d`` span (``runtime/prefetch.py`` ``DevicePut``). The span
closes after the put's CUDA event has completed, so it times the copy
landing, not only its enqueue."""

from benchmark.records import span_mean_ms


def read(rec):
    if rec.get("mode") != "featurize":
        return None
    return span_mean_ms(rec, "batch.h2d")
