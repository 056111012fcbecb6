"""dispatch_ms: host ms of one dispatch of the chainer (the graph replay's
enqueue with its input and output copies), from the program's
``dispatch.chain`` span (``runtime/dispatch.py``)."""

from benchmark.records import span_mean_ms


def read(rec):
    if rec.get("mode") != "featurize":
        return None
    return span_mean_ms(rec, "dispatch.chain")
