"""pack_ms: ms a batch packing rows into the padded bucket array, from the
program's ``batch.pack`` span (``runtime/batching.py``)."""

from benchmark.records import span_mean_ms


def read(rec):
    if rec.get("mode") != "featurize":
        return None
    return span_mean_ms(rec, "batch.pack")
