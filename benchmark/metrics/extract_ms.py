"""extract_ms: the transformer's host extract (struct -> RGB float32
array, a row at a time) in ms per 64 rows, from the program's
``partition.extract`` span (``transformers/_inference.py``
``run_partition_with_passthrough``)."""

from benchmark.records import batch_size, span_mean_ms


def read(rec):
    if rec.get("mode") != "featurize":
        return None
    return span_mean_ms(rec, "partition.extract", per_rows=batch_size(rec))
