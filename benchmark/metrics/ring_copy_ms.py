"""ring_copy_ms: ms a batch copying the packed batch into a staging-ring
slot, from the program's ``ring.copy`` span (``native/bridge.py``); none
where the feed takes the Python path."""

from benchmark.records import span_mean_ms


def read(rec):
    if rec.get("mode") != "featurize":
        return None
    return span_mean_ms(rec, "ring.copy")
