"""fetch_wait_ms: host ms a batch blocked on its result's readback, from
the program's ``fetch.wait`` span (``runtime/completion.py``)."""

from benchmark.records import span_mean_ms


def read(rec):
    if rec.get("mode") != "featurize":
        return None
    return span_mean_ms(rec, "fetch.wait")
