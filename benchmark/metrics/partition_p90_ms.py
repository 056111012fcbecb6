"""partition_p90_ms: the 90th percentile, in ms, of the durations of every
partition any task started in the traced window, all tasks together: a
Spark task's wall, whose stragglers set a stage's. (Its spread over runs
asks for a bound wider than an end-to-end metric may have.)"""

from benchmark.stats import percentile


def read(rec):
    if rec.get("mode") != "featurize" or not rec.get("partitions"):
        return None
    return percentile([e - s for s, e in rec["partitions"]], 90) * 1e3
