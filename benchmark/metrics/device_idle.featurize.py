"""device_idle.featurize: share of the traced window, %, in which no
operation of any task ran on the card (the union of every task's
profiler intervals, kernels and copies)."""


def read(rec):
    if rec.get("mode") != "featurize" or not rec.get("window_s"):
        return None
    return 100.0 * (1.0 - rec["busy_s"] / rec["window_s"])
