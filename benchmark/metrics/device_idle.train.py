"""device_idle.train: share of the traced window, %, in which no operation
ran on the card (the union of the profiler's intervals, kernels and
copies)."""


def read(rec):
    if rec.get("mode") != "train" or not rec.get("window_s"):
        return None
    return 100.0 * (1.0 - rec["busy_s"] / rec["window_s"])
