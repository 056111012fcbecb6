"""step_device_ms: device ms of one training step: the time of every
kernel the profiler saw start in the window over the window's steps."""

from benchmark.records import kernel_events, seconds


def read(rec):
    if rec.get("mode") != "train" or not rec.get("steps"):
        return None
    kernels = kernel_events(rec)
    if not kernels:
        return None
    return seconds(kernels) * 1e3 / rec["steps"]
