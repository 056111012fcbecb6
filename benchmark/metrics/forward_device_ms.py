"""forward_device_ms: device ms of the model's forward a batch: the time in
the window during which a kernel of any task ran on the card (the union of
the tasks' kernel intervals, so time-slicing between the tasks' contexts
is counted once), over the batches the window completed."""

from benchmark.records import batch_size, kernel_events, seconds
from benchmark.stats import union


def read(rec):
    if rec.get("mode") != "featurize" or not rec.get("images"):
        return None
    kernels = kernel_events(rec)
    if not kernels:
        return None
    busy = seconds(union(kernels, *rec["window"]))
    return busy * 1e3 / (rec["images"] / batch_size(rec))
