"""bn_device_ms: device ms a step of the fused train step's BatchNorm
kernels (``csrc/bn_train.cu``, every kernel named ``bn_train_*``): their
time in the traced window over the window's steps. None where no such
kernel ran."""

from benchmark.records import kernel_events, seconds


def read(rec):
    if rec.get("mode") != "train" or not rec.get("steps"):
        return None
    kernels = kernel_events(rec, "bn_train_")
    if not kernels:
        return None
    return seconds(kernels) * 1e3 / rec["steps"]
