"""mfu.train: the training step's share of the card's peak, %: three times
the forward's FLOP a sample (``flops.train_flops``) times the traced
window's samples, over its seconds, over 495/3 = 165 TFLOP/s (3xTF32,
the port's float32; H100 SXM at 700 W)."""

from benchmark import flops
from benchmark.records import image_size


def read(rec):
    if rec.get("mode") != "train" or not rec.get("samples"):
        return None
    per_sample = flops.train_flops(rec["config"]["reference"], image_size(rec),
                                   rec["config"]["num_classes"])
    return 100.0 * per_sample * rec["samples"] / rec["window_s"] / flops.PEAK_FLOPS
