"""mfu.featurize: the featurization's share of the card's peak, %: the
forward's FLOP an image (``flops.forward_flops``: convolutions and dense
layers, 2 a multiply-add) times the traced window's images, over its
seconds, over 495/3 = 165 TFLOP/s (3xTF32, the port's float32; H100 SXM
at 700 W)."""

from benchmark import flops
from benchmark.records import image_size


def read(rec):
    if rec.get("mode") != "featurize" or not rec.get("images"):
        return None
    per_image = flops.forward_flops(rec["config"]["reference"], image_size(rec))
    return 100.0 * per_image * rec["images"] / rec["window_s"] / flops.PEAK_FLOPS
