"""gemm_bn_roofline: the fused 1x1-conv GEMM + BN-stats kernel's share of
its roofline, %: the sum over its launches of each launch's bound
(``flops.gemm_bn_bound_s``: 25 shapes a step, operations 2MKN at 495/3 =
165 TFLOP/s or bytes at 3.35 TB/s, the longer; H100 SXM at 700 W) over
the measured time of its kernels (``gemm_bn_kernel`` and its
``stats_reduce_kernel``). The launches are counted in the trace, 25 a
step. None where no launch ran in the window."""

from benchmark import flops
from benchmark.records import batch_size, image_size, kernel_events, seconds


def read(rec):
    if rec.get("mode") != "train":
        return None
    gemms = kernel_events(rec, "gemm_bn_kernel")
    if not gemms:
        return None
    size = image_size(rec)
    steps = len(gemms) / flops.gemm_bn_launches_a_step(size)
    bound = steps * flops.gemm_bn_bound_s(batch_size(rec), size)
    return 100.0 * bound / (seconds(gemms) + seconds(kernel_events(rec, "stats_reduce_kernel")))
