"""stem_roofline: the InceptionV3 stem kernel's share of its roofline, %:
per launch the least time the card could take for conv000-002 and the
max-pool at the batch's shape (``flops.stem_bound_s``: 78.93 GFLOP at
B=64, 299 px, at 495/3 = 165 TFLOP/s, or its bytes at 3.35 TB/s, the
longer; H100 SXM at 700 W), over the kernel's measured time. None where
no launch of ``stem_fused_kernel`` ran in the window."""

from benchmark import flops
from benchmark.records import batch_size, image_size, kernel_events, seconds


def read(rec):
    if rec.get("mode") != "featurize":
        return None
    stems = kernel_events(rec, "stem_fused_kernel")
    if not stems:
        return None
    bound = len(stems) * flops.stem_bound_s(batch_size(rec), image_size(rec))
    return 100.0 * bound / seconds(stems)
