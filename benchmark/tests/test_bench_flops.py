"""The operation and byte counts against hand counts and against
PyTorch's own FLOP counter over the references."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import flops
from benchmark.reference import inception_v3, resnet50


def test_stem_is_78_93_gflop_at_b64():
    # 149^2*27*32 + 147^2*288*32 + 147^2*288*64 multiply-adds an image
    macs = 149 ** 2 * 27 * 32 + 147 ** 2 * 288 * 32 + 147 ** 2 * 288 * 64
    assert flops.stem_flops(64, 299) == 2 * 64 * macs
    assert flops.stem_flops(64, 299) / 1e9 == pytest.approx(78.93, abs=0.005)
    # operations bound it: 78.93 GFLOP at 165 TFLOP/s = 0.478 ms
    assert flops.stem_bound_s(64, 299) * 1e3 == pytest.approx(0.478, abs=0.001)


# Keras' ResNet50 strides the first 1x1 of a stage (v1): its 3x3s run at
# the reduced size, 7.71 GFLOP an image (8.2 is the v1.5 layout, stride on
# the 3x3)
@pytest.mark.parametrize("reference, size, gflop", [
    ("inception_v3", 299, 11.42), ("resnet50", 224, 7.71)])
def test_forward_gflop_an_image(reference, size, gflop):
    assert flops.forward_flops(reference, size) / 1e9 == pytest.approx(gflop, abs=0.005)


@pytest.mark.parametrize("reference, size, top", [
    ("inception_v3", 299, False), ("resnet50", 224, False), ("resnet50", 224, True)])
def test_forward_count_matches_torch_flop_counter(reference, size, top):
    module = {"inception_v3": inception_v3.build,
              "resnet50": lambda: resnet50.build(include_top=top)}[reference]
    with torch.device("meta"):
        m = module()
        x = torch.empty(1, size, size, 3)
    with FlopCounterMode(display=False) as counter:
        m(x)
    assert counter.get_total_flops() == flops.forward_flops(reference, size, top)


def test_train_flops_are_three_forwards_with_the_head():
    assert flops.train_flops("resnet50", 224) == 3 * flops.forward_flops("resnet50", 224, True)


def test_fused_gemm_shapes_of_a_resnet50_step():
    shapes = flops.gemm_bn_shapes(64, 224)
    assert sorted(shapes) == sorted([
        (64 * 56 * 56, 256, 64, 2, False),
        (64 * 28 * 28, 128, 512, 4, True), (64 * 28 * 28, 512, 128, 3, False),
        (64 * 14 * 14, 256, 1024, 6, True), (64 * 14 * 14, 1024, 256, 5, False),
        (64 * 7 * 7, 512, 2048, 3, True), (64 * 7 * 7, 2048, 512, 2, False)])
    assert flops.gemm_bn_launches_a_step() == 25
    # the kernel table's bound of a step's 25 launches: 1.070 ms
    assert flops.gemm_bn_bound_s(64, 224) * 1e3 == pytest.approx(1.070, abs=0.001)
