"""The plain references against the program's plain modules on the CPU,
at a small batch and size, with the benchmark's seeded weights."""

import numpy as np
import pytest
import torch

from benchmark import traffic, weights
from benchmark.modes import train as train_mode
from benchmark.reference import inception_v3, resnet50

#: float32 on both sides, the same operations in another order
FEATURE_TOL = 1e-5


def _rgb(seed, n, size):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, 256, (n, size, size, 3)).astype(np.float32))


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


def test_inception_v3_reference_matches_the_program_plain_and_fused():
    from sparkdl_torch.models.inception import InceptionV3
    from sparkdl_torch.models.inception_fused import (
        fused_inception_v3_features,
        prepare_fused_inception_v3,
    )
    from sparkdl_torch.ops.fold import fold_tf_preprocess
    from sparkdl_torch.ops.preprocess import preprocess_tf

    ref = inception_v3.build()
    state = weights.make_state(ref, 3, "cpu")
    ref.load_state_dict(state)
    port = InceptionV3(include_top=False).eval()
    port.load_state_dict(state)
    x = _rgb(0, 2, 107)
    want = inception_v3.features(ref, x)
    with torch.no_grad():
        plain = port(preprocess_tf(x))[0]
        fused = fused_inception_v3_features(
            prepare_fused_inception_v3(fold_tf_preprocess(port.state_dict())), x,
            dtype=torch.float32)
    assert want.shape == (2, 2048)
    assert _rel(plain, want) < FEATURE_TOL
    assert _rel(fused, want) < FEATURE_TOL


def test_resnet50_reference_matches_the_program_features():
    from sparkdl_torch.models.resnet import ResNet50
    from sparkdl_torch.ops.preprocess import preprocess_caffe

    ref = resnet50.build()
    state = weights.make_state(ref, 4, "cpu")
    ref.load_state_dict(state)
    port = ResNet50(include_top=False, device="cpu").eval()
    port.load_state_dict(state)
    x = _rgb(1, 2, 64)
    with torch.no_grad():
        got = port(preprocess_caffe(x))[0]
    assert _rel(got, resnet50.features(ref, x)) < FEATURE_TOL


def test_resnet50_reference_step_matches_the_program_fused_step():
    """One training step of the program's fused step (its plain kernels on
    the CPU) against the reference's: the loss, and each leaf's first
    gradient and change by the harness's own measure."""
    from sparkdl_torch.models.resnet import ResNet50
    from sparkdl_torch.train.vision import make_resnet50_fused_train_step

    with torch.device("meta"):
        shapes = resnet50.build(include_top=True)
    state = weights.make_state(shapes, 5, "cpu")
    xs, ys = traffic.train_pool(5, {"batch_size": 16, "pool_batches": 1}, (64, 64), 1000, "cpu")

    port = ResNet50(num_classes=1000, device="cpu")
    port.load_state_dict(state)
    opt = torch.optim.SGD(port.parameters(), lr=0.1, momentum=0.9)
    step = make_resnet50_fused_train_step(port, opt, num_classes=1000, dtype=torch.float32)
    got = train_mode._first_steps(step, port, opt, xs, ys, steps=1)

    ref = resnet50.build(include_top=True)
    ref.load_state_dict(state)
    ropt = torch.optim.SGD(ref.parameters(), lr=0.1, momentum=0.9)

    def call(x, y):
        ropt.zero_grad()
        loss = resnet50.loss(ref, x, y)
        loss.backward()
        ropt.step()
        return loss.detach()

    want = train_mode._first_steps(call, ref, ropt, xs, ys, steps=1)
    assert got["losses"][0] == pytest.approx(want["losses"][0], rel=1e-5)
    # float32 BatchNorm gradients at B=16: a float32 reference reads up to
    # ~6e-3 against float64 here, so the two float32 programs may differ by
    # about that much in a leaf's norm
    assert train_mode._worst_gap(got["grad"], want["grad"], want["grad"]) < 2e-2
    assert train_mode._worst_gap(got["stats"], want["stats"], want["stats"]) < 2e-2
