"""The port's ResNet50 training path — the plain module
(sparkdl_torch/models/resnet.py), the fused forward
(sparkdl_torch/models/resnet_fused.py) and the train steps
(sparkdl_torch/train/vision.py) — against the JAX package's, on the same
variables (numpy values on the tree of ``jax.eval_shape`` of the Flax
init, through the weight bridge), 64 px, B=4, 7 classes.

Tolerances are the JAX package's own fused-vs-plain bar
(tests/models/test_resnet_fused.py): features atol 5e-3 rtol 5e-2 and
probabilities atol 1e-3 rtol 1e-2 (float32 reassociation amplified through
~50 train-mode BN rsqrts), updated running statistics atol 1e-4 rtol 1e-3.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparkdl_tpu.models.resnet import ResNet50 as JResNet50
from sparkdl_torch.models import convert
from sparkdl_torch.models.resnet import ResNet50
from sparkdl_torch.models.resnet_fused import resnet50_fused_forward
from sparkdl_torch.ops import bn_train, fused_gemm_bn
from sparkdl_torch.train.vision import (
    _nll_from_probs,
    make_resnet50_fused_train_step,
    make_vision_train_step,
    resnet50_fused_loss_fn,
)
from torch_parity import zoo_variables

CLASSES, SIZE, BATCH = 7, 64, 4


@pytest.fixture(scope="module")
def setup():
    jmodel = JResNet50(num_classes=CLASSES, include_top=True, dtype=jnp.float32)
    variables = zoo_variables(jmodel, seed=3, size=SIZE, gamma=(1.0, 0.1))
    x = np.random.default_rng(5).standard_normal(
        (BATCH, SIZE, SIZE, 3)).astype(np.float32)
    train_out = jmodel.apply(variables, x, train=True, mutable=["batch_stats"])
    return jmodel, variables, x, train_out


def _module(variables):
    m = ResNet50(num_classes=CLASSES, device="cpu")
    m.load_state_dict(convert.flax_to_torch(variables, module=m))
    return m


def test_module_is_built_on_cuda_unless_the_caller_asks_for_the_cpu(monkeypatch):
    """The entry points' device rule: ``cuda`` by default, so without CUDA
    the default raises instead of quietly training on the CPU."""
    m = ResNet50(include_top=False, device="cpu")
    assert {t.device.type for t in (*m.parameters(), *m.buffers())} == {"cpu"}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ResNet50()


def _check_outputs(feat, probs, jfeat, jprobs):
    np.testing.assert_allclose(feat.detach().numpy(), np.asarray(jfeat),
                               atol=5e-3, rtol=5e-2)
    np.testing.assert_allclose(probs.detach().numpy(), np.asarray(jprobs),
                               atol=1e-3, rtol=1e-2)


def _check_stats(stats, want):
    assert set(stats) == set(want)
    for name in want:
        for key in ("mean", "var"):
            np.testing.assert_allclose(np.asarray(stats[name][key]),
                                       np.asarray(want[name][key]),
                                       atol=1e-4, rtol=1e-3, err_msg=f"{name}/{key}")


def _buffers(module, names):
    return {n: {"mean": getattr(module, n).running_mean.numpy(),
                "var": getattr(module, n).running_var.numpy()} for n in names}


@pytest.mark.parametrize("path", ["plain", "fused"])
def test_train_forward_and_batch_stats_match_jax(setup, path, monkeypatch):
    """Both train forwards against the JAX ``model.apply(train=True,
    mutable=["batch_stats"])``; the fused one calls the fused op 25 times
    (the JAX gate: stride 1, Cin >= 128)."""
    _, variables, x, ((jfeat, jprobs), upd) = setup
    module = _module(variables)
    calls = []
    real = fused_gemm_bn.conv1x1_bn_stats

    def counting(*a, **k):
        calls.append(a[0].shape[-1])
        return real(*a, **k)

    monkeypatch.setattr("sparkdl_torch.models.resnet_fused.conv1x1_bn_stats",
                        counting)
    with torch.no_grad():
        if path == "plain":
            feat, probs = module(torch.from_numpy(x), train=True)
            stats = _buffers(module, upd["batch_stats"])
        else:
            (feat, probs), new = resnet50_fused_forward(
                module, torch.from_numpy(x), train=True, num_classes=CLASSES,
                dtype=torch.float32)
            stats = {n: {k: t.numpy() for k, t in s.items()} for n, s in new.items()}
            # the module's own buffers are left as they were
            np.testing.assert_array_equal(module.bn000.running_mean.numpy(),
                                          variables["batch_stats"]["bn000"]["mean"])
    _check_outputs(feat, probs, jfeat, jprobs)
    _check_stats(stats, upd["batch_stats"])
    assert len(calls) == (25 if path == "fused" else 0)
    assert min(calls or [128]) >= 128


def test_eval_forwards_match_jax(setup):
    jmodel, variables, x, _ = setup
    jfeat, jprobs = jmodel.apply(variables, x, train=False)
    module = _module(variables)
    with torch.no_grad():
        plain = module(torch.from_numpy(x))
        fused = resnet50_fused_forward(module, torch.from_numpy(x), train=False,
                                       num_classes=CLASSES, dtype=torch.float32)
    for feat, probs in (plain, fused):
        np.testing.assert_allclose(feat.numpy(), np.asarray(jfeat), rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs), rtol=1e-4,
                                   atol=1e-6)


def test_train_steps_track_each_other_and_the_jax_loss(setup):
    """The fused and plain steps over the same start: the first loss
    equals the JAX forward's NLL, and the loss after one update tracks
    (the JAX package's bar, 15%). Later steps are only checked finite:
    at B=4 and 2x2 spatial in stage 4 a random-init SGD trajectory is
    chaotic — measured here, the plain step in float32 and in float64
    part by 25% at the third update. Parameters, running statistics and
    momentum move in place."""
    _, variables, x, ((_, jprobs), _) = setup
    y = np.random.default_rng(6).integers(0, CLASSES, BATCH)
    want0 = float(_nll_from_probs(torch.from_numpy(np.array(jprobs)),
                                  torch.from_numpy(y)))
    losses = {}
    for name in ("plain", "fused"):
        module = _module(variables)
        opt = torch.optim.SGD(module.parameters(), lr=0.01, momentum=0.9)
        step = (make_vision_train_step(module, opt) if name == "plain"
                else make_resnet50_fused_train_step(
                    module, opt, num_classes=CLASSES, dtype=torch.float32))
        w0 = module.conv010.weight.detach().clone()
        losses[name] = [float(step(torch.from_numpy(x), torch.from_numpy(y)))
                        for _ in range(3)]
        assert float((module.conv010.weight.detach() - w0).abs().max()) > 0
        assert not np.allclose(module.bn000.running_mean.numpy(),
                               variables["batch_stats"]["bn000"]["mean"])
        assert all(len(s) for s in opt.state.values())  # momentum buffers
    for name, ls in losses.items():
        assert np.isfinite(ls).all(), (name, ls)
        assert abs(ls[0] - want0) <= 1e-3 * abs(want0), (name, ls[0], want0)
    f, b = losses["fused"][1], losses["plain"][1]
    assert abs(f - b) / abs(b) < 0.15, losses


def test_fused_forward_bf16_runs_and_rejects_a_bad_head(setup):
    _, variables, x, _ = setup
    module = _module(variables)
    with torch.no_grad():
        (feat, probs), new = resnet50_fused_forward(
            module, torch.from_numpy(x[:2, :32, :32]), train=True,
            num_classes=CLASSES, dtype=torch.bfloat16)
    assert feat.dtype == torch.float32 and probs.shape == (2, CLASSES)
    assert torch.isfinite(probs).all() and len(new) == 53
    with pytest.raises(ValueError, match="1000-class top"):
        resnet50_fused_forward(module, torch.from_numpy(x), num_classes=1000)


def test_fused_forward_matches_the_jax_fused_forward(setup):
    """Against ``resnet50_fused_apply`` itself: the Pallas kernel runs in
    interpret mode 25 times (~10 s at this size)."""
    from sparkdl_tpu.models.resnet_fused import resnet50_fused_apply

    _, variables, x, _ = setup
    (jfeat, jprobs), jstats = resnet50_fused_apply(
        variables, x, train=True, num_classes=CLASSES, dtype=jnp.float32)
    module = _module(variables)
    with torch.no_grad():
        (feat, probs), new = resnet50_fused_forward(
            copy.deepcopy(module), torch.from_numpy(x), train=True,
            num_classes=CLASSES, dtype=torch.float32)
    _check_outputs(feat, probs, jfeat, jprobs)
    _check_stats({n: {k: t.numpy() for k, t in s.items()} for n, s in new.items()},
                 jax.device_get(jstats))


def test_fused_step_routes_every_batchnorm_through_bn_train(setup, monkeypatch):
    """Forward and backward of the fused step call ops/bn_train.py once per
    launch of ``bn_train_launches`` (the list the card's launch counts and
    timings stand on), shape for shape: 28 moments, 36 applies (40
    BatchNorms), 49 backward pairs (those 40 and the 13 seams)."""
    from sparkdl_torch.models import resnet_fused

    calls = {"moments": [], "apply": [], "backward": []}

    def counting(kind, fn, shape):
        def wrapped(*a, **k):
            calls[kind].append(shape(*a, **k))
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(resnet_fused, "batch_moments", counting(
        "moments", bn_train.batch_moments, lambda y: tuple(y.shape)))
    monkeypatch.setattr(resnet_fused, "bn_train", counting(
        "apply", bn_train.bn_train,
        lambda terms, eps, residual=None, relu=True: (
            *terms[0][0].shape, len(terms), residual is not None)))
    backward = counting(
        "backward", bn_train.bn_train_backward,
        lambda dz, terms, eps, residual=None, relu=True, fma_mask=False,
        scale_grads=False: (*dz.shape, len(terms), residual is not None, fma_mask))
    for owner in (bn_train, fused_gemm_bn):
        monkeypatch.setattr(owner, "bn_train_backward", backward)
    _, variables, x, _ = setup
    (_, probs), _ = resnet50_fused_forward(
        _module(variables), torch.from_numpy(x), train=True, num_classes=CLASSES,
        dtype=torch.float32)
    probs.sum().backward()
    want = resnet_fused.bn_train_launches(BATCH, SIZE)
    for kind in calls:
        assert sorted(calls[kind]) == sorted(want[kind]), kind
    assert {k: len(v) for k, v in calls.items()} == {"moments": 28, "apply": 36,
                                                     "backward": 49}


def _eager_bn(terms, eps, *, residual=None, relu=True):
    """The fused step's BatchNorm as it was before ops/bn_train.py: the
    affine over the moments as autograd sees them, then multiply, add,
    residual and ReLU, each through autograd."""
    u = None
    for y, gamma, beta, mean, var in terms:
        scale, shift = bn_train.affine(gamma, beta, mean, var, eps)
        a = y.float() * scale + shift
        u = a if u is None else u + a
    if residual is not None:
        u = u + residual.float()
    return (torch.relu(u) if relu else u).to(terms[0][0].dtype)


def test_fused_step_gradients_match_the_eager_batchnorm_chain(setup, monkeypatch):
    """One backward of the fused step's loss against the same step with
    every BatchNorm on the eager chain (moments through autograd, the
    seams' moments folded into the fused GEMM's dΣ, dΣ²), float32 from
    the same start. The forwards are the same bits, so each parameter's
    gradient (the stem, the seams, the shortcuts, the residual closes,
    the convs on each side of a seam, the head) differs only by the
    closed form's order of summation: within 1e-4 of that leaf's largest
    value. The 53 conv biases have a zero derivative under training
    BatchNorm; on both sides they are rounding noise, held under 1e-5 of
    their conv weight's largest gradient.

    The plain module's step is no reference at 1e-4 here: its convs round
    otherwise, and at B=4 (stage 4 normalizes over 16 rows) a flipped
    ReLU mask moves a leaf's gradient by percents; on the chip the
    benchmark's ``grad_gap`` holds the fused step to it."""
    from sparkdl_torch.models import resnet_fused

    _, variables, x, _ = setup
    y = torch.from_numpy(np.random.default_rng(6).integers(0, CLASSES, BATCH))
    grads = {}
    for name in ("eager", "fused"):
        if name == "eager":
            real = fused_gemm_bn.conv1x1_bn_stats
            monkeypatch.setattr(resnet_fused, "bn_train", _eager_bn)
            monkeypatch.setattr(resnet_fused, "batch_moments",
                                bn_train.batch_moments_reference)
            monkeypatch.setattr(resnet_fused, "conv1x1_bn_stats",
                                lambda *a, x_moments=False, **k: real(*a, **k))
        module = _module(variables)
        loss, _ = resnet50_fused_loss_fn(module, num_classes=CLASSES,
                                         dtype=torch.float32)(torch.from_numpy(x), y)
        loss.backward()
        grads[name] = {n: p.grad for n, p in module.named_parameters()}
        monkeypatch.undo()
    assert set(grads["fused"]) == set(grads["eager"])
    for n, want in grads["eager"].items():
        got = grads["fused"][n]
        if n.startswith("conv") and n.endswith(".bias"):
            scale = float(grads["eager"][n[:-4] + "weight"].abs().max())
            assert max(float(got.abs().max()), float(want.abs().max())) <= 1e-5 * scale, n
        else:
            err = float((got - want).abs().max())
            assert err <= 1e-4 * float(want.abs().max()), (n, err)
