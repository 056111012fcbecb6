"""The port's BatchNorm-in-training op (sparkdl_torch/ops/bn_train.py) on
its plain path, against the eager chain the fused ResNet50 step ran before
it (moments, affine, multiply, add, residual, ReLU, through autograd) and
against the JAX package's Flax ``nn.BatchNorm`` (training, biased
moments), at that package's tolerances (tests/ops/test_fused_gemm_bn.py):
forward 1e-5; gradients of input, gamma, beta and the residual 1e-3;
bfloat16 3e-2.

The eager chain is a reference in float32 only: in bfloat16 it rounds
every multiply and add to bfloat16 (a ReLU mask that flips on a rounded
sum moved a shortcut case's input gradient by 0.2 of its largest, where
the op, in float32 throughout, stays within 2.3e-2 of Flax).

Cases: float32 and bfloat16; one BatchNorm, with a residual, or with a
second (the shortcut's) added; ReLU or none; moments computed
(``batch_moments``) or given by the fused GEMM that made y; and the
seam, the BatchNorm applied in the fused GEMM's operand load
(``conv1x1_bn_stats(prev_bn=..., x_moments=True)``).

On CPU tensors the op runs its plain version; the CUDA kernels are held
against it on the card by chip_smoke.py.
"""

from types import SimpleNamespace

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparkdl_torch.models.common import bn_moments, bn_scale_shift
from sparkdl_torch.ops import bn_train as tbn
from sparkdl_torch.ops import fused_gemm_bn as tfg

EPS = 1.001e-5
M, K, C = 48, 16, 24  # rows, the GEMM's input channels, BatchNorm channels


def _flax_bn(y, gamma, beta):
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.99, epsilon=EPS)
    variables = {"params": {"scale": gamma, "bias": beta},
                 "batch_stats": {"mean": jnp.zeros(C), "var": jnp.ones(C)}}
    return bn.apply(variables, y, mutable=["batch_stats"])[0]


def _data(seed):
    r = np.random.default_rng(seed)
    f = lambda *s, sc=1.0, sh=0.0: (r.standard_normal(s) * sc + sh).astype(np.float32)  # noqa: E731
    return {"x0": f(M, K, sc=1.5, sh=0.3), "w0": f(K, C, sc=0.3), "y": f(M, C, sc=1.7, sh=0.4),
            "x1": f(M, K, sc=1.1, sh=-0.2), "w1": f(K, C, sc=0.3), "y1": f(M, C, sh=-0.3),
            "r": f(M, C), "gamma": f(C, sc=0.3, sh=1.0), "beta": f(C, sc=0.2),
            "gamma1": f(C, sc=0.3, sh=0.8), "beta1": f(C, sc=0.2), "w": f(C, K, sc=0.3),
            "cot": f(M, C)}


def _round(a, dtype):
    """numpy float32 values as ``dtype`` would hold them."""
    return torch.from_numpy(a).to(dtype).float().numpy()


def _jax_loss(d, add, relu, given):
    """The loss over Flax's BatchNorm in float32; its leaves are the
    tensors the torch side differentiates."""
    cot = jnp.asarray(d["cot"])

    def act(u):
        return jax.nn.relu(u) if relu else u

    def y_of(p, i=""):  # given: made by the GEMM, whose input and weights are leaves
        return p["x" + (i or "0")] @ p["w" + (i or "0")] if given else p["y" + i]

    def loss(p):
        if add == "seam":
            out = act(_flax_bn(y_of(p), p["gamma"], p["beta"])) @ p["w"]
            return jnp.sum(out * cot[:, :K])
        u = _flax_bn(y_of(p), p["gamma"], p["beta"])
        if add == "residual":
            u = u + p["r"]
        elif add == "shortcut":
            u = u + _flax_bn(y_of(p, "1"), p["gamma1"], p["beta1"])
        return jnp.sum(act(u) * cot)

    return loss


def _leaves(add, given):
    names = ["x0", "w0"] if given else ["y"]
    if add == "shortcut":
        names += ["x1", "w1"] if given else ["y1"]
    names += ["gamma", "beta"]
    if add == "residual":
        names.append("r")
    elif add == "shortcut":
        names += ["gamma1", "beta1"]
    elif add == "seam":
        names.append("w")
    return names


def _torch_loss(t, d, add, relu, given, dtype, today):
    """The same loss through the port: ``today`` the eager chain (moments
    through autograd, plain multiply and add), else ``bn_train`` (or, at
    the seam, the GEMM with ``x_moments``)."""
    cot = torch.from_numpy(d["cot"])

    def y_moments(i=""):
        if given:
            y, mean, var = tfg.conv1x1_bn_stats(t["x" + (i or "0")].to(dtype)[None, None],
                                                t["w" + (i or "0")].to(dtype))
            y = y[0, 0]
        else:
            y = t["y" + i].to(dtype)
            mean, var = bn_moments(y, (0,)) if today else tbn.batch_moments(y)
        return y, mean, var

    def gb(i=""):
        return t["gamma" + i], t["beta" + i]

    y, mean, var = y_moments()
    if add == "seam":
        w = t["w"].to(dtype)
        out, _, _ = tfg.conv1x1_bn_stats(
            y[None, None], w, prev_bn=(mean, var, *gb(), EPS), relu_in=relu,
            x_moments=not today)
        return (out[0, 0].float() * cot[:, :K]).sum(), out
    if today:
        scale, shift = bn_scale_shift(SimpleNamespace(weight=t["gamma"], bias=t["beta"],
                                                      eps=EPS), mean, var)
        u = y * scale.to(dtype) + shift.to(dtype)
        if add == "residual":
            u = u + t["r"].to(dtype)
        elif add == "shortcut":
            y1, m1, v1 = y_moments("1")
            s1, h1 = bn_scale_shift(SimpleNamespace(weight=t["gamma1"], bias=t["beta1"],
                                                    eps=EPS), m1, v1)
            u = u + (y1 * s1.to(dtype) + h1.to(dtype))
        z = (torch.relu(u) if relu else u).to(dtype)
    else:
        terms = [(y, *gb(), mean, var)]
        if add == "shortcut":
            y1, m1, v1 = y_moments("1")
            terms.append((y1, *gb("1"), m1, v1))
        z = tbn.bn_train(terms, EPS, relu=relu,
                         residual=t["r"].to(dtype) if add == "residual" else None)
    return (z.float() * cot).sum(), z


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("add", [None, "residual", "shortcut", "seam"])
@pytest.mark.parametrize("relu", [True, False], ids=["relu", "linear"])
@pytest.mark.parametrize("given", [False, True], ids=["computed", "gemm"])
def test_bn_train_matches_flax_and_the_eager_chain(dtype, add, relu, given):
    d = _data(7)
    names = _leaves(add, given)
    runs = {}
    for today in (True, False):
        t = {n: torch.tensor(_round(a, dtype) if n not in ("gamma", "beta", "gamma1", "beta1")
                             else a) for n, a in d.items()}
        for n in names:
            t[n].requires_grad_(True)
        loss, out = _torch_loss(t, d, add, relu, given, dtype, today)
        loss.backward()
        assert out.dtype == dtype
        runs[today] = (out.detach().float().numpy(), [t[n].grad.numpy() for n in names])
    want_grads = jax.grad(_jax_loss(d, add, relu, given))(
        {n: jnp.asarray(_round(a, dtype) if n not in ("gamma", "beta", "gamma1", "beta1")
                        else a) for n, a in d.items()})
    tol = 1e-3 if dtype == torch.float32 else 3e-2
    (z_today, g_today), (z, g) = runs[True], runs[False]
    if add != "seam":  # the forward against Flax's
        p = {n: jnp.asarray(_round(a, dtype)) for n, a in d.items()}
        yj = p["x0"] @ p["w0"] if given else p["y"]
        u = _flax_bn(yj, jnp.asarray(d["gamma"]), jnp.asarray(d["beta"]))
        if add == "residual":
            u = u + p["r"]
        elif add == "shortcut":
            u = u + _flax_bn(p["x1"] @ p["w1"] if given else p["y1"],
                             jnp.asarray(d["gamma1"]), jnp.asarray(d["beta1"]))
        u = jax.nn.relu(u) if relu else u
        np.testing.assert_allclose(z, np.asarray(u), atol=1e-5 if tol == 1e-3 else tol,
                                   rtol=1e-5 if tol == 1e-3 else tol)
    if dtype == torch.float32:  # the eager chain's forward, bit for bit
        np.testing.assert_array_equal(z, z_today)
    # gradients in units of the larger of 1 and the reference's largest
    # (a bfloat16 GEMM's wgrad sums M products of size ~1: its rounding
    # scales with the sum, not with each element)
    for n, a, b, w_ in zip(names, g, g_today, (np.asarray(want_grads[n]) for n in names)):
        refs = [(w_, "Flax")]
        if dtype == torch.float32:  # in bfloat16 the chain rounds each op
            refs.append((b, "the eager chain"))
        for ref, who in refs:
            unit = max(1.0, float(np.abs(ref).max()))
            np.testing.assert_allclose(a / unit, ref / unit, atol=tol, rtol=tol,
                                       err_msg=f"{n} vs {who}")
