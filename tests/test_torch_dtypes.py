"""The port's dtype policy (sparkdl_torch/runtime/dtypes.py) and the zoo's
compute ``dtype`` against the JAX package's.

- ``DtypePolicy``/``default_policy``/``FLOAT32`` behave as the reference's
  (the accelerator is ``"cuda"`` where the reference says ``"tpu"``).
- bfloat16 InceptionV3, as the module and as the branch-merged forward
  (the stem's plain version on the CPU), and a 2-layer bfloat16 ViT equal
  the JAX bfloat16 modules on the same numpy weights and inputs.
  Tolerance: max |diff| <= 2^-5 * max |ref|. Both sides round every
  activation and conv/dense operand to bfloat16 (8 significant bits,
  2^-9 relative each), but at different points: the port folds BN into
  the fused forward's weights before rounding them, the reference rounds
  the BN constants apart, and the CPU convolutions accumulate in other
  orders; over ~94 convs the features of the two move by ~2^-7.
- The float32 paths run no cast at all (every ``.to(float32)`` is the
  tensor itself), so they compute exactly the ops they did before the
  dtype existed: the featurizer keeps its bits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch_parity import (
    assert_close,
    inception_variables,
    to_jax,
    torch_inception,
    without_top,
)

from sparkdl_torch.runtime import FLOAT32, DtypePolicy, default_policy

BF16_TOL = 2.0 ** -5
SIZE = 75


def test_policy_matches_the_reference():
    from sparkdl_tpu.runtime import dtypes as jd

    assert DtypePolicy() == DtypePolicy(torch.float32, torch.bfloat16, torch.float32)
    for ours, theirs in ((DtypePolicy(), jd.DtypePolicy()), (FLOAT32, jd.FLOAT32),
                         (default_policy("cuda"), jd.default_policy("tpu")),
                         (default_policy("cpu"), jd.default_policy("cpu"))):
        for field in ("param_dtype", "compute_dtype", "output_dtype"):
            assert str(getattr(ours, field)).split(".")[-1] == \
                jnp.dtype(getattr(theirs, field)).name
    assert default_policy().compute_dtype == torch.float32  # no CUDA here


def test_policy_casts_floating_leaves_only():
    from sparkdl_tpu.runtime import dtypes as jd

    r = np.random.default_rng(0)
    tree = {"x": r.standard_normal((2, 3)).astype(np.float32),
            "ids": np.arange(4, dtype=np.int32),
            "pair": (r.standard_normal(2).astype(np.float32), np.ones(2, np.int64))}
    ours = DtypePolicy().cast_inputs(
        {"x": torch.from_numpy(tree["x"]), "ids": torch.from_numpy(tree["ids"]),
         "pair": tuple(torch.from_numpy(a) for a in tree["pair"])})
    theirs = jd.DtypePolicy().cast_inputs(jax.tree_util.tree_map(jnp.asarray, tree))
    assert ours["x"].dtype == torch.bfloat16 and theirs["x"].dtype == jnp.bfloat16
    assert ours["ids"].dtype == torch.int32 and theirs["ids"].dtype == jnp.int32
    assert isinstance(ours["pair"], tuple) and ours["pair"][1].dtype == torch.int64
    np.testing.assert_array_equal(ours["x"].float().numpy(),
                                  np.asarray(theirs["x"].astype(jnp.float32)))
    back = DtypePolicy().cast_outputs(ours)
    assert back["x"].dtype == torch.float32 and back["ids"].dtype == torch.int32
    assert FLOAT32.cast_inputs(ours["pair"][0]).dtype == torch.float32


@pytest.fixture(scope="module")
def variables():
    return inception_variables(seed=5, size=SIZE)


@pytest.fixture(scope="module")
def pixels():
    return np.random.default_rng(9).integers(0, 256, (2, SIZE, SIZE, 3)).astype(np.float32)


def test_bf16_inception_module_matches_jax(variables, pixels):
    from sparkdl_tpu.models.inception import InceptionV3

    x = pixels / 127.5 - 1.0
    want_f, want_p = InceptionV3(include_top=True, dtype=jnp.bfloat16).apply(
        to_jax(variables), jnp.asarray(x), train=False)
    module = torch_inception(variables, include_top=True)
    module.dtype = torch.bfloat16
    with torch.inference_mode():
        got_f, got_p = module(torch.from_numpy(x))
    assert got_f.dtype == torch.bfloat16 and want_f.dtype == jnp.bfloat16
    assert all(p.dtype == torch.float32 for p in module.parameters())
    assert_close(got_f.float().numpy(), np.asarray(want_f.astype(jnp.float32)), BF16_TOL)
    assert_close(got_p.float().numpy(), np.asarray(want_p.astype(jnp.float32)), BF16_TOL)


def test_bf16_fused_inception_matches_jax(variables, pixels):
    """Raw pixels through both packages' folded, branch-merged forwards at
    their default dtype, bfloat16; the port's stem is the kernel's plain
    version here (CPU tensors), writing bfloat16."""
    from sparkdl_torch.models.inception_fused import (
        _CAST,
        fused_inception_v3_features,
        prepare_fused_inception_v3,
    )
    from sparkdl_torch.ops.fold import fold_tf_preprocess
    from sparkdl_tpu.models.inception_fused import (
        fused_inception_v3_features as jax_fused,
    )
    from sparkdl_tpu.ops.fold import fold_tf_preprocess as jax_fold_tf

    jvars = jax_fold_tf(to_jax(without_top(variables)))
    want = jax_fused(jvars, jnp.asarray(pixels))
    params = prepare_fused_inception_v3(fold_tf_preprocess(
        torch_inception(variables, include_top=False).state_dict()))
    with torch.inference_mode():
        got = fused_inception_v3_features(params, torch.from_numpy(pixels))
        f32 = fused_inception_v3_features(params, torch.from_numpy(pixels),
                                          dtype=torch.float32)
    assert got.dtype == torch.float32 and got.shape == (2, 2048)
    assert_close(got.numpy(), np.asarray(want), BF16_TOL)
    # cast once and kept beside the parameters, which stay as prepared
    assert set(_CAST[params["convs"][3][0]]) == {torch.bfloat16}
    assert set(params) == {"stem", "convs", "merged"}
    assert_close(got.numpy(), f32.numpy(), BF16_TOL)


@pytest.mark.parametrize("attn_impl", ["full", "flash"])
def test_bf16_vit_matches_jax(attn_impl):
    import flax

    from sparkdl_torch.models import vit as tvit
    from sparkdl_torch.models.convert import vit_flax_to_torch
    from sparkdl_tpu.models import vit as jvit

    jmodel = jvit.ViTModel(config=jvit.ViTConfig.tiny(attn_impl=attn_impl),
                           num_classes=5, dtype=jnp.bfloat16)
    x = np.random.default_rng(3).standard_normal((3, 32, 32, 3)).astype(np.float32)
    v = jax.device_get(flax.core.meta.unbox(jmodel.init(jax.random.PRNGKey(0), x)))
    v["params"]["cls_token"] = np.random.default_rng(4).standard_normal(
        (1, 1, 32)).astype(np.float32)
    want_f, want_p = jmodel.apply(v, x)
    module = tvit.ViTModel(tvit.ViTConfig.tiny(attn_impl=attn_impl), num_classes=5,
                           dtype=torch.bfloat16)
    module.load_state_dict(vit_flax_to_torch(v, module=module))
    assert module.config.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in module.parameters())
    with torch.inference_mode():
        got_f, got_p = module.eval()(torch.from_numpy(x))
    assert got_f.dtype == torch.float32 and got_p.dtype == torch.float32
    assert_close(got_f.numpy(), np.asarray(want_f), BF16_TOL)
    assert_close(got_p.numpy(), np.asarray(want_p), BF16_TOL)


class _Casts(TorchDispatchMode):
    """Records every conversion dispatched that makes a new tensor (a
    ``.to`` to the tensor's own dtype returns the tensor itself)."""

    def __init__(self):
        super().__init__()
        self.casts = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if (func.overloadpacket in (torch.ops.aten._to_copy, torch.ops.aten.to)
                and out is not args[0]):
            self.casts.append(str(func))
        return out


@pytest.mark.parametrize("name", ["InceptionV3", "Xception", "ResNet50", "VGG16", "ViTB16"])
def test_float32_zoo_runs_no_cast(name):
    """Every zoo module at its default dtype, float32, and the featurizer's
    fused float32 forward dispatch no dtype conversion: they run exactly
    the float32 ops they ran before the compute dtype existed."""
    from sparkdl_torch.models.registry import build_torch_model

    size = {"InceptionV3": SIZE, "Xception": 71, "ResNet50": 32, "VGG16": 224}.get(name)
    if name == "ViTB16":
        from sparkdl_torch.models.vit import ViTConfig, ViTModel

        module, size = ViTModel(ViTConfig.tiny(), num_classes=3).eval(), 32
    elif name == "VGG16":
        from sparkdl_torch.models.vgg import VGG16

        module = VGG16(include_top=False).eval()  # torch's init: no VGG-sized trunc-normal
    else:
        module = build_torch_model(name, "random", include_top=True, device="cpu")
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (1, size, size, 3)).astype(np.float32))
    mode = _Casts()
    with torch.inference_mode(), mode:
        module(x)
    assert mode.casts == []
    if name == "InceptionV3":
        from sparkdl_torch.models.inception_fused import (
            _CAST,
            fused_inception_v3_features,
            prepare_fused_inception_v3,
        )

        params = prepare_fused_inception_v3(module.state_dict())
        x = torch.from_numpy(np.random.default_rng(2).integers(
            0, 256, (1, SIZE, SIZE, 3)).astype(np.float32))
        with torch.inference_mode(), mode:
            fused_inception_v3_features(params, x, dtype=torch.float32)
        assert mode.casts == [] and params["convs"][3][0] not in _CAST


def test_registry_passes_dtype():
    from sparkdl_torch.models.registry import build_torch_model

    m = build_torch_model("Xception", "random", torch.bfloat16, include_top=False,
                          device="cpu")
    assert m.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in m.parameters())
    f, _ = m(torch.zeros(1, 71, 71, 3))
    assert f.dtype == torch.bfloat16 and f.shape == (1, 2048)
    assert build_torch_model("Xception", "random", include_top=False,
                             device="cpu").dtype == torch.float32
