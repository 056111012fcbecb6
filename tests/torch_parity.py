"""Shared helpers for the tests that hold sparkdl_torch against sparkdl_tpu:
the same numpy weights and inputs go to both packages, and outputs are
compared with a tolerance relative to the reference's largest value."""

import jax
import jax.numpy as jnp
import numpy as np

#: through the whole network: float32 on both sides, ~94 convs summed in
#: different orders (and BN folded into the weights on the port's fused
#: path) move the features by ~1e-6 relative
NET_TOL = 1e-4


def assert_close(got, want, tol=NET_TOL):
    """max |got - want| <= tol * max |want|."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = np.abs(want).max()
    assert scale > 0
    err = np.abs(got - want).max() / scale
    assert err <= tol, err


def inception_variables(seed=7, size=75):
    """Variables for the Flax InceptionV3 with its top, as numpy.

    The tree is exactly the module's ``init`` output at ``size`` x ``size``
    (traced with ``jax.eval_shape``: 1 s, where running the init takes
    25 s; parameters do not depend on the input size). Values are drawn
    from a numpy seed: lecun-normal-scaled kernels, and BatchNorm
    statistics and biases away from 0/1 so that the BN folds are exercised.
    """
    from sparkdl_tpu.models.inception import InceptionV3

    return zoo_variables(InceptionV3(include_top=True), seed, size)


def zoo_variables(model, seed, size, gamma=None):
    """A Flax zoo model's variable tree from ``jax.eval_shape`` of its
    init, with numpy values drawn from ``seed`` (see
    :func:`inception_variables`); ``gamma`` = (mean, std) draws the BN
    scales around ``mean`` instead of around 0."""
    import flax

    shapes = flax.core.meta.unbox(jax.eval_shape(
        model.init, jax.random.PRNGKey(0),
        jnp.zeros((1, size, size, 3), jnp.float32)))
    r = np.random.default_rng(seed)

    def draw(path, leaf):
        field, shape = path[-1].key, leaf.shape
        if field == "kernel":  # lecun-normal scale: std 1/sqrt(fan_in)
            std = 1.0 / np.sqrt(np.prod(shape[:-1]))
            return (r.standard_normal(shape) * std).astype(np.float32)
        if field == "var":
            return (0.5 + r.random(shape)).astype(np.float32)
        if field == "scale" and gamma is not None:
            return (gamma[0] + gamma[1] * r.standard_normal(shape)).astype(
                np.float32)
        return (r.standard_normal(shape) * 0.1).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def without_top(variables, head="dense000"):
    params = {k: v for k, v in variables["params"].items() if k != head}
    return {**variables, "params": params}


def to_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def torch_inception(variables, include_top):
    """The port's InceptionV3 on the CPU, loaded through the weight bridge."""
    from sparkdl_torch.models import convert
    from sparkdl_torch.models.inception import InceptionV3

    module = InceptionV3(include_top=include_top)
    sd = convert.flax_to_torch(
        variables if include_top else without_top(variables), module=module)
    module.load_state_dict(sd)
    return module.eval()


def gpt_variables(cfg, seed=0):
    """The JAX GPTLMHeadModel's init variables for ``cfg``, as a numpy tree
    (partitioning metadata unboxed)."""
    import flax

    from sparkdl_tpu.models.gpt import GPTLMHeadModel

    variables = GPTLMHeadModel(cfg).init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32))
    return jax.device_get(flax.core.meta.unbox(variables))


def gpt_pair(seed=0, **kw):
    """``GPTConfig.tiny(**kw)`` in both packages: (JAX model, its numpy
    variables, the port's module on the CPU loaded with the same weights
    through the weight bridge)."""
    from sparkdl_tpu.models import gpt as jgpt
    from sparkdl_torch.models import gpt as tgpt
    from sparkdl_torch.models.convert import gpt_flax_to_torch

    jcfg = jgpt.GPTConfig.tiny(**kw)
    variables = gpt_variables(jcfg, seed)
    module = tgpt.GPTLMHeadModel(tgpt.GPTConfig.tiny(**kw), device="cpu")
    module.load_state_dict(gpt_flax_to_torch(variables, module=module))
    return jgpt.GPTLMHeadModel(jcfg), variables, module.eval()


def left_pad(prompts):
    """Left-padded (ids, mask) numpy int32 arrays for ragged prompts."""
    lp = max(len(p) for p in prompts)
    ids = np.zeros((len(prompts), lp), np.int32)
    mask = np.zeros((len(prompts), lp), np.int32)
    for i, p in enumerate(prompts):
        ids[i, lp - len(p):] = p
        mask[i, lp - len(p):] = 1
    return ids, mask


# ---------------------------------------------------------------------------
# the image zoo: both packages' modules on the same weights
# ---------------------------------------------------------------------------

def zoo_jax_builder(name):
    from sparkdl_tpu.models.registry import get_entry

    return get_entry(name).flax_builder


def zoo_torch_module(name, variables, include_top):
    """The port's module for the zoo model ``name`` on the CPU, loaded
    with the Flax ``variables`` (the head dropped without the top)."""
    from sparkdl_torch.models import convert
    from sparkdl_torch.models.registry import get_entry

    module = get_entry(name).builder(include_top=include_top, num_classes=1000)
    if name == "ViTB16":
        v = variables if include_top else without_top(variables, "classifier")
        module.load_state_dict(convert.vit_flax_to_torch(v, module=module))
    else:
        head = "dense002" if name.startswith("VGG") else "dense000"
        v = variables if include_top else without_top(variables, head)
        module.load_state_dict(convert.flax_to_torch(v, module=module))
    return module.eval()


_SERVED = {}


def _served(name):
    """One model's numpy variables at a time (VGG19 alone is 0.57 GB)."""
    if name not in _SERVED:
        from sparkdl_torch.models.registry import get_entry

        _SERVED.clear()
        size = get_entry(name).input_size[0]
        _SERVED[name] = zoo_variables(zoo_jax_builder(name)(include_top=True), 8,
                                      size, gamma=(1.0, 0.1))
    return _SERVED[name]


def zoo_rows(size):
    """Three random image structs (one at another size, so the host resize
    runs) and one undefined row (id -1)."""
    from sparkdl_torch.image import imageArrayToStructBGR, undefined_image

    r = np.random.default_rng(size)
    shapes = [(size, size), (size - 40, size + 30), (size, size)]
    out = [{"id": i, "image": imageArrayToStructBGR(
        r.integers(0, 256, (h, w, 3), dtype=np.uint8), origin=f"img{i}")}
        for i, (h, w) in enumerate(shapes)]
    out.insert(1, {"id": -1, "image": undefined_image("broken")})
    return out


def named_image_parity(monkeypatch, name, cls_name, tol=NET_TOL):
    """``cls_name`` (DeepImageFeaturizer or DeepImagePredictor) of both
    packages over :func:`zoo_rows` at the model's input size, both
    loaders serving the same numpy weights; the port on the CPU over two
    partitions. Rows agree within ``tol`` and the undefined row is None."""
    from sparkdl_torch import LocalDataFrame
    from sparkdl_torch.models.registry import get_entry
    from sparkdl_torch.transformers import named_image as torch_ni
    from sparkdl_tpu.dataframe import LocalDataFrame as JaxFrame
    from sparkdl_tpu.transformers import named_image as jax_ni

    def jax_load(model_name, weights, include_top, weights_token=0.0):
        top = include_top or get_entry(model_name).features_need_top
        return (zoo_jax_builder(model_name)(include_top=top),
                to_jax(_served(model_name)))

    def torch_load(model_name, weights, include_top, device):
        assert device == "cpu"
        top = include_top or get_entry(model_name).features_need_top
        return zoo_torch_module(model_name, _served(model_name), top)

    entry = get_entry(name)
    rows = zoo_rows(entry.input_size[0])
    kw = dict(inputCol="image", outputCol="out", modelName=name, weights="random",
              batchSize=4)
    jax_ni._named_model_runner.cache_clear()
    torch_ni._named_model_runner.cache_clear()
    monkeypatch.setattr(jax_ni, "_load_named_model", jax_load)
    monkeypatch.setattr(torch_ni, "_load_named_model", torch_load)
    try:
        want = {r["id"]: r["out"] for r in getattr(jax_ni, cls_name)(**kw)
                .transform(JaxFrame.from_rows(rows, 1)).collect()}
        out = getattr(torch_ni, cls_name)(device="cpu", **kw).transform(
            LocalDataFrame.from_rows(rows, 2)).collect()
    finally:
        jax_ni._named_model_runner.cache_clear()
        torch_ni._named_model_runner.cache_clear()
    assert [r["id"] for r in out] == [r["id"] for r in rows]
    got = {r["id"]: r["out"] for r in out}
    assert got[-1] is None and want[-1] is None
    ids = [0, 1, 2]
    width = entry.feature_dim if cls_name == "DeepImageFeaturizer" else 1000
    assert all(got[i].dtype == np.float32 and got[i].shape == (width,) for i in ids)
    assert_close(np.stack([got[i] for i in ids]),
                 np.stack([np.asarray(want[i]) for i in ids]), tol)
