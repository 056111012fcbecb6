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

    shapes = jax.eval_shape(
        InceptionV3(include_top=True).init, jax.random.PRNGKey(0),
        jnp.zeros((1, size, size, 3), jnp.float32))
    r = np.random.default_rng(seed)

    def draw(path, leaf):
        field, shape = path[-1].key, leaf.shape
        if field == "kernel":  # lecun-normal scale: std 1/sqrt(fan_in)
            std = 1.0 / np.sqrt(np.prod(shape[:-1]))
            return (r.standard_normal(shape) * std).astype(np.float32)
        if field == "var":
            return (0.5 + r.random(shape)).astype(np.float32)
        return (r.standard_normal(shape) * 0.1).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def without_top(variables):
    params = {k: v for k, v in variables["params"].items() if k != "dense000"}
    return {"params": params, "batch_stats": variables["batch_stats"]}


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
