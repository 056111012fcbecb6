"""The port's GPT (sparkdl_torch/models/gpt.py) against the JAX package's
(sparkdl_tpu/models/gpt.py) on ``GPTConfig.tiny``: the same Flax init
weights go to both through the weight bridge, the same numpy token ids
through both forwards.

Tolerances: logits within 1e-5 * max |ref| (float32 on both sides, two
layers; only summation orders differ, ~1e-7 relative). Greedy tokens are
identical. Where the JAX side reaches a Pallas kernel (attn_impl="flash"),
it runs in interpret mode; the port's wrappers run their plain versions on
CPU tensors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparkdl_tpu.models import gpt as jgpt
from sparkdl_torch.models import gpt as tgpt
from sparkdl_torch.models.convert import gpt_flax_to_torch, gpt_torch_to_flax
from torch_parity import gpt_pair, gpt_variables, left_pad

TOL = 1e-5
PROMPTS = [[5, 3, 9, 2, 7, 11, 4], [1, 4], [6, 8, 6, 8, 6]]
MAX_NEW = 6


def _close(got, want, tol=TOL):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= tol, err


@pytest.fixture(scope="module", params=["rope", "learned"])
def pair(request):
    return request.param, gpt_pair(seed=0, positions=request.param)


def _with_attn(module, **kw):
    """The same weights under another attention config."""
    cfg = tgpt.GPTConfig.tiny(positions=module.config.positions, **kw)
    m = tgpt.GPTLMHeadModel(cfg, device="cpu")
    m.load_state_dict(module.state_dict())
    return m.eval()


def test_weight_bridge_round_trip_and_errors():
    cfg = jgpt.GPTConfig.tiny(positions="learned")
    variables = gpt_variables(cfg)
    module = tgpt.GPTLMHeadModel(tgpt.GPTConfig.tiny(positions="learned"),
                                 device="cpu")
    sd = gpt_flax_to_torch(variables, module=module)
    module.load_state_dict(sd)
    back = gpt_torch_to_flax(module.state_dict())
    flat_a = jax.tree_util.tree_leaves_with_path(variables)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf)

    params = variables["params"]
    with pytest.raises(ValueError, match="unknown GPT parameter"):
        gpt_flax_to_torch({"params": {**params, "lm_head": {"kernel": 0}}})
    h0 = {**params["h_0"], "up": {"kernel": params["h_0"]["up"]["kernel"]}}
    with pytest.raises(ValueError, match="h_0/up: fields"):
        gpt_flax_to_torch({"params": {**params, "h_0": h0}})
    with pytest.raises(ValueError, match="collections"):
        gpt_flax_to_torch({**variables, "batch_stats": {}})
    rope = tgpt.GPTLMHeadModel(tgpt.GPTConfig.tiny(), device="cpu")
    with pytest.raises(ValueError, match="unexpected.*wpe"):
        gpt_flax_to_torch(variables, module=rope)


@pytest.mark.parametrize("attn_impl", ["full", "flash"])
def test_uncached_logits_match_jax(pair, attn_impl):
    positions, (jmodel, variables, module) = pair
    jcfg = jgpt.GPTConfig.tiny(positions=positions, attn_impl=attn_impl)
    ids = np.random.default_rng(1).integers(0, 128, (2, 12)).astype(np.int32)
    want, _ = jgpt.GPTLMHeadModel(jcfg).apply(variables, jnp.asarray(ids))
    with torch.no_grad():
        got, cache = _with_attn(module, attn_impl=attn_impl)(
            torch.from_numpy(ids).long())
    assert cache is None and got.dtype == torch.float32
    _close(got, want)


def test_uncached_attention_mask(pair):
    positions, (jmodel, variables, module) = pair
    ids = np.random.default_rng(2).integers(0, 128, (2, 9)).astype(np.int32)
    mask = np.ones((2, 9), bool)
    mask[1, :4] = False
    want, _ = jmodel.apply(variables, jnp.asarray(ids),
                           attention_mask=jnp.asarray(mask))
    with torch.no_grad():
        got, _ = module(torch.from_numpy(ids).long(),
                        attention_mask=torch.from_numpy(mask))
        _close(got, want)
        with pytest.raises(ValueError, match="requires attn_impl='full'"):
            _with_attn(module, attn_impl="flash")(
                torch.from_numpy(ids).long(),
                attention_mask=torch.from_numpy(mask))


@pytest.mark.parametrize("attn_impl,flash_decode", [
    ("full", False), ("flash", False), ("flash", True)])
def test_cached_prefill_and_decode_match_jax(pair, attn_impl, flash_decode):
    positions, (_, variables, module) = pair
    kw = dict(positions=positions, attn_impl=attn_impl,
              flash_decode=flash_decode)
    jmodel = jgpt.GPTLMHeadModel(jgpt.GPTConfig.tiny(**kw))
    tmodule = _with_attn(module, attn_impl=attn_impl,
                         flash_decode=flash_decode)
    ids, mask = left_pad(PROMPTS)
    b, lp = ids.shape
    max_len = lp + 4
    key_valid = np.concatenate([mask.astype(bool), np.ones((b, 4), bool)], 1)
    pos = np.clip(np.cumsum(mask, 1) - 1, 0, None)
    pad_len = lp - mask.sum(1)

    jcache = jgpt.init_cache(jmodel.config, b, max_len)
    tcache = tgpt.init_cache(tmodule.config, b, max_len, device="cpu")
    step = (ids, pos)
    for i in range(4):
        idx = tcache["idx"]
        want, jcache = jmodel.apply(
            variables, jnp.asarray(step[0]), cache=jcache,
            positions=jnp.asarray(step[1]),
            attention_mask=jnp.asarray(key_valid))
        with torch.no_grad():
            got, tcache = tmodule(
                torch.from_numpy(step[0]).long(), cache=tcache,
                positions=torch.from_numpy(step[1]).long(),
                attention_mask=torch.from_numpy(key_valid))
        # pad query rows see no valid key: finite, but the JAX kernel
        # averages them over its own key blocks, so compare real rows only
        real = key_valid[:, idx:idx + step[0].shape[1]]
        assert torch.isfinite(got).all()
        _close(got.numpy()[real], np.asarray(want)[real])
        assert tcache["idx"] == int(jcache["idx"]) == lp + i
        nxt = np.asarray(want[:, -1]).argmax(-1).astype(np.int32)[:, None]
        step = (nxt, (lp + i - pad_len)[:, None])
    written = key_valid[:, :lp + 3]
    np.testing.assert_allclose(tcache["k"][:, :, :lp + 3].numpy()[:, written],
                               np.asarray(jcache["k"])[:, :, :lp + 3][:, written],
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("attn_impl,flash_decode", [
    ("full", False), ("flash", False), ("flash", True)])
def test_ragged_greedy_generate_matches_jax(pair, attn_impl, flash_decode):
    positions, (_, variables, module) = pair
    kw = dict(positions=positions, attn_impl=attn_impl,
              flash_decode=flash_decode)
    jmodel = jgpt.GPTLMHeadModel(jgpt.GPTConfig.tiny(**kw))
    tmodule = _with_attn(module, attn_impl=attn_impl,
                         flash_decode=flash_decode)
    ids, mask = left_pad(PROMPTS)
    want = jgpt.generate(jmodel, variables, jnp.asarray(ids), MAX_NEW,
                         attention_mask=jnp.asarray(mask))
    got = tgpt.generate(tmodule, torch.from_numpy(ids).long(), MAX_NEW,
                        attention_mask=torch.from_numpy(mask))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for i, p in enumerate(PROMPTS):  # each row equals its unbatched decode
        solo = tgpt.generate(tmodule, torch.tensor([p]), MAX_NEW)
        np.testing.assert_array_equal(got[i, ids.shape[1]:].numpy(),
                                      solo[0, len(p):].numpy())


def test_hf_gpt2_weights():
    """load_hf_gpt2 on a locally built GPT2LMHeadModel: the port's logits
    equal HF's forward and the JAX package's load of the same model, and
    greedy tokens equal the JAX package's."""
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.GPT2Config(
        vocab_size=96, n_positions=32, n_embd=16, n_layer=2, n_head=2,
        resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0,
    )
    torch.manual_seed(0)
    hf = transformers.GPT2LMHeadModel(hf_cfg).eval()
    cfg, sd = tgpt.load_hf_gpt2(hf)
    assert cfg == tgpt.config_from_hf_gpt2(hf_cfg)
    assert cfg.positions == "learned" and cfg.num_layers == 2
    module = tgpt.GPTLMHeadModel(cfg, device="cpu")
    module.load_state_dict(sd)
    module.eval()

    ids = np.random.default_rng(3).integers(0, 96, (2, 10))
    with torch.no_grad():
        want = hf(torch.tensor(ids)).logits.numpy()
        got, _ = module(torch.tensor(ids))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4)
    jcfg, jvars = jgpt.load_hf_gpt2(hf)
    jmodel = jgpt.GPTLMHeadModel(jcfg)
    jlogits, _ = jmodel.apply(jvars, jnp.asarray(ids, jnp.int32))
    _close(got, jlogits)
    out = tgpt.generate(module, torch.tensor(ids[:, :4]), 4)
    jout = jgpt.generate(jmodel, jvars, jnp.asarray(ids[:, :4], jnp.int32), 4)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))

    with pytest.raises(ValueError, match="activation"):
        tgpt.config_from_hf_gpt2(transformers.GPT2Config(
            activation_function="relu"))


def test_sampling_is_seeded_and_truncation_matches_greedy(pair):
    _, (_, _, module) = pair
    ids = torch.tensor([[5, 3, 9], [1, 4, 2]])

    def sample(seed, **kw):
        g = torch.Generator().manual_seed(seed)
        return tgpt.generate(module, ids, 8, temperature=0.9, generator=g, **kw)

    a, b, c = sample(1), sample(1), sample(2)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    greedy = tgpt.generate(module, ids, 8)
    assert torch.equal(sample(3, top_k=1), greedy)
    assert torch.equal(sample(4, top_p=1e-6), greedy)
    assert torch.equal(sample(5, top_k=500), sample(5))  # clamped to the vocab


def test_generate_argument_errors():
    module = tgpt.GPTLMHeadModel(
        tgpt.GPTConfig.tiny(positions="learned", max_seq_len=16), device="cpu")
    ids = torch.tensor([[1, 2, 3]])
    with pytest.raises(ValueError, match="position table"):
        tgpt.generate(module, ids, 14)
    with pytest.raises(ValueError, match="max_len"):
        tgpt.generate(module, ids, 4, max_len=5)
    with pytest.raises(ValueError, match="requires a generator"):
        tgpt.generate(module, ids, 2, temperature=1.0)
    with pytest.raises(ValueError, match="only apply when sampling"):
        tgpt.generate(module, ids, 2, top_k=3)
    with pytest.raises(ValueError, match="top_p"):
        tgpt.generate(module, ids, 2, temperature=1.0, top_p=0.0,
                      generator=torch.Generator())
    with pytest.raises(ValueError, match="left-padded"):
        tgpt.generate(module, ids, 2, attention_mask=torch.tensor([[1, 1, 0]]))
    with pytest.raises(ValueError, match="shape"):
        tgpt.generate(module, ids, 2, attention_mask=torch.ones((1, 4)))
    assert torch.equal(tgpt.generate(module, ids, 0), ids)
    cache = tgpt.init_cache(module.config, 1, 4, device="cpu")
    with torch.no_grad():
        module(ids, cache=cache)
        with pytest.raises(ValueError, match="KV cache overflow"):
            module(torch.tensor([[1, 2]]), cache=cache)


def test_unported_options_raise_naming_their_roadmap_item():
    """Once deferrals (ROADMAP A8), now ported: ring attention, experts,
    sp_prefill and return_kv, each on a one-rank mesh where it needs one
    (tests/test_torch_parallel_*.py hold them to the JAX package across
    ranks)."""
    from sparkdl_torch.runtime.mesh import MeshSpec, mesh_context

    module = tgpt.init_gpt_(tgpt.GPTLMHeadModel(tgpt.GPTConfig.tiny(), device="cpu"))
    ids = torch.tensor([[1, 2, 3, 4]])
    with torch.no_grad():
        full = module(ids)[0]
        ring = tgpt.GPTLMHeadModel(tgpt.GPTConfig.tiny(attn_impl="ring"), device="cpu")
        ring.load_state_dict(module.state_dict())
        with pytest.raises(ValueError, match="unbound"):
            ring(ids)  # the ring needs a mesh, as the reference's a shard_map
        with mesh_context(MeshSpec(dp=1).build()):
            torch.testing.assert_close(ring(ids)[0], full, atol=1e-5, rtol=0)
        moe = tgpt.GPTLMHeadModel(tgpt.GPTConfig.tiny(num_experts=4), device="cpu")
        assert moe(ids)[0].shape == (1, 4, 128)
        with pytest.raises(ValueError, match="attn_impl='ring'"):
            tgpt.sp_prefill(module, ids, MeshSpec(dp=1).build())
        _, kv = module(torch.tensor([[1, 2]]), return_kv=True)
        assert kv["k"].shape == (2, 1, 2, 2, 16) and kv["idx"] == 2
    with pytest.raises(ValueError, match="sp_mode"):
        tgpt.GPTConfig.tiny(sp_mode="ringg")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tgpt.GPTLMHeadModel(tgpt.GPTConfig.tiny())  # the default is cuda


def test_init_gpt_follows_flax_defaults():
    """init_gpt_: per-tensor statistics of Flax's init (lecun-normal
    kernels, zero biases, unit LayerNorm scales, N(0, 1/hidden)
    embeddings), and the same weights for the same seed."""
    kw = dict(hidden_size=128, intermediate_size=512, vocab_size=512,
              max_seq_len=256, positions="learned")
    ref = gpt_flax_to_torch(gpt_variables(jgpt.GPTConfig.tiny(**kw), seed=0))
    cfg = tgpt.GPTConfig.tiny(**kw)
    a = tgpt.init_gpt_(tgpt.GPTLMHeadModel(cfg, device="cpu"), seed=0)
    b = tgpt.init_gpt_(tgpt.GPTLMHeadModel(cfg, device="cpu"), seed=0)
    c = tgpt.init_gpt_(tgpt.GPTLMHeadModel(cfg, device="cpu"), seed=1)
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert set(sa) == set(ref)
    for k, want in ref.items():
        got = sa[k]
        assert torch.equal(got, sb[k])
        if want.std() == 0:
            assert torch.equal(got, want)  # biases 0, LayerNorm scales 1
            continue
        assert not torch.equal(got, sc[k])
        assert abs(got.std() / want.std() - 1) < 0.1, k
        assert abs(got.abs().max() / want.abs().max() - 1) < 0.5, k
