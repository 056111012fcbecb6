"""The port's BERT (sparkdl_torch/models/bert.py) against the JAX package's
(sparkdl_tpu/models/bert.py) on the same weights, through the BERT weight
bridge, and against HF BertModel through load_hf_bert.

Tolerance 1e-5 x max|ref| for logits and hidden states (float32 on both
sides, only summation order differs), 1e-4 for parameter gradients (a
backward through two layers of float32), both attention paths ("full" and
"flash"; the JAX flash kernel in interpret mode).
"""

import dataclasses

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparkdl_tpu.models import bert as jbert
from sparkdl_torch.models import bert as tbert
from sparkdl_torch.models.convert import bert_flax_to_torch, bert_torch_to_flax

VOCAB = 64


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    return np.abs(got - want).max() / np.abs(want).max()


def _batch(seed=0, b=3, length=16):
    r = np.random.default_rng(seed)
    ids = r.integers(0, VOCAB, (b, length)).astype(np.int32)
    mask = np.ones((b, length), np.int32)
    mask[0, length // 2:] = 0  # a right-padded row
    return ids, mask


@pytest.fixture(scope="module")
def clf_variables():
    model = jbert.BertForSequenceClassification(jbert.BertConfig.tiny(vocab_size=VOCAB),
                                                num_labels=3)
    ids, mask = _batch()
    v = model.init(jax.random.PRNGKey(0), jnp.asarray(ids), jnp.asarray(mask))
    return jax.device_get(flax.core.meta.unbox(v))


def _port(attn_impl, variables):
    cfg = tbert.BertConfig.tiny(vocab_size=VOCAB, attn_impl=attn_impl)
    module = tbert.BertForSequenceClassification(cfg, num_labels=3, device="cpu")
    module.load_state_dict(bert_flax_to_torch(variables, module=module))
    return module


@pytest.mark.parametrize("attn_impl", ["full", "flash"])
def test_logits_and_grads_match_jax(clf_variables, attn_impl):
    jcfg = jbert.BertConfig.tiny(vocab_size=VOCAB, attn_impl=attn_impl)
    jmodel = jbert.BertForSequenceClassification(jcfg, num_labels=3)
    ids, mask = _batch(seed=1)
    labels = np.array([0, 2, 1])

    def jloss(params):
        logits = jmodel.apply(params, jnp.asarray(ids), jnp.asarray(mask))
        return -jnp.mean(jnp.take_along_axis(
            jax.nn.log_softmax(logits), jnp.asarray(labels)[:, None], 1)), logits

    (_, jlogits), jgrads = jax.value_and_grad(jloss, has_aux=True)(clf_variables)
    module = _port(attn_impl, clf_variables)
    logits = module(torch.from_numpy(ids), torch.from_numpy(mask))
    assert _rel(logits.detach().numpy(), jlogits) <= 1e-5
    torch.nn.functional.cross_entropy(logits, torch.from_numpy(labels)).backward()
    want = bert_flax_to_torch(jax.device_get(jgrads))  # grads in torch layout
    # a key bias's true gradient is 0 (softmax is shift-invariant): each
    # tensor's scale is floored at 1e-3 of the largest gradient
    floor = 1e-3 * max(float(g.abs().max()) for g in want.values())
    for name, p in module.named_parameters():
        err = float((p.grad - want[name]).abs().max())
        assert err <= 1e-4 * max(float(want[name].abs().max()), floor), name


def test_encoder_flash_equals_full_and_jax(clf_variables):
    ids, mask = _batch(seed=2)
    enc = {"params": clf_variables["params"]["bert"]}
    want, _ = jbert.BertModel(jbert.BertConfig.tiny(vocab_size=VOCAB)).apply(
        enc, jnp.asarray(ids), jnp.asarray(mask))
    for impl in ("full", "flash"):
        m = tbert.BertModel(tbert.BertConfig.tiny(vocab_size=VOCAB, attn_impl=impl),
                            device="cpu")
        m.load_state_dict(bert_flax_to_torch(enc, module=m))
        with torch.no_grad():
            seq, pooled = m(torch.from_numpy(ids), torch.from_numpy(mask))
        assert _rel(seq.numpy(), want) <= 1e-5, impl


def _tiny_hf(transformers, num_labels=None):
    hf_cfg = transformers.BertConfig(
        vocab_size=VOCAB, hidden_size=32, num_hidden_layers=2,
        num_attention_heads=2, intermediate_size=64, max_position_embeddings=64,
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    torch.manual_seed(0)
    if num_labels is None:
        return transformers.BertModel(hf_cfg).eval()
    hf_cfg.num_labels = num_labels
    return transformers.BertForSequenceClassification(hf_cfg).eval()


def test_load_hf_bert_matches_hf_and_jax():
    """load_hf_bert on locally built HF models: the port equals HF's own
    forward, and the JAX package's load of the same module."""
    transformers = pytest.importorskip("transformers")
    ids, mask = _batch(seed=3)
    hf = _tiny_hf(transformers)
    cfg, sd = tbert.load_hf_bert(hf)
    module = tbert.BertModel(cfg, device="cpu")
    module.load_state_dict(sd)
    with torch.no_grad():
        want = hf(input_ids=torch.from_numpy(ids).long(),
                  attention_mask=torch.from_numpy(mask).long())
        seq, pooled = module(torch.from_numpy(ids), torch.from_numpy(mask))
    assert _rel(seq.numpy(), want.last_hidden_state.numpy()) <= 1e-5
    assert _rel(pooled.numpy(), want.pooler_output.numpy()) <= 1e-5

    hf_clf = _tiny_hf(transformers, num_labels=3)
    cfg, sd = tbert.load_hf_bert(hf_clf)
    clf = tbert.BertForSequenceClassification(cfg, num_labels=3, device="cpu")
    clf.load_state_dict(sd)
    jcfg, jvars = jbert.load_hf_bert(hf_clf)
    jlogits = jbert.BertForSequenceClassification(jcfg, num_labels=3).apply(
        jvars, jnp.asarray(ids), jnp.asarray(mask))
    with torch.no_grad():
        hf_logits = hf_clf(input_ids=torch.from_numpy(ids).long(),
                           attention_mask=torch.from_numpy(mask).long()).logits
        logits = clf(torch.from_numpy(ids), torch.from_numpy(mask))
    assert _rel(logits.numpy(), hf_logits.numpy()) <= 1e-5
    assert _rel(logits.numpy(), jlogits) <= 1e-5
    assert dataclasses.asdict(cfg)["layer_norm_eps"] == jcfg.layer_norm_eps


def test_weight_bridge_round_trip_and_errors(clf_variables):
    module = _port("full", clf_variables)
    back = bert_torch_to_flax(module.state_dict())
    assert jax.tree.structure(back) == jax.tree.structure(clf_variables)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(clf_variables)):
        np.testing.assert_array_equal(a, b)
    bad = {"params": {**clf_variables["params"], "extra": {"kernel": np.zeros(2)}}}
    with pytest.raises(ValueError, match="unknown BERT parameter"):
        bert_flax_to_torch(bad)
    partial = {"params": {"classifier": clf_variables["params"]["classifier"]}}
    with pytest.raises(ValueError, match="missing"):
        bert_flax_to_torch(partial, module=module)
    broken = jax.tree.map(lambda a: a, clf_variables)
    del broken["params"]["classifier"]["bias"]
    with pytest.raises(ValueError, match="fields"):
        bert_flax_to_torch(broken)


def test_unported_options_raise_naming_their_roadmap_item():
    """Ring attention was a deferral (ROADMAP A8); ported, on a one-rank
    mesh it is the full path's attention (tests/test_torch_parallel_
    four_ranks.py holds it to the JAX package at sp = 4)."""
    from sparkdl_torch.runtime.mesh import MeshSpec

    full = tbert.init_bert_(tbert.BertModel(tbert.BertConfig.tiny(), device="cpu"))
    ring = tbert.BertModel(tbert.BertConfig.tiny(attn_impl="ring"), device="cpu",
                           mesh=MeshSpec(dp=1).build())
    ring.load_state_dict(full.state_dict())
    ids, mask = torch.tensor([[5, 6, 7, 8]]), torch.tensor([[1, 1, 1, 0]])
    with torch.no_grad():
        torch.testing.assert_close(ring(ids, mask)[0], full(ids, mask)[0],
                                   atol=1e-5, rtol=0)
    base = tbert.BertForSequenceClassification(
        tbert.BertConfig.tiny(hidden_dropout_prob=0.1), device="cpu")
    ids = torch.zeros((1, 4), dtype=torch.long)
    # dropout is ported: train=True draws masks, train=False does not
    g = torch.Generator().manual_seed(0)
    assert not torch.equal(base(ids, train=True, generator=g), base(ids))
    assert base(ids).shape == (1, 2)  # train=False: the JAX fine-tune forward
    no_dropout = tbert.BertForSequenceClassification(tbert.BertConfig.tiny(),
                                                     device="cpu")
    assert no_dropout(ids, train=True).shape == (1, 2)


def test_base_config_and_init_follow_flax():
    c = tbert.BertConfig.base()
    assert (c.vocab_size, c.hidden_size, c.num_hidden_layers, c.num_attention_heads,
            c.intermediate_size, c.layer_norm_eps) == (30522, 768, 12, 12, 3072, 1e-12)
    with torch.no_grad():
        m = tbert.init_bert_(tbert.BertForSequenceClassification(
            tbert.BertConfig.tiny(vocab_size=512, hidden_size=64), device="cpu"),
            seed=0)
    emb = m.bert.embeddings.word_embeddings.weight.detach()
    assert abs(float(emb.std()) - 64 ** -0.5) < 0.1 * 64 ** -0.5
    q = m.bert.layer[0].attention.query.requires_grad_(False)
    assert float(q.bias.abs().max()) == 0.0
    assert abs(float(q.weight.std()) - 64 ** -0.5) < 0.15 * 64 ** -0.5
    ln = m.bert.layer[0].output_LayerNorm.requires_grad_(False)
    assert float((ln.weight - 1).abs().max()) == 0.0
