"""Dropout in the port's BERT and GPT (``train=True``) against the JAX
package's modules.

- At rate 0, ``train=True`` is the deterministic forward in both
  packages: logits within 1e-5 of JAX's on the same converted weights
  (float32, sums reordered).
- At rate p > 0 the kept fraction is within 1% of 1 - p over 1M draws
  (the binomial standard deviation there is 0.03%), every kept value is
  x / (1 - p) exactly as Flax scales it, the same generator seed gives
  the same bits, and ``train=False`` is bitwise the eval forward.
- The flash path skips attention-probs dropout and warns with the
  reference's message; GPT's train mode likewise at its sites.
"""

import warnings

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparkdl_torch.models.bert import (
    BertConfig,
    BertForSequenceClassification,
    Dropout,
)
from sparkdl_torch.models.convert import bert_flax_to_torch
from sparkdl_tpu.models.bert import BertConfig as JConfig
from sparkdl_tpu.models.bert import BertForSequenceClassification as JClf

TOL = 1e-5


def _ids(seed=0, b=3, length=10):
    r = np.random.default_rng(seed)
    ids = r.integers(0, 100, (b, length)).astype(np.int32)
    mask = np.ones((b, length), np.int32)
    mask[-1, length - 4:] = 0
    return ids, mask


@pytest.fixture(scope="module")
def bert_pair():
    ids, mask = _ids()
    jmodel = JClf(JConfig.tiny(), num_labels=2)
    v = jax.device_get(flax.core.meta.unbox(jmodel.init(
        jax.random.PRNGKey(0), jnp.asarray(ids), jnp.asarray(mask))))

    def port(**kw):
        m = BertForSequenceClassification(BertConfig.tiny(**kw), device="cpu")
        m.load_state_dict(bert_flax_to_torch(v, module=m))
        return m

    return jmodel, v, port


def test_rate_zero_train_forward_matches_jax(bert_pair):
    jmodel, v, port = bert_pair
    ids, mask = _ids()
    want = np.asarray(jmodel.apply(v, jnp.asarray(ids), jnp.asarray(mask),
                                   train=True))
    got = port()(torch.from_numpy(ids).long(), torch.from_numpy(mask),
                 train=True).detach().numpy()
    np.testing.assert_allclose(got, want, atol=TOL * np.abs(want).max())


def test_kept_fraction_scale_and_seeded_bits():
    p = 0.1
    drop = Dropout(p)
    x = torch.rand(1_000_000) + 0.5
    out = drop(x, train=True, generator=torch.Generator().manual_seed(3))
    kept = out != 0
    assert abs(float(kept.float().mean()) - (1 - p)) < 0.01
    assert torch.equal(out[kept], x[kept] / (1 - p))
    again = drop(x, train=True, generator=torch.Generator().manual_seed(3))
    other = drop(x, train=True, generator=torch.Generator().manual_seed(4))
    assert torch.equal(out, again) and not torch.equal(out, other)
    assert drop(x) is x and Dropout(0.0)(x, train=True) is x


def test_bert_train_mode_bits_and_eval_identity(bert_pair):
    _, _, port = bert_pair
    ids, mask = _ids()
    ids, mask = torch.from_numpy(ids).long(), torch.from_numpy(mask)
    m = port(hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1)
    a = m(ids, mask, train=True, generator=torch.Generator().manual_seed(0))
    b = m(ids, mask, train=True, generator=torch.Generator().manual_seed(0))
    c = m(ids, mask, train=True, generator=torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(m(ids, mask, train=False), port()(ids, mask))
    # gradients flow through the kept units
    m(ids, mask, train=True).sum().backward()
    assert m.bert.embeddings.word_embeddings.weight.grad.abs().sum() > 0


def test_flash_path_warns_as_the_reference_and_skips_probs_dropout(bert_pair):
    jmodel, v, port = bert_pair
    ids, mask = _ids()
    m = port(attn_impl="flash", attention_probs_dropout_prob=0.1,
             hidden_dropout_prob=0.0)
    with pytest.warns(UserWarning, match="skips attention-probs dropout") as got:
        m(torch.from_numpy(ids).long(), torch.from_numpy(mask), train=True)
    jflash = JClf(JConfig.tiny(attn_impl="flash",
                               attention_probs_dropout_prob=0.1,
                               hidden_dropout_prob=0.0), num_labels=2)
    with pytest.warns(UserWarning) as want:
        jflash.apply(v, jnp.asarray(ids), jnp.asarray(mask), train=True,
                     rngs={"dropout": jax.random.PRNGKey(0)})
    assert str(got[0].message) == str(want[0].message)
    # no probs dropout, no hidden dropout: the eval forward's logits
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        out = m(torch.from_numpy(ids).long(), torch.from_numpy(mask), train=True)
    assert torch.equal(out, m(torch.from_numpy(ids).long(),
                              torch.from_numpy(mask)))


def test_gpt_train_mode():
    from torch_parity import gpt_pair

    from sparkdl_torch.models import gpt as tgpt

    jmodel, variables, module = gpt_pair()
    ids = np.random.default_rng(1).integers(0, 100, (2, 12)).astype(np.int32)
    t_ids = torch.from_numpy(ids).long()
    want, _ = jmodel.apply(variables, jnp.asarray(ids), train=True)
    got, _ = module(t_ids, train=True)  # dropout 0.0: deterministic
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want,
                               atol=TOL * np.abs(want).max())
    m = tgpt.GPTLMHeadModel(tgpt.GPTConfig.tiny(dropout=0.1), device="cpu")
    m.load_state_dict(module.state_dict())
    a, _ = m(t_ids, train=True, generator=torch.Generator().manual_seed(0))
    b, _ = m(t_ids, train=True, generator=torch.Generator().manual_seed(0))
    c, _ = m(t_ids, train=True, generator=torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(m(t_ids)[0], module(t_ids)[0])
