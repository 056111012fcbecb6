"""The port's fine-tune loop (sparkdl_torch/train/finetune.py) against the
JAX package's (sparkdl_tpu/train/finetune.py): tiny BERT, the same initial
weights (through the BERT weight bridge) and the same batches, AdamW in
both (torch.optim.AdamW against optax.adamw, the same update).

Tolerance on the loss history: 1e-3 relative per step. Both sides are
float32 but reduce in different orders (the JAX loop over its 8-device CPU
mesh), and AdamW's first steps divide each gradient by its own magnitude,
so entries whose gradient is rounding noise move by up to lr either way.
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparkdl_tpu.models.bert import BertConfig as JConfig
from sparkdl_tpu.models.bert import BertForSequenceClassification as JClf
from sparkdl_tpu.train.finetune import batches_from_arrays as jax_batches
from sparkdl_tpu.train.finetune import finetune_classifier as jax_finetune
from sparkdl_torch.models.bert import BertConfig, BertForSequenceClassification
from sparkdl_torch.models.convert import bert_flax_to_torch
from sparkdl_torch.train import finetune_classifier
from sparkdl_torch.train.finetune import batches_from_arrays

torch.set_num_threads(2)
VOCAB = 64


def _toy_task(n=64, length=12, seed=0):
    """Label = whether token 1 opens the sequence; the second half of the
    rows right-padded."""
    r = np.random.default_rng(seed)
    ids = r.integers(2, VOCAB, (n, length)).astype(np.int32)
    labels = r.integers(0, 2, n).astype(np.int32)
    ids[:, 0] = labels
    mask = np.ones((n, length), np.int32)
    mask[n // 2:, length - 3:] = 0
    return {"input_ids": ids, "attention_mask": mask, "labels": labels}


@pytest.fixture(scope="module")
def start():
    data = _toy_task()
    model = JClf(JConfig.tiny(vocab_size=VOCAB), num_labels=2)
    v = model.init(jax.random.PRNGKey(0), jnp.asarray(data["input_ids"][:2]),
                   jnp.asarray(data["attention_mask"][:2]))
    return data, jax.device_get(flax.core.meta.unbox(v))


def _port_model(variables, attn_impl="full"):
    m = BertForSequenceClassification(
        BertConfig.tiny(vocab_size=VOCAB, attn_impl=attn_impl), device="cpu")
    m.load_state_dict(bert_flax_to_torch(variables, module=m))
    return m


@pytest.mark.parametrize("attn_impl", ["full", "flash"])
def test_loss_history_matches_the_jax_loop(start, attn_impl):
    data, variables = start
    model = JClf(JConfig.tiny(vocab_size=VOCAB, attn_impl=attn_impl), num_labels=2)

    def apply_fn(params, input_ids, attention_mask):
        return model.apply(params, input_ids, attention_mask)

    batches = list(jax_batches(data, 16, epochs=2))
    _, want = jax_finetune(apply_fn, variables, batches, learning_rate=5e-4,
                           input_prefetch=0)
    seen = []
    port, got = finetune_classifier(_port_model(variables, attn_impl), batches,
                                    learning_rate=5e-4, metrics_cb=seen.append)
    assert [h["step"] for h in got] == list(range(1, len(batches) + 1))
    assert seen == got and isinstance(port, BertForSequenceClassification)
    assert all(h["step_time_s"] > 0 for h in got)
    w_loss = np.array([h["loss"] for h in want])
    g_loss = np.array([h["loss"] for h in got])
    np.testing.assert_allclose(g_loss, w_loss, rtol=1e-3)
    np.testing.assert_allclose([h["accuracy"] for h in got],
                               [h["accuracy"] for h in want])
    assert g_loss[-1] < g_loss[0]


def test_batches_match_the_jax_iterator():
    data = _toy_task(n=37)
    for drop in (True, False):
        a = list(batches_from_arrays(data, 8, epochs=2, seed=3, drop_remainder=drop))
        b = list(jax_batches(data, 8, epochs=2, seed=3, drop_remainder=drop))
        assert len(a) == len(b) == (8 if drop else 10)
        for x, y in zip(a, b):
            for k in data:
                np.testing.assert_array_equal(x[k], y[k])


def test_custom_optimizer_updates_in_place(start):
    data, variables = start
    model = _port_model(variables)
    before = model.classifier.weight.detach().clone()
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    same, history = finetune_classifier(model, batches_from_arrays(data, 16),
                                        optimizer=opt)
    assert same is model and len(history) == 4
    assert float((model.classifier.weight.detach() - before).abs().max()) > 0


@pytest.mark.parametrize("kwargs,item", [
    (dict(mesh=object()), "A8 partition"),
    (dict(partitioner=object()), "A8 partition"),
    (dict(checkpoint_dir="ckpt"), "A8 checkpoint"),
    (dict(chain_steps=4), "A4 CUDA graphs"),
    (dict(chain_steps=None), "A4 CUDA graphs"),
    (dict(input_prefetch=2), "A4 ingest"),
    (dict(autotune=True), "A4 ingest"),
])
def test_unported_options_raise_naming_their_roadmap_item(start, kwargs, item):
    _, variables = start
    with pytest.raises(NotImplementedError, match=item):
        finetune_classifier(_port_model(variables), [], **kwargs)


def test_no_readahead_is_the_default(start):
    data, variables = start
    batches = list(batches_from_arrays(data, 16))
    _, a = finetune_classifier(_port_model(variables), batches, input_prefetch=None)
    _, b = finetune_classifier(_port_model(variables), batches, input_prefetch=0)
    assert [h["loss"] for h in a] == [h["loss"] for h in b]
    with pytest.raises(ValueError, match="chain_steps"):
        finetune_classifier(_port_model(variables), batches, chain_steps=0)
