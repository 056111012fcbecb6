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
    (dict(tp=2), "A8 parallel"),
    (dict(sp=2), "A8 parallel"),
    (dict(pp=2), "A8 parallel"),
])
def test_unported_options_raise_naming_their_roadmap_item(start, kwargs, item):
    """mesh=, partitioner= and checkpoint_dir= are ported, and so is every
    mesh axis (the ROADMAP item these cases once raised, ``item``, is
    gone): a tp mesh needs a model built under it (a plain one raises),
    and a mesh over more ranks than the world a TorchRunner job
    (tests/test_torch_parallel_*.py run them)."""
    from sparkdl_torch.partition import MeshShapeError, make_mesh

    _, variables = start
    mesh = make_mesh(dp=1, devices=[0, 1], **kwargs)
    model = _port_model(variables)
    if "tp" in kwargs:
        with pytest.raises(ValueError, match="no tensor-parallel layer"):
            finetune_classifier(model, [], mesh=mesh)
        model = BertForSequenceClassification(
            BertConfig.tiny(vocab_size=VOCAB), device="cpu", mesh=mesh)
    with pytest.raises(MeshShapeError, match="TorchRunner") as err:
        finetune_classifier(model, [], mesh=mesh)
    assert item not in str(err.value)


@pytest.mark.parametrize("kwargs", [dict(input_prefetch=2),
                                    dict(input_prefetch=1, autotune=True),
                                    dict(autotune=True)])
def test_readahead_keeps_the_loss_history_bitwise(start, kwargs):
    """Input readahead through the ingest pipeline (a producer thread
    ahead of the step loop, the autotuner moving its depth) changes when
    batches are made, never which: the loss history is bitwise that of
    input_prefetch=0."""
    data, variables = start
    batches = list(batches_from_arrays(data, 16))
    _, want = finetune_classifier(_port_model(variables), batches,
                                  input_prefetch=0)
    _, got = finetune_classifier(_port_model(variables), iter(batches), **kwargs)
    assert [h["loss"] for h in got] == [h["loss"] for h in want]
    assert [h["step"] for h in got] == [1, 2, 3, 4]


def test_no_readahead_is_the_default(start):
    data, variables = start
    batches = list(batches_from_arrays(data, 16))
    _, a = finetune_classifier(_port_model(variables), batches, input_prefetch=None)
    _, b = finetune_classifier(_port_model(variables), batches, input_prefetch=0)
    assert [h["loss"] for h in a] == [h["loss"] for h in b]
    with pytest.raises(ValueError, match="chain_steps"):
        finetune_classifier(_port_model(variables), batches, chain_steps=0)


#: caller-supplied optimizers whose fresh state is not all zeros (NAdam's
#: mu_product starts at 1, a dampened SGD's momentum buffer at the first
#: gradient), and the default's class
_OPTIMIZERS = {
    "nadam": lambda ps: torch.optim.NAdam(ps, lr=1e-3),
    "sgd_dampened": lambda ps: torch.optim.SGD(ps, lr=0.05, momentum=0.9,
                                               dampening=0.5),
    "adamw": lambda ps: torch.optim.AdamW(ps, lr=1e-3, eps=1e-8),
}


def _by_hand(model, optimizer, batches):
    """The loss of each step a fresh ``optimizer`` takes, written out."""
    losses = []
    for b in batches:
        t = {k: torch.as_tensor(v) for k, v in b.items()}
        optimizer.zero_grad(set_to_none=True)
        logits = model(input_ids=t["input_ids"],
                       attention_mask=t["attention_mask"])
        loss = torch.nn.functional.cross_entropy(logits.float(),
                                                 t["labels"].long())
        loss.backward()
        optimizer.step()
        losses.append(float(loss))
    return losses


@pytest.mark.parametrize("name", sorted(_OPTIMIZERS))
def test_caller_optimizer_steps_from_its_fresh_state(start, name):
    """The loop makes no optimizer state ahead of the first step: a
    caller's optimizer takes exactly the steps it takes by hand (bitwise
    on the CPU, history and final weights)."""
    data, variables = start
    batches = list(batches_from_arrays(data, 16))
    ref = _port_model(variables)
    want = _by_hand(ref, _OPTIMIZERS[name](ref.parameters()), batches)
    model = _port_model(variables)
    _, got = finetune_classifier(
        model, batches, optimizer=_OPTIMIZERS[name](model.parameters()))
    assert [h["loss"] for h in got] == want
    assert all(torch.equal(p, q) for p, q in
               zip(model.parameters(), ref.parameters()))


@pytest.mark.parametrize("name", sorted(_OPTIMIZERS))
def test_caller_optimizer_resumes_bitwise(start, name, tmp_path):
    """A resumed run (a new model and optimizer, as a new process makes)
    restores the optimizer's whole state from the checkpoint: the steps
    after it are the uninterrupted run's, bitwise on the CPU."""
    data, variables = start
    batches = list(batches_from_arrays(data, 16))

    def run(stream, ckpt=None):
        m = _port_model(variables)
        _, hist = finetune_classifier(
            m, stream, optimizer=_OPTIMIZERS[name](m.parameters()),
            checkpoint_dir=ckpt, checkpoint_every=2)
        return m, [(h["step"], h["loss"]) for h in hist]

    ref, want = run(batches)
    run(batches[:2], str(tmp_path))  # saves step 2
    got_model, got = run(batches, str(tmp_path))
    assert got == want[2:]
    assert all(torch.equal(p, q) for p, q in
               zip(got_model.parameters(), ref.parameters()))
