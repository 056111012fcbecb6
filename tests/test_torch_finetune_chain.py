"""The port's chained fine-tune loop (``finetune_classifier(chain_steps=K)``
over ``runtime/dispatch.py::chain_carry``), after the JAX package's suite
(tests/train/test_finetune_chain.py): K chained optimizer steps equal K
single-step dispatches exactly — same parameters, same per-step
loss/accuracy trajectory — while the host sees K-fold fewer dispatches.
On the CPU a chain is a plain loop over the eager step; the CUDA graphs
that carry it on the card are checked by chip_smoke.py. The checkpoint
cases of the reference's suite belong to ROADMAP A8 and are not here.

Against the JAX package, on a tiny MLP and on the tiny BERT, the
trajectories agree within the tolerances of test_torch_finetune.py
(loss 1e-3 relative per step, accuracy equal): both sides are float32
but reduce in different orders.
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparkdl_torch.runtime import dispatch as port_dispatch
from sparkdl_torch.runtime.dispatch import dispatch_count
from sparkdl_torch.train import finetune_classifier
from sparkdl_torch.train.finetune import batches_from_arrays
from sparkdl_tpu.models.bert import BertConfig as JConfig
from sparkdl_tpu.models.bert import BertForSequenceClassification as JClf
from sparkdl_tpu.train.finetune import batches_from_arrays as jax_batches
from sparkdl_tpu.train.finetune import finetune_classifier as jax_finetune
from test_torch_finetune import VOCAB, _port_model, _toy_task

DIM, CLASSES = 8, 4


class _MLP(torch.nn.Module):
    """The reference suite's ``tanh(x @ w1) @ w2``."""

    def __init__(self, params):
        super().__init__()
        self.w1 = torch.nn.Parameter(torch.from_numpy(params["w1"]).clone())
        self.w2 = torch.nn.Parameter(torch.from_numpy(params["w2"]).clone())

    def forward(self, x):
        return torch.tanh(x @ self.w1) @ self.w2


def _mlp_apply(params, x):
    return jnp.tanh(x @ params["w1"]) @ params["w2"]


def _setup(n=64, seed=0):
    rng = np.random.default_rng(seed)
    params = {
        "w1": rng.standard_normal((DIM, 16)).astype(np.float32) / 4,
        "w2": rng.standard_normal((16, CLASSES)).astype(np.float32) / 4,
    }
    data = {
        "x": rng.standard_normal((n, DIM)).astype(np.float32),
        "labels": rng.integers(0, CLASSES, n).astype(np.int32),
    }
    return params, data


def _run(params, batches, **kwargs):
    model = _MLP(params)
    _, history = finetune_classifier(model, batches, learning_rate=1e-2,
                                     input_prefetch=0, **kwargs)
    return model, history


def _assert_same_run(ref, got):
    (m_ref, h_ref), (m_got, h_got) = ref, got
    assert len(h_got) == len(h_ref)
    for a, b in zip(h_ref, h_got):
        assert a["step"] == b["step"]
        assert a["loss"] == b["loss"], (a, b)  # exact, not approx
        assert a["accuracy"] == b["accuracy"]
    for (name, p), q in zip(m_ref.named_parameters(), m_got.parameters()):
        assert torch.equal(p, q), name


@pytest.mark.parametrize("chain_steps", [2, 4, 8])
def test_chained_trajectory_exactly_matches_unchained(chain_steps):
    params, data = _setup()
    batches = list(batches_from_arrays(data, 8, epochs=2))  # 16 steps
    ref = _run(params, batches, chain_steps=1)
    got = _run(params, batches, chain_steps=chain_steps)
    assert len(got[1]) == 16  # history stays per step
    assert [h["step"] for h in got[1]] == list(range(1, 17))
    _assert_same_run(ref, got)


def test_train_dispatch_count_drops_k_fold():
    params, data = _setup()
    batches = list(batches_from_arrays(data, 8, epochs=2))  # 16 steps
    before = dispatch_count("train")
    _run(params, batches, chain_steps=1)
    unchained = dispatch_count("train") - before
    before = dispatch_count("train")
    _run(params, batches, chain_steps=4)
    chained = dispatch_count("train") - before
    assert unchained == 16
    assert chained == 4


def test_ragged_tail_batches_flush_unchained():
    # drop_remainder=False leaves a short tail batch each epoch: it cannot
    # join a chain of full batches, but the trajectory stays exact
    params, data = _setup(n=40)
    batches = list(batches_from_arrays(data, 16, epochs=2,
                                       drop_remainder=False))
    assert [len(b["labels"]) for b in batches] == [16, 16, 8] * 2
    before = dispatch_count("train")
    got = _run(params, batches, chain_steps=4)
    # per epoch: the two full batches (a ragged boundary flushes them
    # unchained), then the tail; never a one-off K
    assert dispatch_count("train") - before == 6
    _assert_same_run(_run(params, batches, chain_steps=1), got)
    before = dispatch_count("train")
    _run(params, batches[:2] * 3, chain_steps=4)  # 4 chained + 2 tail
    assert dispatch_count("train") - before == 3


def test_metrics_cb_sees_every_step_in_order():
    params, data = _setup()
    batches = list(batches_from_arrays(data, 8, epochs=1))  # 8 steps
    seen = []
    _, history = _run(params, batches, chain_steps=4, metrics_cb=seen.append)
    assert [m["step"] for m in seen] == list(range(1, 9))
    assert seen == history
    # step_time_s is the dispatch's wall over its K steps: equal in a chain
    assert history[0]["step_time_s"] == history[3]["step_time_s"] > 0
    assert history[4]["step_time_s"] == history[7]["step_time_s"] > 0


def test_auto_chain_steps_runs_and_matches():
    # chain_steps=None: the policy picks K from measured step time; on the
    # CPU that may be 1 — correctness (not K) is what auto guarantees
    params, data = _setup()
    batches = list(batches_from_arrays(data, 8, epochs=1))
    _assert_same_run(_run(params, batches, chain_steps=1),
                     _run(params, batches, chain_steps=None))


def test_auto_chain_steps_chains_and_calibrates_on_the_models_device(
        monkeypatch):
    """Auto K calibrates the dispatch gap once, before the loop, on the
    device the model lives on; a gap far above the step time makes the
    policy chain at its cap (max_chain 32) after the first probe."""
    seen = []

    def gap(*args, device=None, **kwargs):
        seen.append(device)
        return 10.0

    monkeypatch.setattr(port_dispatch, "calibrate_dispatch_gap", gap)
    monkeypatch.setattr("sparkdl_torch.train.finetune.calibrate_dispatch_gap",
                        gap)
    params, data = _setup(n=8 * 40)
    batches = list(batches_from_arrays(data, 8, epochs=1))  # 40 steps
    before = dispatch_count("train")
    got = _run(params, batches, chain_steps=None)
    assert seen == [torch.device("cpu")]
    assert dispatch_count("train") - before == 1 + 1 + 7  # probe, 32, tail
    _assert_same_run(_run(params, batches, chain_steps=1), got)


def test_chain_steps_validation():
    params, data = _setup(n=8)
    for bad in (0, -3):
        with pytest.raises(ValueError, match="chain_steps"):
            _run(params, list(batches_from_arrays(data, 8)), chain_steps=bad)


@pytest.mark.parametrize("chain_steps", [1, 4])
def test_mlp_trajectory_matches_the_jax_chained_loop(chain_steps):
    params, data = _setup()
    batches = list(batches_from_arrays(data, 8, epochs=2))
    _, want = jax_finetune(_mlp_apply, params, batches, learning_rate=1e-2,
                           chain_steps=chain_steps, input_prefetch=0)
    _, got = _run(params, batches, chain_steps=chain_steps)
    assert [h["step"] for h in got] == [h["step"] for h in want]
    np.testing.assert_allclose([h["loss"] for h in got],
                               [h["loss"] for h in want], rtol=1e-3)
    np.testing.assert_array_equal([h["accuracy"] for h in got],
                                  [h["accuracy"] for h in want])


@pytest.fixture(scope="module")
def bert_start():
    data = _toy_task()
    model = JClf(JConfig.tiny(vocab_size=VOCAB), num_labels=2)
    v = model.init(jax.random.PRNGKey(0), jnp.asarray(data["input_ids"][:2]),
                   jnp.asarray(data["attention_mask"][:2]))
    return data, jax.device_get(flax.core.meta.unbox(v))


@pytest.mark.parametrize("attn_impl", ["full", "flash"])
def test_bert_chain_of_four_matches_the_jax_chain_of_four(bert_start,
                                                          attn_impl):
    data, variables = bert_start
    model = JClf(JConfig.tiny(vocab_size=VOCAB, attn_impl=attn_impl),
                 num_labels=2)

    def apply_fn(params, input_ids, attention_mask):
        return model.apply(params, input_ids, attention_mask)

    batches = list(jax_batches(data, 16, epochs=2))  # 8 steps: two chains
    _, want = jax_finetune(apply_fn, variables, batches, learning_rate=5e-4,
                           chain_steps=4, input_prefetch=0)
    port = _port_model(variables, attn_impl)
    _, got = finetune_classifier(port, batches, learning_rate=5e-4,
                                 chain_steps=4, input_prefetch=0)
    _, single = finetune_classifier(_port_model(variables, attn_impl),
                                    batches, learning_rate=5e-4,
                                    input_prefetch=0)
    assert [h["loss"] for h in got] == [h["loss"] for h in single]
    assert [h["step"] for h in got] == list(range(1, 9))
    np.testing.assert_allclose([h["loss"] for h in got],
                               [h["loss"] for h in want], rtol=1e-3)
    np.testing.assert_allclose([h["accuracy"] for h in got],
                               [h["accuracy"] for h in want])
