"""``sparkdl_torch.parallel`` and the models and partitioner that use it,
on four gloo ranks (``TorchRunner(np=-4, local_platform="cpu")``):
sp = 4 ring and all-gather attention, sp = 4 GPT and sp_prefill, BERT's
ring at sp = 4, pp = 4 pipelines and a dp = 2 x tp = 2 fine-tune, held
to the JAX package on the same numpy-seeded inputs and converted weights
(or, for the fine-tune, to the port's one-process run).

One job runs every 4-rank check (``tests/torch_parallel_jobs.py``,
jax-free); the JAX side runs here (``tests/torch_parallel_refs.py``).
Tolerances as in ``test_torch_parallel_two_ranks.py``; BERT's ring
against the JAX full forward: 3e-5, the JAX oracle test's bound. The
fsdp x tp steps of ViT and BERT through their rule tables (each tp slice
sharded on fsdp too) and BERT's ring step at dp = 2 x sp = 2 are held to
the one-process run, 1e-5 relative per step with plain SGD.
"""

import numpy as np
import pytest

import torch_parallel_jobs as jobs
import torch_parallel_refs as refs
from sparkdl_torch import TorchRunner

RUNNER = dict(local_platform="cpu", timeout_s=300, driver_log_verbosity="none")
WORLD = 4


@pytest.fixture(scope="module")
def run():
    parts = {
        "collectives": refs.collectives(WORLD),
        "attention": refs.attention(WORLD),
        "pipeline": refs.pipeline(WORLD),
        "gpt": refs.gpt(WORLD),
        "bert_ring": refs.bert_ring(WORLD),
    }
    inp = {k: v[0] for k, v in parts.items()}
    want = {k: v[1] for k, v in parts.items()}
    inp["bert_finetune"] = refs.bert_finetune()
    want["bert_finetune"] = refs.one_process_finetune(inp["bert_finetune"]["state"])
    inp["steps"] = refs.step_states(inp["bert_finetune"]["state"])
    want["steps"] = refs.one_process_steps(inp["steps"])
    got = TorchRunner(np=-WORLD, **RUNNER).run(jobs.four_rank_job, inp=inp)
    return inp, want, got


def test_collectives_at_four_ranks(run):
    _, want, got = run
    w, g = want["collectives"], got["collectives"]
    np.testing.assert_allclose(np.stack(g["mean"]), w["mean"], rtol=1e-6)
    np.testing.assert_allclose(g["psum"], w["psum"][0], rtol=1e-6)
    np.testing.assert_allclose(g["norm"], w["norm"], rtol=1e-6)
    np.testing.assert_allclose(np.concatenate(g["rs_shard"]), w["rs_w"], rtol=1e-6)
    np.testing.assert_allclose(g["roundtrip_w"], w["roundtrip_w"], rtol=1e-6)
    assert g["roundtrip_b"].shape == (3,)
    np.testing.assert_allclose(g["roundtrip_b"], w["roundtrip_b"], rtol=1e-6)


@pytest.mark.parametrize("key", ["ring_causal0", "ring_causal1",
                                 "ring_mask_causal0", "ring_mask_causal1"])
def test_ring_attention_at_sp4_matches_jax_ring(run, key):
    _, want, got = run
    np.testing.assert_allclose(got["attention"][key], want["attention"][key], atol=2e-5)


@pytest.mark.parametrize("causal", [0, 1])
def test_allgather_attention_at_sp4_bitwise_the_dense_path(run, causal):
    _, want, got = run
    assert got["attention"][f"allgather_bitwise_causal{causal}"]
    np.testing.assert_allclose(got["attention"][f"allgather_causal{causal}"],
                               want["attention"][f"allgather_causal{causal}"], atol=2e-5)


def test_ring_attention_gradients_at_sp4(run):
    _, want, got = run
    assert got["attention"]["grads_same_on_every_rank"]
    for g, w in zip(got["attention"]["grads"], want["attention"]["grads"]):
        np.testing.assert_allclose(g, w, atol=1e-4)


def test_pipeline_at_pp4_matches_jax(run):
    _, want, got = run
    g, w = got["pipeline"], want["pipeline"]
    np.testing.assert_allclose(g["out"], w["out"], atol=1e-5)
    for key in ("grad_w", "grad_b", "grad_x"):
        np.testing.assert_allclose(g[key], w[key], atol=1e-4, err_msg=key)


@pytest.mark.parametrize("mode", ["ring", "allgather"])
def test_ring_gpt_at_sp4_matches_jax_ring_gpt(run, mode):
    _, want, got = run
    np.testing.assert_allclose(got["gpt_ring"][mode], want["gpt"][f"ring_{mode}"],
                               atol=1e-5)


@pytest.mark.parametrize("key", ["even", "odd"])
@pytest.mark.parametrize("mode", ["ring", "allgather"])
def test_sp_prefill_at_sp4(run, key, mode):
    """C2: held to the unsharded JAX forward and its init_cache prefill;
    the remainder prompt (21 tokens) pads to 24 inside."""
    inp, want, got = run
    g, w = got["sp_prefill"][f"{key}_{mode}"], want["gpt"][key]
    assert g["idx"] == inp["gpt"][key].shape[1]
    assert g["logits"].shape == w["logits"].shape
    np.testing.assert_allclose(g["logits"], w["logits"], atol=2e-5)
    np.testing.assert_array_equal(g["logits"].argmax(-1), w["logits"].argmax(-1))
    np.testing.assert_allclose(g["k"], w["k"], atol=2e-5)
    np.testing.assert_allclose(g["v"], w["v"], atol=2e-5)
    assert g["tokens_equal_generate"]


def test_bert_ring_at_sp4_matches_jax_full(run):
    """tests/models/test_bert_oracle.py:84's check: ring over sp = 4,
    with a key mask whose padding fills whole shards, against full."""
    _, want, got = run
    np.testing.assert_allclose(got["bert_ring"]["seq"], want["bert_ring"]["seq"],
                               atol=3e-5)


def test_bert_finetune_dp2_tp2_matches_one_process(run):
    _, want, got = run
    g = got["finetune_tp"]
    assert g["world"] == 4 and g["rank_losses_equal"]
    np.testing.assert_allclose(g["losses"], want["bert_finetune"], rtol=1e-5)


@pytest.mark.parametrize("key,model", [("vit_fsdp_tp", "vit"), ("bert_fsdp_tp", "bert"),
                                       ("ring_step", "bert")])
def test_step_over_two_axes_matches_one_process(run, key, model):
    _, want, got = run
    g = got[key]
    assert g["world"] == 4 and g["rank_losses_equal"]
    np.testing.assert_allclose(g["losses"], want["steps"][model], rtol=1e-5)
    if key != "ring_step":
        # the tp slices' state is sharded on fsdp, beside the whole params'
        assert {"query", "key", "value", "intermediate", "output"} <= set(g["sharded"])
