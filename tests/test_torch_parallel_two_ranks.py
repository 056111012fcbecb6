"""``sparkdl_torch.parallel`` and the models and partitioner that use it,
on two gloo ranks (``TorchRunner(np=-2, local_platform="cpu")``), against
the JAX package on the same numpy-seeded inputs and converted weights.

One job runs every 2-rank check (``tests/torch_parallel_jobs.py``,
jax-free); the JAX side runs here (``tests/torch_parallel_refs.py``).

Tolerances (float32 on both sides):
- collectives: 1e-6 relative (sums of two terms);
- ring attention against JAX's ring: 2e-5 absolute (the JAX tests'
  ring-vs-full bound; both online softmaxes, folded in other orders);
  gradients 1e-4 (test_ring_grads_match_full's);
- the all-gather schedule: bitwise against the port's one-rank dense
  path (the same operations on the same rows), 2e-5 against JAX's;
- TPMlpBlock and the MoE block: 1e-5 (each output a sum split across
  ranks, or the same sums in another order); the MoE block's dispatch
  is exact, so only the combine's sums reorder;
- pipeline: 1e-5, gradients 1e-4 (the JAX test's);
- GPT ring / tp / MoE logits against JAX: 1e-5 (two tiny layers);
  sp_prefill 2e-5 (the JAX sp_prefill test's); greedy tokens equal;
- the tp fine-tune against the one-process run: 1e-5 relative per step
  (AdamW; the tp all-reduces sum the same products in another order);
- ViT at tp = 2 against JAX: 1e-5 (two tiny layers, as GPT's);
- the train steps over sp, ep and pp against the one-process run: 1e-5
  relative per step, with plain SGD (``torch_parallel_jobs.step_losses``:
  an update that is the gradient itself, so a gradient summed over the
  wrong ranks or divided by the wrong count shows in the next loss).
"""

import numpy as np
import pytest
import torch

import torch_parallel_jobs as jobs
import torch_parallel_refs as refs
from sparkdl_torch import TorchRunner

torch.set_num_threads(2)
RUNNER = dict(local_platform="cpu", timeout_s=300, driver_log_verbosity="none")
WORLD = 2


@pytest.fixture(scope="module")
def run():
    parts = {
        "collectives": refs.collectives(WORLD),
        "attention": refs.attention(WORLD),
        "tp_mlp": refs.tp_mlp(),
        "moe_block": refs.moe_block(),
        "pipeline": refs.pipeline(WORLD),
        "gpt": refs.gpt(WORLD),
        "moe_gpt": refs.gpt(WORLD, num_experts=4, moe_every=2),
    }
    inp = {k: v[0] for k, v in parts.items()}
    want = {k: v[1] for k, v in parts.items()}
    inp["bert_finetune"] = refs.bert_finetune()
    want["bert_finetune"] = refs.one_process_finetune(inp["bert_finetune"]["state"])
    inp["vit_tp"], want["vit_tp"] = refs.vit_tp()
    inp["steps"] = refs.step_states(inp["bert_finetune"]["state"])
    want["steps"] = refs.one_process_steps(inp["steps"])
    got = TorchRunner(np=-WORLD, **RUNNER).run(jobs.two_rank_job, inp=inp)
    return inp, want, got


def test_collectives_match_the_jax_helpers(run):
    _, want, got = run
    w, g = want["collectives"], got["collectives"]
    np.testing.assert_allclose(np.stack(g["mean"]), w["mean"], rtol=1e-6)
    np.testing.assert_allclose(g["psum"], w["psum"][0], rtol=1e-6)
    np.testing.assert_allclose(g["norm"], w["norm"], rtol=1e-6)
    np.testing.assert_allclose(np.concatenate(g["rs_shard"]), w["rs_w"], rtol=1e-6)
    np.testing.assert_allclose(g["rs_bias"], w["rs_b"], rtol=1e-6)
    # the non-divisible bias comes back (3,), not WORLD stacked copies
    np.testing.assert_allclose(g["roundtrip_w"], w["roundtrip_w"], rtol=1e-6)
    np.testing.assert_allclose(g["roundtrip_b"], w["roundtrip_b"], rtol=1e-6)
    assert g["unsharded_gather"] == (2 * WORLD, 4)


def test_psum_gradient_is_all_reduced(run):
    _, _, got = run
    # each rank's sum(psum(x)) is a term of the total: d/dx = WORLD ones
    np.testing.assert_array_equal(got["collectives"]["psum_grad"],
                                  np.full(3, float(WORLD), np.float32))


@pytest.mark.parametrize("key", ["ring_causal0", "ring_causal1",
                                 "ring_mask_causal0", "ring_mask_causal1"])
def test_ring_attention_matches_jax_ring(run, key):
    _, want, got = run
    np.testing.assert_allclose(got["attention"][key], want["attention"][key], atol=2e-5)


@pytest.mark.parametrize("causal", [0, 1])
def test_allgather_attention_bitwise_the_dense_path(run, causal):
    _, want, got = run
    assert got["attention"][f"allgather_bitwise_causal{causal}"]
    np.testing.assert_allclose(got["attention"][f"allgather_causal{causal}"],
                               want["attention"][f"allgather_causal{causal}"], atol=2e-5)


def test_ring_attention_gradients_match_jax(run):
    _, want, got = run
    assert got["attention"]["grads_same_on_every_rank"]
    for g, w in zip(got["attention"]["grads"], want["attention"]["grads"]):
        np.testing.assert_allclose(g, w, atol=1e-4)


def test_tp_mlp_block_forward_and_gradients(run):
    _, want, got = run
    g, w = got["tp_mlp"], want["tp_mlp"]
    assert g["local_shapes"] == {"up.weight": (16, 16), "up.bias": (16,),
                                 "down.weight": (16, 16), "down.bias": (16,)}
    np.testing.assert_allclose(g["y"], w["y"], atol=1e-5)
    np.testing.assert_allclose(g["x_grad"], w["x_grad"], atol=1e-5, rtol=1e-5)
    for name, grad in w["grads"].items():
        np.testing.assert_allclose(g["grads"][name], grad, atol=1e-5, rtol=1e-5,
                                   err_msg=name)


def test_moe_block_at_ep2_matches_jax(run):
    _, want, got = run
    g, w = got["moe_block"], want["moe_block"]
    assert g["local_experts"] == 2
    np.testing.assert_allclose(g["y"], w["y"], atol=1e-5)
    np.testing.assert_allclose(g["aux_loss"], w["aux_loss"], rtol=1e-6)
    np.testing.assert_allclose(g["router_z_loss"], w["router_z_loss"], rtol=1e-6)
    for name, grad in w["grads"].items():
        np.testing.assert_allclose(g["grads"][name], grad, atol=1e-5, rtol=1e-5,
                                   err_msg=name)


def test_pipeline_at_pp2_matches_jax(run):
    _, want, got = run
    g, w = got["pipeline"], want["pipeline"]
    np.testing.assert_allclose(g["out"], w["out"], atol=1e-5)
    for key in ("grad_w", "grad_b", "grad_x"):
        np.testing.assert_allclose(g[key], w[key], atol=1e-4, err_msg=key)
    assert "not divisible by microbatches" in g["bad_microbatches"]


@pytest.mark.parametrize("mode", ["ring", "allgather"])
def test_ring_gpt_matches_jax_ring_gpt(run, mode):
    _, want, got = run
    np.testing.assert_allclose(got["gpt_ring"][mode], want["gpt"][f"ring_{mode}"],
                               atol=1e-5)


def test_allgather_gpt_bitwise_the_full_forward(run):
    _, _, got = run
    assert got["gpt_ring"]["allgather_bitwise_full"]


@pytest.mark.parametrize("key", ["even", "odd"])
@pytest.mark.parametrize("mode", ["ring", "allgather"])
def test_sp_prefill_against_jax_apply_init_cache_and_generate(run, key, mode):
    """C2: held to the unsharded JAX forward and its init_cache prefill."""
    inp, want, got = run
    g, w = got["sp_prefill"][f"{key}_{mode}"], want["gpt"][key]
    assert g["idx"] == inp["gpt"][key].shape[1]
    assert g["logits"].shape == w["logits"].shape  # the pad cut off
    np.testing.assert_allclose(g["logits"], w["logits"], atol=2e-5)
    np.testing.assert_array_equal(g["logits"].argmax(-1), w["logits"].argmax(-1))
    np.testing.assert_allclose(g["k"], w["k"], atol=2e-5)
    np.testing.assert_allclose(g["v"], w["v"], atol=2e-5)
    assert g["tokens_equal_generate"]  # the port's plain generate's


def test_sp_prefill_allgather_bitwise_on_a_divisible_prompt(run):
    _, _, got = run
    assert got["sp_prefill"]["even_allgather"]["bitwise_full"]


def test_gpt_at_tp2_matches_jax(run):
    _, want, got = run
    g = got["gpt_tp"]
    assert g["local_heads"] == 1 and g["q_rows"] == 16
    np.testing.assert_allclose(g["logits"], want["gpt"]["ids_logits"], atol=1e-5)
    np.testing.assert_array_equal(g["tokens"], want["gpt"]["ids_tokens"])


def test_moe_gpt_at_ep2_matches_jax(run):
    _, want, got = run
    g = got["moe_gpt"]
    assert g["local_experts"] == 2
    np.testing.assert_allclose(g["logits"], want["moe_gpt"]["ids_logits"], atol=1e-5)
    np.testing.assert_array_equal(g["tokens"], want["moe_gpt"]["ids_tokens"])


def test_bert_finetune_dp1_tp2_matches_one_process(run):
    _, want, got = run
    g = got["finetune_tp"]
    assert g["world"] == 2 and g["rank_losses_equal"]
    np.testing.assert_allclose(g["losses"], want["bert_finetune"], rtol=1e-5)


def test_vit_at_tp2_matches_jax(run):
    _, want, got = run
    g, w = got["vit_tp"], want["vit_tp"]
    assert g["q_rows"] == 16  # one head of two a rank
    np.testing.assert_allclose(g["features"], w["features"], atol=1e-5)
    np.testing.assert_allclose(g["probs"], w["probs"], atol=1e-5)


@pytest.mark.parametrize("key,model", [("ring_step", "bert"), ("moe_step", "moe"),
                                       ("pipeline_step", "gpt")])
def test_step_over_a_model_axis_matches_one_process(run, key, model):
    """BERT's ring at sp = 2 (each peer its block of the same rows), the
    MoE classifier at ep = 2 (each rank its experts and its rows) and the
    GPT classifier's blocks as pipeline stages at pp = 2."""
    _, want, got = run
    g = got[key]
    assert g["world"] == 2 and g["rank_losses_equal"]
    np.testing.assert_allclose(g["losses"], want["steps"][model], rtol=1e-5)
    if key == "moe_step":
        assert g["local_experts"] == 2
