"""Data-parallel, ZeRO-sharded, checkpointed and resumable fine-tuning of
the port across ranks (``TorchRunner(np=-2, local_platform="cpu")``: two
gloo worker processes), against the JAX package's ``finetune_classifier``
on a ``dp=2`` mesh and against the port's own one-process run.

The ranks run the bodies of ``tests/torch_dist_jobs.py`` (jax-free);
each rank feeds its half of every global batch.

Tolerances:
- port 2-rank dp vs the JAX dp=2 loop, SGD: 1e-5 relative per step (the
  same float32 products, reduced in other orders; SGD keeps the
  difference at rounding, where AdamW's first steps divide rounding noise
  by its own magnitude, see test_torch_finetune.py);
- ZeRO vs dp (AdamW): 1e-6 relative (the same per-element update; the
  gradient sums reduce in another order);
- resumed runs vs the uninterrupted one-process run: 1e-5 relative (the
  global batch's mean is taken as two halves' means on two ranks).
"""

import os

import flax
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

import torch_dist_jobs as jobs
from sparkdl_torch import TorchRunner
from sparkdl_torch.models.bert import BertConfig, BertForSequenceClassification
from sparkdl_torch.models.convert import bert_flax_to_torch
from sparkdl_torch.reliability.faults import inject
from sparkdl_torch.train import finetune_classifier
from sparkdl_tpu.models.bert import BertConfig as JConfig
from sparkdl_tpu.models.bert import BertForSequenceClassification as JClf
from sparkdl_tpu.partition import DataParallelPartitioner as JDP
from sparkdl_tpu.partition import make_mesh as jax_make_mesh
from sparkdl_tpu.train.finetune import finetune_classifier as jax_finetune

RUNNER = dict(local_platform="cpu", timeout_s=240, driver_log_verbosity="none")


@pytest.fixture(scope="module")
def start():
    model = JClf(JConfig.tiny(vocab_size=jobs.VOCAB), num_labels=2)
    b = jobs.toy_batches()[0]
    v = model.init(jax.random.PRNGKey(0), jnp.asarray(b["input_ids"][:2]),
                   jnp.asarray(b["attention_mask"][:2]))
    variables = jax.device_get(flax.core.meta.unbox(v))
    m = BertForSequenceClassification(BertConfig.tiny(vocab_size=jobs.VOCAB),
                                      device="cpu")
    return model, variables, bert_flax_to_torch(variables, module=m)


def _one_process(state, **kw):
    """The uninterrupted reference: one process, the global batches."""
    _, hist = finetune_classifier(jobs.tiny_bert(state), jobs.toy_batches(),
                                  learning_rate=1e-3, **kw)
    return [h["loss"] for h in hist]


@pytest.fixture(scope="module")
def two_ranks(start, tmp_path_factory):
    """One 2-rank job holding every parity case (a job's start costs
    seconds): dp (SGD, AdamW), ZeRO, a ZeRO run that crashes at step 3
    after checkpointing step 2, and the resume of a one-process
    checkpoint (saved before the job) under ZeRO on two ranks."""
    _, _, state = start
    root = tmp_path_factory.mktemp("dist")
    crash_dir, resume_dir = str(root / "crash"), str(root / "from_one")
    with inject("dispatch:RuntimeError@3"):
        with pytest.raises(RuntimeError):
            _one_process(state, checkpoint_dir=resume_dir, checkpoint_every=2)
    out = TorchRunner(np=-2, **RUNNER).run(
        jobs.parity_job, state=state, crash_dir=crash_dir,
        resume_dir=resume_dir)
    return out, crash_dir, resume_dir


def test_two_rank_dp_matches_the_jax_dp2_loop(start, two_ranks):
    model, variables, _ = start
    out, _, _ = two_ranks
    assert out["world"] == 2

    def apply_fn(params, input_ids, attention_mask):
        return model.apply(params, input_ids, attention_mask)

    part = JDP(jax_make_mesh(dp=2, devices=jax.devices()[:2]))
    _, want = jax_finetune(apply_fn, variables, jobs.toy_batches(),
                           tx=optax.sgd(0.1), partitioner=part,
                           input_prefetch=0)
    np.testing.assert_allclose(out["sgd"], [h["loss"] for h in want],
                               rtol=1e-5)
    assert out["sgd"][-1] < out["sgd"][0]


def test_zero_matches_dp_and_halves_opt_state_bytes(start, two_ranks):
    out, _, _ = two_ranks
    np.testing.assert_allclose(out["zero"], out["dp"], rtol=1e-6)
    assert out["zero_vs_dp_param"] <= 1e-6
    # AdamW's two moments a parameter, each split over 2 ranks (a few
    # odd-sized leaves stay whole)
    assert out["zero_bytes"] <= out["dp_bytes"] / 2 * 1.02
    assert out["zero_bytes"] >= out["dp_bytes"] / 2


def test_two_rank_dp_matches_the_one_process_run(start, two_ranks):
    _, _, state = start
    out, _, _ = two_ranks
    np.testing.assert_allclose(out["dp"], _one_process(state), rtol=1e-5)


def test_resume_world2_checkpoint_on_one_process(start, two_ranks):
    """Saved by 2 ZeRO ranks (optimizer state as DTensor shards), resumed
    by one process holding it whole: DCP reshards."""
    _, _, state = start
    out, crash_dir, _ = two_ranks
    assert "dispatch" in out["crash"]
    assert sorted(os.listdir(crash_dir)) == ["2", "sparkdl_integrity.json"]
    tail = _one_process(state, checkpoint_dir=crash_dir, checkpoint_every=2)
    np.testing.assert_allclose(tail, _one_process(state)[2:], rtol=1e-5)


def test_resume_one_process_checkpoint_on_world2(start, two_ranks):
    _, _, state = start
    out, _, _ = two_ranks
    np.testing.assert_allclose(out["resumed"], _one_process(state)[2:],
                               rtol=1e-5)


def test_killed_rank_resumed_from_its_checkpoint(start, tmp_path):
    """Rank 1 is SIGKILLed after step 2's checkpoint landed: the job
    fails (barrier semantics), and a new job resumes from the newest
    landed step and finishes on the uninterrupted trajectory."""
    _, _, state = start
    ckpt = str(tmp_path / "ck")
    with pytest.raises(RuntimeError, match="rank"):
        TorchRunner(np=-2, **RUNNER).run(jobs.killed_job, state=state,
                                         ckpt_dir=ckpt, die_at=2)
    out = TorchRunner(np=-2, **RUNNER).run(jobs.killed_job, state=state,
                                           ckpt_dir=ckpt, die_at=None)
    first = out["steps"][0]
    assert 3 <= first <= jobs.STEPS and out["steps"][-1] == jobs.STEPS
    np.testing.assert_allclose(out["losses"],
                               _one_process(state)[first - 1:], rtol=1e-5)


def test_zero_on_a_dp2_fsdp2_mesh_of_four_ranks(start, two_ranks):
    """Four ranks, state sharded on one axis and replicated on the other:
    the reduce-scatter is followed by an all-reduce over the replicas."""
    _, _, state = start
    out = TorchRunner(np=-4, **RUNNER).run(jobs.mesh4_job, state=state)
    want = _one_process(state)
    for axis in ("fsdp", "dp"):
        np.testing.assert_allclose(out[axis], want, rtol=1e-5)
        assert out[axis + "_bytes"] <= two_ranks[0]["dp_bytes"] / 2 * 1.02
