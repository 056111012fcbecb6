"""The port's resumable_finetune (sparkdl_torch/reliability/supervisor.py)
through the seven cases of the reference's
tests/reliability/test_supervisor.py: a run crashed mid-stream by an
injected fault restores the newest checkpoint, replays the iterator, and
produces a per-step trajectory and final parameters BITWISE those of an
uninterrupted run (one process, the same float32 ops in the same order).
The first case also holds the port's recovered trajectory against the
JAX package's supervisor on the same data (1e-5 relative: the two
frameworks' float32 kernels differ in summation order)."""

import numpy as np
import pytest
import torch

from sparkdl_torch.reliability import (
    RetryBudget,
    RetryExhaustedError,
    RetryPolicy,
    faults,
)
from sparkdl_torch.reliability.faults import inject
from sparkdl_torch.reliability.supervisor import resumable_finetune
from sparkdl_torch.train.finetune import batches_from_arrays, finetune_classifier

N, DIM, CLASSES = 64, 4, 3


class _Linear(torch.nn.Module):
    def __init__(self):
        super().__init__()
        rng = np.random.default_rng(0)
        self.w = torch.nn.Parameter(torch.from_numpy(
            (rng.standard_normal((DIM, CLASSES)) * 0.1).astype(np.float32)))
        self.b = torch.nn.Parameter(torch.zeros(CLASSES))

    def forward(self, x):
        return x @ self.w + self.b


def _data():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((N, DIM)).astype(np.float32)
    labels = (x[:, 0] > 0).astype(np.int64) + (x[:, 1] > 0).astype(np.int64)
    return {"x": x, "labels": labels}


def _make_batches():
    return batches_from_arrays(_data(), batch_size=16, epochs=2, seed=3)


def _policy(**kw):
    kw.setdefault("max_attempts", 3)
    kw.setdefault("base_delay_s", 0.0)
    kw.setdefault("sleep", lambda s: None)
    kw.setdefault("budget", RetryBudget(100))
    return RetryPolicy(**kw)


@pytest.fixture(autouse=True)
def _disarmed():
    faults.disarm()
    yield
    faults.disarm()


def _trajectory(history):
    return [(h["step"], h["loss"], h["accuracy"]) for h in history]


def _same_params(a, b):
    return all(torch.equal(p, q) for p, q in zip(a.parameters(), b.parameters()))


def test_recovery_parity_bitwise(tmp_path):
    base_model, base_hist = finetune_classifier(
        _Linear(), _make_batches(), learning_rate=0.1)
    assert len(base_hist) == 8  # 4 batches/epoch x 2 epochs
    # crash before step 5's dispatch (steps 1..4 trained, 2 and 4
    # checkpointed), then recover and finish
    with inject("dispatch:RuntimeError@5"):
        got_model, got_hist = resumable_finetune(
            _Linear(), _make_batches, checkpoint_dir=str(tmp_path / "ckpt"),
            checkpoint_every=2, retry=_policy(), learning_rate=0.1)
    assert _trajectory(got_hist) == _trajectory(base_hist)  # bitwise
    assert _same_params(got_model, base_model)

    # the same recovery in the JAX package lands on the same trajectory
    import jax.numpy as jnp

    from sparkdl_tpu.reliability.faults import inject as jax_inject
    from sparkdl_tpu.reliability.supervisor import resumable_finetune as jax_rf

    m = _Linear()
    params = {"w": jnp.asarray(m.w.detach().numpy()),
              "b": jnp.asarray(m.b.detach().numpy())}
    with jax_inject("dispatch:RuntimeError@5"):
        _, want = jax_rf(
            lambda p, x: x @ p["w"] + p["b"], params, _make_batches,
            checkpoint_dir=str(tmp_path / "jax"), checkpoint_every=2,
            retry=_policy(), learning_rate=0.1)
    np.testing.assert_allclose([h["loss"] for h in got_hist],
                               [h["loss"] for h in want], rtol=1e-5)


def test_crash_before_any_checkpoint_restarts_from_scratch(tmp_path):
    base_model, base_hist = finetune_classifier(
        _Linear(), _make_batches(), learning_rate=0.1)
    # nothing to restore: attempt 2 starts from the weights attempt 1
    # started from (the supervisor's copy), not from the trained ones
    with inject("dispatch@2"):
        got_model, got_hist = resumable_finetune(
            _Linear(), _make_batches, checkpoint_dir=str(tmp_path / "ckpt"),
            checkpoint_every=1000, retry=_policy(), learning_rate=0.1)
    assert _trajectory(got_hist) == _trajectory(base_hist)
    assert _same_params(got_model, base_model)


def test_repeated_crashes_exhaust_retries(tmp_path):
    with inject("dispatch@1*"):  # every dispatch fails, forever
        with pytest.raises(RetryExhaustedError):
            resumable_finetune(
                _Linear(), _make_batches, checkpoint_dir=str(tmp_path / "c"),
                retry=_policy(max_attempts=2), learning_rate=0.1)


def test_fatal_error_is_not_retried(tmp_path):
    calls = {"n": 0}

    class Bad(_Linear):
        def forward(self, x):
            calls["n"] += 1
            raise TypeError("programming error")

    with pytest.raises(TypeError):
        resumable_finetune(Bad(), _make_batches,
                           checkpoint_dir=str(tmp_path / "c"),
                           retry=_policy(fatal=(TypeError,)))
    assert calls["n"] == 1


def test_one_shot_iterator_rejected(tmp_path):
    with pytest.raises(TypeError, match="replayed"):
        resumable_finetune(_Linear(), iter([]),
                           checkpoint_dir=str(tmp_path / "c"))


def test_checkpoint_dir_required():
    with pytest.raises(ValueError, match="checkpoint_dir"):
        resumable_finetune(_Linear(), _make_batches, checkpoint_dir="")


def test_list_of_batches_is_replayable(tmp_path):
    batches = list(_make_batches())
    base_model, base_hist = finetune_classifier(_Linear(), batches,
                                                learning_rate=0.1)
    with inject("dispatch@3"):
        got_model, got_hist = resumable_finetune(
            _Linear(), batches, checkpoint_dir=str(tmp_path / "c"),
            checkpoint_every=2, retry=_policy(), learning_rate=0.1)
    assert _trajectory(got_hist) == _trajectory(base_hist)
    assert _same_params(got_model, base_model)
