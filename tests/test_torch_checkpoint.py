"""The port's CheckpointManager (sparkdl_torch/checkpoint, on
torch.distributed.checkpoint) through the cases of the reference's
tests/checkpoint/test_checkpoint.py and test_sharded_roundtrip.py, one
process: round trip into a template, ``keep``, the interval policy, the
sha256 sidecar (the same digest as the JAX package's function over the
same directory), fallback past a torn newest step with quarantine, a
corrupt pinned step, deferred quarantine, async save + wait, retries,
``restore_matching`` and resume of the fine-tune loop. Values compare
exactly: a checkpoint stores the bytes it was given."""

import json
import os
import threading

import numpy as np
import pytest
import torch

from sparkdl_torch.checkpoint import (
    CheckpointCorruptError,
    CheckpointManager,
    checkpoint_digest,
    latest_step,
    restore_matching,
    save_and_wait,
)
from sparkdl_torch.observability.registry import registry


def _state(scale=1.0):
    return {
        "params": {
            "w": torch.arange(16.0).reshape(8, 2) * scale,
            "b": torch.full((2,), 0.5 * scale),
        },
        "step": torch.tensor(7),
    }


def _counter(name):
    fam = registry().get(name)
    return 0.0 if fam is None else fam.snapshot_values().get("", 0.0)


def _corrupt_step(directory, step):
    """Garble the largest file in the step dir (a torn write)."""
    step_dir = os.path.join(directory, str(step))
    victim, size = None, -1
    for root, _, files in os.walk(step_dir):
        for f in files:
            p = os.path.join(root, f)
            if os.path.getsize(p) > size:
                victim, size = p, os.path.getsize(p)
    with open(victim, "r+b") as f:
        f.truncate(max(0, size // 2))
        f.seek(0)
        f.write(b"\xde\xad\xbe\xef")


def _drop_payload(directory, step):
    """A recycled disk lost the step's data files; its metadata stays."""
    removed = 0
    for root, _, files in os.walk(os.path.join(directory, str(step))):
        for f in files:
            if f != ".metadata":
                os.remove(os.path.join(root, f))
                removed += 1
    assert removed > 0


def test_save_restore_roundtrip_into_the_template(tmp_path):
    state = _state()
    with CheckpointManager(tmp_path / "ckpt") as mgr:
        assert mgr.save(7, state)
        mgr.wait()
        assert mgr.latest_step() == 7
        fresh = _state(scale=0.0)
        w = fresh["params"]["w"]
        restored = mgr.restore(template=fresh)
    assert restored is fresh and restored["params"]["w"] is w  # in place
    assert torch.equal(w, state["params"]["w"])
    assert torch.equal(restored["params"]["b"], state["params"]["b"])
    assert int(restored["step"]) == 7


def test_keep_bounds_retained_steps(tmp_path):
    with CheckpointManager(tmp_path / "ckpt", keep=2) as mgr:
        for s in (1, 2, 3, 4):
            mgr.save(s, _state(), force=True)
            mgr.wait()
        assert mgr.latest_step() == 4
        assert mgr.all_steps() == [3, 4]


def test_save_interval_policy_skips_and_force_overrides(tmp_path):
    with CheckpointManager(tmp_path / "ckpt", save_interval_steps=10) as mgr:
        assert mgr.save(0, _state())
        assert not mgr.save(3, _state())      # inside the interval
        assert mgr.save(3, _state(), force=True)
        assert not mgr.save(3, _state(), force=True)  # not newer
        mgr.wait()
        assert mgr.all_steps() == [0, 3]


def test_restore_missing_raises(tmp_path):
    with CheckpointManager(tmp_path / "none") as mgr:
        with pytest.raises(FileNotFoundError):
            mgr.restore(template={"x": torch.zeros(1)})


def test_one_shot_conveniences(tmp_path):
    save_and_wait(tmp_path / "c", 1, _state())
    assert latest_step(tmp_path / "c") == 1
    assert latest_step(tmp_path / "absent") is None
    got = restore_matching(tmp_path / "c", _state(0.0))
    assert torch.equal(got["params"]["w"], _state()["params"]["w"])


def test_save_is_async_after_a_host_snapshot(tmp_path, monkeypatch):
    """save() copies the state to host memory and returns; the write
    runs on the manager's writer thread and lands by wait(). Changing
    the live tensors after save() does not change what lands."""
    threads = []
    real = CheckpointManager._write

    def spy(self, step, snap):
        threads.append(threading.current_thread())
        real(self, step, snap)

    monkeypatch.setattr(CheckpointManager, "_write", spy)
    state = _state()
    with CheckpointManager(tmp_path / "c") as mgr:
        assert mgr.save(1, state, force=True)
        state["params"]["w"].mul_(0)  # after the snapshot
        mgr.wait()
        assert mgr.latest_step() == 1
        got = mgr.restore(template=_state(0.0))
    assert threads and threads[0] is not threading.main_thread()
    assert torch.equal(got["params"]["w"], _state()["params"]["w"])


def test_digest_sidecar_matches_the_reference_digest(tmp_path):
    from sparkdl_tpu.checkpoint.manager import checkpoint_digest as jax_digest

    with CheckpointManager(tmp_path / "c") as mgr:
        mgr.save(1, _state(), force=True)
        mgr.wait()
        assert mgr.verify(1) is True
        assert mgr.verify(99) is None  # no digest recorded: unknown
    manifest = json.load(open(tmp_path / "c" / "sparkdl_integrity.json"))
    step_dir = str(tmp_path / "c" / "1")
    assert manifest["1"] == checkpoint_digest(step_dir) == jax_digest(step_dir)
    assert manifest["1"]["files"] >= 2  # data and .metadata both covered


def test_restore_falls_back_past_a_torn_newest_step(tmp_path):
    directory = tmp_path / "c"
    with CheckpointManager(directory) as mgr:
        mgr.save(1, _state(1.0), force=True)
        mgr.save(2, _state(2.0), force=True)
        mgr.wait()
        _corrupt_step(str(directory), 2)
        assert mgr.verify(2) is False
        fallbacks0 = _counter("sparkdl_checkpoint_fallbacks_total")
        restored = mgr.restore(template=_state(0.0))
        assert torch.equal(restored["params"]["w"], _state(1.0)["params"]["w"])
        assert _counter("sparkdl_checkpoint_fallbacks_total") == fallbacks0 + 1
        # quarantined: the step number is free for a resumed run's save
        assert mgr.all_steps() == [1]
        assert os.path.isdir(directory / "corrupt-step-2")
        assert mgr.save(2, _state(2.0), force=True)
        mgr.wait()
        assert mgr.verify(2) is True


def test_pinned_corrupt_step_raises(tmp_path):
    with CheckpointManager(tmp_path / "c") as mgr:
        mgr.save(3, _state(), force=True)
        mgr.wait()
        _corrupt_step(str(tmp_path / "c"), 3)
        with pytest.raises(CheckpointCorruptError):
            mgr.restore(3, template=_state(0.0))
        assert mgr.all_steps() == [3]  # a pinned step is never moved


def test_all_steps_corrupt_raises_corrupt_error(tmp_path):
    with CheckpointManager(tmp_path / "c") as mgr:
        mgr.save(1, _state(), force=True)
        mgr.wait()
        _corrupt_step(str(tmp_path / "c"), 1)
        with pytest.raises(CheckpointCorruptError):
            mgr.restore(template=_state(0.0))


def test_pre_manifest_missing_file_falls_back(tmp_path):
    directory = tmp_path / "c"
    with CheckpointManager(directory, verify_integrity=False) as mgr:
        mgr.save(1, _state(1.0), force=True)
        mgr.save(2, _state(2.0), force=True)
        mgr.wait()
    _drop_payload(str(directory), 2)
    corrupt0 = _counter("sparkdl_checkpoint_corrupt_total")
    with CheckpointManager(directory) as mgr:
        restored = mgr.restore(template=_state(0.0))
        assert mgr.all_steps() == [1]  # renamed away once step 1 loaded
    assert torch.equal(restored["params"]["w"], _state(1.0)["params"]["w"])
    assert os.path.isdir(directory / "corrupt-step-2")
    assert _counter("sparkdl_checkpoint_corrupt_total") == corrupt0 + 1


def test_intact_step_restore_failure_propagates(tmp_path, monkeypatch):
    with CheckpointManager(tmp_path / "c") as mgr:
        mgr.save(1, _state(1.0), force=True)
        mgr.save(2, _state(2.0), force=True)
        mgr.wait()

        def flaky(step, template):
            raise RuntimeError("transient device error")

        monkeypatch.setattr(mgr, "_do_restore", flaky)
        with pytest.raises(RuntimeError, match="transient"):
            mgr.restore(template=_state(0.0))


def test_integrity_disabled_keeps_simple_restore(tmp_path, monkeypatch):
    with CheckpointManager(tmp_path / "c", verify_integrity=False) as mgr:
        mgr.save(1, _state(1.0), force=True)
        mgr.save(2, _state(2.0), force=True)
        mgr.wait()
        calls = []

        def flaky(step, template):
            calls.append(step)
            raise RuntimeError("not corruption")

        monkeypatch.setattr(mgr, "_do_restore", flaky)
        with pytest.raises(RuntimeError, match="not corruption"):
            mgr.restore(template=_state(0.0))
        assert calls == [2]


def test_bad_template_never_quarantines_pre_manifest_history(tmp_path,
                                                             monkeypatch):
    directory = tmp_path / "c"
    with CheckpointManager(directory, verify_integrity=False) as mgr:
        mgr.save(1, _state(1.0), force=True)
        mgr.save(2, _state(2.0), force=True)
        mgr.wait()
    with CheckpointManager(directory) as mgr:
        real = mgr._do_restore

        def bad_template(step, template):
            raise ValueError("template shape mismatch")

        monkeypatch.setattr(mgr, "_do_restore", bad_template)
        with pytest.raises(CheckpointCorruptError):
            mgr.restore(template=_state(0.0))
        assert mgr.all_steps() == [1, 2]
        monkeypatch.setattr(mgr, "_do_restore", real)
        restored = mgr.restore(template=_state(0.0))
    assert torch.equal(restored["params"]["w"], _state(2.0)["params"]["w"])


def test_restore_hashes_fresh_save_once(tmp_path, monkeypatch):
    import sparkdl_torch.checkpoint.manager as manager_mod

    calls = []
    real = manager_mod.checkpoint_digest

    def counting(step_dir):
        calls.append(step_dir)
        return real(step_dir)

    monkeypatch.setattr(manager_mod, "checkpoint_digest", counting)
    with CheckpointManager(tmp_path / "c") as mgr:
        mgr.save(1, _state(), force=True)
        mgr.restore(template=_state(0.0))
    assert len(calls) == len(set(calls)) == 1


def test_gcd_steps_pruned_from_manifest(tmp_path):
    with CheckpointManager(tmp_path / "c", keep=2) as mgr:
        for s in (1, 2, 3, 4):
            mgr.save(s, _state(), force=True)
            mgr.wait()
    manifest = json.load(open(tmp_path / "c" / "sparkdl_integrity.json"))
    assert set(manifest) == {"3", "4"}


def test_save_retries_transient_faults(tmp_path):
    from sparkdl_torch.reliability.faults import inject
    from sparkdl_torch.reliability.retry import RetryBudget, RetryPolicy

    retry = RetryPolicy(max_attempts=3, base_delay_s=0.0,
                        sleep=lambda s: None, budget=RetryBudget(10))
    with CheckpointManager(tmp_path / "c", retry=retry) as mgr:
        with inject("checkpoint.save:OSError@1"):
            assert mgr.save(1, _state(), force=True)
        mgr.wait()
        assert mgr.latest_step() == 1
        assert mgr.verify(1) is True


def test_fine_tune_resume_matches_uninterrupted(tmp_path):
    """The loop's resume: phase 1 trains the first half checkpointing
    every step, phase 2 is handed the whole stream and replays only the
    tail; the final parameters equal the uninterrupted run's."""
    from sparkdl_torch.train import finetune_classifier

    rng = np.random.default_rng(0)
    xs = rng.normal(size=(8, 8, 4)).astype(np.float32)
    ys = (rng.random(64).reshape(8, 8) > 0.5).astype(np.int64)
    batches = [{"x": xs[i], "labels": ys[i]} for i in range(8)]

    class Lin(torch.nn.Module):
        def __init__(self):
            super().__init__()
            g = torch.Generator().manual_seed(1)
            self.w = torch.nn.Parameter(torch.randn(4, 2, generator=g) * 0.1)
            self.b = torch.nn.Parameter(torch.zeros(2))

        def forward(self, x):
            return x @ self.w + self.b

    ref, ref_hist = finetune_classifier(Lin(), batches, learning_rate=1e-2)
    ckdir = str(tmp_path / "resume")
    finetune_classifier(Lin(), batches[:4], learning_rate=1e-2,
                        checkpoint_dir=ckdir, checkpoint_every=1)
    got, hist = finetune_classifier(Lin(), batches, learning_rate=1e-2,
                                    checkpoint_dir=ckdir, checkpoint_every=1)
    assert [h["step"] for h in hist] == [5, 6, 7, 8]
    assert [h["loss"] for h in hist] == [h["loss"] for h in ref_hist[4:]]
    for a, b in zip(got.parameters(), ref.parameters()):
        assert torch.equal(a, b)
