"""A run driven past the harness's look for a card, on the CPU at a small
size, with the timed path broken underneath: ``correct`` must come out
false for each fault the cell can have, and true for the sound path.

Featurization: an answer altered where it is produced; half of each batch
left out, its rows given the other half's answers. Training: half of the
batch left out, the mean taken over the rest; a step that returns its
state unchanged. No cell exchanges anything between chips."""

import pytest

from benchmark import harness

FEATURIZE = ("inceptionv3.featurize.tasks4", "resnet50.featurize.tasks4")
TRAIN = ("resnet50.train.b64",)


def _result(small_run, cell, fault=None):
    run, mode = small_run(cell, fault=fault)
    inline = {"inline": True} if cell in FEATURIZE else {}
    out = mode.run(run, device="cpu", **inline)
    line = harness.result_line(run, out)
    return line, {c.name: c for c in out.checks}


@pytest.mark.parametrize("cell", FEATURIZE + TRAIN)
def test_the_sound_path_is_correct(small_run, cell):
    line, checks = _result(small_run, cell)
    if cell in TRAIN:
        # at 32 px and B=32 the three steps' trajectories of two float32
        # programs part further than at the cell's size (the change); the
        # first step's numbers do not
        for name in ("loss1_gap", "grad_gap", "stats1_gap", "losses_nonfinite"):
            assert checks[name].ok, checks[name]
        assert line["attempted"] > 0 and line["failed"] == 0
    else:
        assert line["correct"], line["checks"]
    assert list(line)[-1] == "checks"


@pytest.mark.parametrize("cell", FEATURIZE)
@pytest.mark.parametrize("fault", ["altered_answer", "half_batch"])
def test_a_broken_featurizer_is_not_correct(small_run, cell, fault):
    line, checks = _result(small_run, cell, fault)
    assert not line["correct"] and not checks["feature_err"].ok


@pytest.mark.parametrize("fault, fails", [("half_batch", "loss1_gap"),
                                          ("frozen", "change_median_gap")])
def test_a_broken_train_step_is_not_correct(small_run, fault, fails):
    line, checks = _result(small_run, TRAIN[0], fault)
    assert not line["correct"] and not checks[fails].ok


def test_the_frozen_step_reads_one(small_run):
    """A state left unchanged reads 1 by the change's measure: every
    leaf's change is 0 against the reference's."""
    _, checks = _result(small_run, TRAIN[0], "frozen")
    assert checks["change_median_gap"].value == pytest.approx(1.0)
    assert checks["stats1_gap"].value == pytest.approx(1.0)
