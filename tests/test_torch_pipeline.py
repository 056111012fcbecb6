"""The port's Spark-ML surface (sparkdl_torch/param: HasLabelCol,
Estimator, Pipeline, PipelineModel and the type converters) against the
JAX package's classes: the same stages, written once over either package's
base classes, fit and transform in the same order, with the same param
copies and the same errors. Exact comparisons (no numerics)."""

import os

import pytest

import sparkdl_torch.param as tparam
import sparkdl_tpu.param as jparam

PACKAGES = {"torch": tparam, "jax": jparam}


def _stages(P, log):
    """Fake stages over ``P``'s base classes; ``log`` records each fit and
    transform with what it saw. A dataset is a list of dicts."""

    class AddCol(P.Transformer, P.HasInputCol, P.HasOutputCol):
        def __init__(self, name, inputCol=None, outputCol=None):
            super().__init__()
            self.name = name
            self._set(inputCol=inputCol, outputCol=outputCol)

        def _transform(self, dataset):
            log.append(("transform", self.name, sorted(dataset[0])))
            src, dst = self.getInputCol(), self.getOutputCol()
            return [{**r, dst: r[src] + 1} for r in dataset]

    class Model(P.Transformer):
        def __init__(self, name, shift):
            super().__init__()
            self.name, self.shift = name, shift

        def _transform(self, dataset):
            log.append(("transform", self.name, sorted(dataset[0])))
            return [{**r, self.name: r["x"] + self.shift} for r in dataset]

    class ShiftEstimator(P.Estimator, P.HasLabelCol):
        shift = P.Param(None, "shift", "added to x", P.SparkDLTypeConverters.toInt)

        def __init__(self, name, labelCol=None, shift=None):
            super().__init__()
            self.name = name
            self._setDefault(shift=1)
            self._set(labelCol=labelCol, shift=shift)

        def _fit(self, dataset):
            log.append(("fit", self.name, sorted(dataset[0]),
                        self.getOrDefault("shift"), self.getLabelCol()))
            return Model(self.name + "_model", self.getOrDefault("shift"))

    class DuckEstimator:  # has fit, is no Transformer: fitted as an estimator
        def fit(self, dataset):
            log.append(("fit", "duck", sorted(dataset[0])))
            return Model("duck_model", 100)

    return AddCol, ShiftEstimator, DuckEstimator


def _run(package, build):
    P = PACKAGES[package]
    log = []
    AddCol, ShiftEstimator, DuckEstimator = _stages(P, log)
    data = [{"x": 1, "y": 0}, {"x": 5, "y": 1}]
    out = build(P, AddCol, ShiftEstimator, DuckEstimator, data)
    return log, out


def _pipeline(P, AddCol, ShiftEstimator, DuckEstimator, data):
    pipe = P.Pipeline(stages=[
        AddCol("a", inputCol="x", outputCol="a"),
        ShiftEstimator("e1", labelCol="y", shift=2),
        AddCol("b", inputCol="a", outputCol="b"),
        DuckEstimator(),
        AddCol("c", inputCol="b", outputCol="c"),  # after the last estimator
    ])
    model = pipe.fit(data)
    assert isinstance(model, P.PipelineModel) and isinstance(model, P.Transformer)
    return [sorted(r.items()) for r in model.transform(data)]


def _estimator_only(P, AddCol, ShiftEstimator, DuckEstimator, data):
    est = ShiftEstimator("e", labelCol="y")
    one = est.fit(data, {"shift": 7})
    many = est.fit(data, [{"shift": 3}, {est.getParam("shift"): 4}])
    also = est.fitMultiple(data, [{"labelCol": "z"}])
    assert est.getOrDefault("shift") == 1  # fit(params) fits a copy
    return [one.shift, [m.shift for m in many], [m.shift for m in also]]


def _no_estimators(P, AddCol, ShiftEstimator, DuckEstimator, data):
    stages = [AddCol("a", inputCol="x", outputCol="a"),
              AddCol("b", inputCol="a", outputCol="b")]
    pipe = P.Pipeline().setStages(stages)
    assert pipe.getStages() == stages
    model = pipe.fit(data)
    return [sorted(r.items()) for r in model.transform(data)]


@pytest.mark.parametrize("build", [_pipeline, _estimator_only, _no_estimators],
                         ids=lambda f: f.__name__.strip("_"))
def test_fit_and_transform_match_jax(build):
    """Each estimator fits on the data as transformed by the stages before
    it; stages after the last estimator transform nothing while fitting;
    the PipelineModel transforms through every stage in order."""
    assert _run("torch", build) == _run("jax", build)


def test_pipeline_fit_order():
    log, out = _run("torch", _pipeline)
    fits = [e[:2] for e in log if e[0] == "fit"]
    assert fits == [("fit", "e1"), ("fit", "duck")]
    assert ("fit", "e1", ["a", "x", "y"], 2, "y") in log
    assert ("fit", "duck", ["a", "b", "e1_model", "x", "y"]) in log
    assert dict(out[1])["c"] == 8 and dict(out[1])["duck_model"] == 105


def test_label_col_and_param_copies():
    for P in PACKAGES.values():
        _, ShiftEstimator, _ = _stages(P, [])
        est = ShiftEstimator("e").setLabelCol("label")
        assert est.getLabelCol() == "label" and est.isSet("labelCol")
        twin = est.copy({"labelCol": "other", "shift": 5})
        assert (twin.getLabelCol(), twin.getOrDefault("shift")) == ("other", 5)
        assert (est.getLabelCol(), est.getOrDefault("shift")) == ("label", 1)
        assert twin.getParam("shift") is not est.getParam("shift")
        with pytest.raises(TypeError):
            est.copy({"shift": "three"})
        with pytest.raises(KeyError):
            est.copy({"nope": 1})
        assert [p.name for p in est.params] == ["labelCol", "shift"]
    assert tparam.__all__ == jparam.__all__


def _outcome(fn, value):
    try:
        return ("ok", fn(value))
    except Exception as e:  # the error's type is the contract
        return ("raises", type(e).__name__)


CONVERTER_CASES = [
    ("toExistingFilePath", [__file__, "/no/such/file.h5", 3, os.path.dirname(__file__)]),
    ("toColumnToTensorNameMap", [{"a": "t:0"}, {}, {"a": 1}, [("a", "b")], {1: "x"}]),
    ("toTensorNameToColumnMap", [{"t:0": "a", "u:0": "b"}, None, {"a": None}]),
    ("toChannelOrder", ["RGB", "BGR", "L", "rgb", 3]),
    ("toKerasLoss", ["categorical_crossentropy", 1, None]),
    ("toKerasOptimizer", ["adam", 0.1, None]),
    ("toString", ["a", 1, None]),
    ("toInt", [1, 2.0, 2.5, True, "1"]),
    ("toFloat", [1, 2.5, True, "1.0"]),
    ("toBoolean", [True, 1, "true"]),
]


@pytest.mark.parametrize("name,values", CONVERTER_CASES, ids=[c[0] for c in CONVERTER_CASES])
def test_converters_match_jax(name, values):
    ours = getattr(tparam.SparkDLTypeConverters, name)
    theirs = getattr(jparam.SparkDLTypeConverters, name)
    for v in values:
        assert _outcome(ours, v) == _outcome(theirs, v), (name, v)


def test_supported_name_converter_matches_jax():
    names = ["InceptionV3", "ResNet50"]
    ours = tparam.SparkDLTypeConverters.supportedNameConverter(names)
    theirs = jparam.SparkDLTypeConverters.supportedNameConverter(names)
    for v in ("ResNet50", "VGG16", 5):
        assert _outcome(ours, v) == _outcome(theirs, v)


def test_lazy_exports():
    import sparkdl_torch

    for name in ("DeepTextFeaturizer", "Pipeline", "PipelineModel"):
        assert name in sparkdl_torch.__all__ and name in dir(sparkdl_torch)
    assert sparkdl_torch.Pipeline is tparam.Pipeline
    assert sparkdl_torch.PipelineModel is tparam.PipelineModel
    from sparkdl_torch.transformers.text import DeepTextFeaturizer

    assert sparkdl_torch.DeepTextFeaturizer is DeepTextFeaturizer
