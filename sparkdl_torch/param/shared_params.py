"""Spark-ML-compatible Param system.

Typed ``Param`` descriptors on ``Params`` objects with defaults, setters,
``extractParamMap`` and ``copy(extra)`` semantics, as pyspark.ml.param
has them — so Spark-ML-style code
(``DeepImageFeaturizer(inputCol=..., modelName=...)``,
``Pipeline(stages=[...]).fit(df)``) works verbatim without a pyspark
dependency. Params match across instances and
implementations by name.
"""

from __future__ import annotations

import copy as _copy
from typing import Any, Callable


class Param:
    """A named, documented parameter with an optional type converter."""

    def __init__(self, parent: "Params | type | None", name: str, doc: str,
                 typeConverter: Callable[[Any], Any] | None = None):
        self.parent = parent
        self.name = name
        self.doc = doc
        self.typeConverter = typeConverter or (lambda v: v)

    def _copy_for(self, parent: "Params") -> "Param":
        return Param(parent, self.name, self.doc, self.typeConverter)

    def __repr__(self) -> str:
        owner = type(self.parent).__name__ if isinstance(self.parent, Params) else self.parent
        return f"Param({owner}.{self.name})"

    def __hash__(self):
        return hash(self.name)

    def __eq__(self, other):
        return isinstance(other, Param) and other.name == self.name


class Params:
    """Base class: anything with Params (Transformers, Estimators, Models)."""

    def __init__(self):
        self._paramMap: dict[Param, Any] = {}
        self._defaultParamMap: dict[Param, Any] = {}
        # Rebind class-level Param descriptors to this instance so that
        # lookups by name find this instance's copy.
        for name in dir(type(self)):
            attr = getattr(type(self), name, None)
            if isinstance(attr, Param):
                setattr(self, name, attr._copy_for(self))

    # -- declaration helpers ---------------------------------------------
    @property
    def params(self) -> list[Param]:
        # Instance-rebound Params live in __dict__ (see __init__); scanning
        # only __dict__ avoids re-entering properties like this one.
        found = {
            v.name: v for v in self.__dict__.values() if isinstance(v, Param)
        }
        return sorted(found.values(), key=lambda p: p.name)

    def _resolveParam(self, param: "Param | str") -> Param:
        name = param if isinstance(param, str) else param.name
        for p in self.params:
            if p.name == name:
                return p
        raise KeyError(f"no param named {name!r} on {type(self).__name__}")

    # -- get/set ----------------------------------------------------------
    def _set(self, **kwargs) -> "Params":
        for name, value in kwargs.items():
            if value is None:
                continue
            p = self._resolveParam(name)
            self._paramMap[p] = p.typeConverter(value)
        return self

    def _setDefault(self, **kwargs) -> "Params":
        for name, value in kwargs.items():
            p = self._resolveParam(name)
            self._defaultParamMap[p] = value
        return self

    def set(self, param: "Param | str", value) -> "Params":
        p = self._resolveParam(param)
        self._paramMap[p] = p.typeConverter(value)
        return self

    def isSet(self, param: "Param | str") -> bool:
        return self._resolveParam(param) in self._paramMap

    def isDefined(self, param: "Param | str") -> bool:
        p = self._resolveParam(param)
        return p in self._paramMap or p in self._defaultParamMap

    def hasParam(self, name: str) -> bool:
        try:
            self._resolveParam(name)
            return True
        except KeyError:
            return False

    def getOrDefault(self, param: "Param | str"):
        p = self._resolveParam(param)
        if p in self._paramMap:
            return self._paramMap[p]
        if p in self._defaultParamMap:
            return self._defaultParamMap[p]
        raise KeyError(f"param {p.name} is not set and has no default")

    def getParam(self, name: str) -> Param:
        return self._resolveParam(name)

    def extractParamMap(self, extra: dict | None = None) -> dict[Param, Any]:
        m = dict(self._defaultParamMap)
        m.update(self._paramMap)
        if extra:
            for k, v in extra.items():
                m[self._resolveParam(k)] = v
        return m

    def copy(self, extra: dict | None = None) -> "Params":
        that = _copy.deepcopy(self)
        if extra:
            for k, v in extra.items():
                p = that._resolveParam(k)
                that._paramMap[p] = p.typeConverter(v)
        return that

    def clear(self, param: "Param | str") -> "Params":
        self._paramMap.pop(self._resolveParam(param), None)
        return self

    def explainParams(self) -> str:
        lines = []
        for p in self.params:
            cur = "undefined"
            if self.isDefined(p):
                cur = repr(self.getOrDefault(p))
            lines.append(f"{p.name}: {p.doc} (current: {cur})")
        return "\n".join(lines)


# -- shared column params (parity with pyspark.ml.param.shared) -----------

class HasInputCol(Params):
    inputCol = Param(None, "inputCol", "input column name")

    def setInputCol(self, value: str):
        return self._set(inputCol=value)

    def getInputCol(self) -> str:
        return self.getOrDefault("inputCol")


class HasOutputCol(Params):
    outputCol = Param(None, "outputCol", "output column name")

    def setOutputCol(self, value: str):
        return self._set(outputCol=value)

    def getOutputCol(self) -> str:
        return self.getOrDefault("outputCol")


class HasLabelCol(Params):
    labelCol = Param(None, "labelCol", "label column name")

    def setLabelCol(self, value: str):
        return self._set(labelCol=value)

    def getLabelCol(self) -> str:
        return self.getOrDefault("labelCol")


class HasBatchSize(Params):
    batchSize = Param(None, "batchSize", "rows per device batch")

    def setBatchSize(self, value: int):
        return self._set(batchSize=int(value))

    def getBatchSize(self) -> int:
        return self.getOrDefault("batchSize")


class Transformer(Params):
    """Spark-ML Transformer shape: ``transform(df) -> df``."""

    def transform(self, dataset, params: dict | None = None):
        if params:
            return self.copy(params).transform(dataset)
        return self._transform(dataset)

    def _transform(self, dataset):  # pragma: no cover - abstract
        raise NotImplementedError


class Estimator(Params):
    """Spark-ML Estimator shape: ``fit(df[, params]) -> Model(s)``."""

    def fit(self, dataset, params: "dict | list[dict] | None" = None):
        if isinstance(params, (list, tuple)):
            return self.fitMultiple(dataset, list(params))
        if params:
            return self.copy(params)._fit(dataset)
        return self._fit(dataset)

    def fitMultiple(self, dataset, paramMaps: list[dict]):
        """Default: sequential fits; estimators override to parallelize."""
        return [self.copy(pm)._fit(dataset) for pm in paramMaps]

    def _fit(self, dataset):  # pragma: no cover - abstract
        raise NotImplementedError


class Pipeline(Estimator):
    """Minimal Spark-ML Pipeline: chain of Transformers/Estimators."""

    def __init__(self, stages: list | None = None):
        super().__init__()
        self._stages = list(stages or [])

    def setStages(self, stages: list) -> "Pipeline":
        self._stages = list(stages)
        return self

    def getStages(self) -> list:
        return self._stages

    def _fit(self, dataset):
        def is_estimator(s):
            return isinstance(s, Estimator) or (
                hasattr(s, "fit") and not isinstance(s, Transformer)
            )

        last_est = max(
            (i for i, s in enumerate(self._stages) if is_estimator(s)),
            default=-1,
        )
        transformers = []
        df = dataset
        for i, stage in enumerate(self._stages):
            model = stage.fit(df) if is_estimator(stage) else stage
            transformers.append(model)
            # Only materialize intermediate data while a later stage still
            # needs it for fitting (pyspark.ml.Pipeline semantics).
            if i < last_est:
                df = model.transform(df)
        return PipelineModel(transformers)


class PipelineModel(Transformer):
    """A fitted Pipeline: its stages' transforms in order."""

    def __init__(self, stages: list):
        super().__init__()
        self._stages = list(stages)

    def _transform(self, dataset):
        df = dataset
        for stage in self._stages:
            df = stage.transform(df)
        return df
