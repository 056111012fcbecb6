"""TFTransformer — run an ingested TF graph over numeric DataFrame columns.

The port of ``sparkdl_tpu/transformers/tf_tensor.py`` (SURVEY.md 2.6, [U:
python/sparkdl/transformers/tf_tensor.py]): takes a ``TFInputGraph`` plus
explicit input/output tensor↔column mappings, and applies the graph per
partition block. The frozen graph is translated once into torch ops on
``device`` (``cuda`` unless the caller passes ``device="cpu"``;
:meth:`TFInputGraph.to_torch`) and driven by the shared bucketed runner,
which captures it as a CUDA graph per bucket; a graph holding ``If`` or
``While`` reads its predicates to the host, so its runner runs eagerly
(``chain_k=1``). Float32 products run with TF32 off, process-wide while
a batch runs (``f32_precision="highest"``, graph/tf2torch.py).
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

from sparkdl_torch.dataframe import transform_partitions
from sparkdl_torch.graph.builder import placeholder_specs
from sparkdl_torch.graph.input import TFInputGraph
from sparkdl_torch.param import (
    HasBatchSize,
    Param,
    SparkDLTypeConverters,
    Transformer,
)
from sparkdl_torch.transformers._inference import BatchedRunner, cached_graph_runner


def graph_runner(gin: TFInputGraph, batch_size: int, device: str, apply,
                 key=(), ragged_rows: bool = False) -> BatchedRunner:
    """The cached runner of ``gin`` on ``device``: ``apply(fn, batch)``
    maps the translated graph ``fn`` over a batch dict. Graphs with
    If/While run eagerly (their predicates are read to the host, which a
    CUDA graph cannot capture). With the default ``cuda`` a batch is
    spread over the cards, the graph translated onto each."""
    def make_apply(dev):
        fn = gin.to_torch(device=dev)
        return lambda batch: apply(fn, batch)

    def make_runner():
        fn = gin.to_torch(device=device)
        return BatchedRunner(lambda batch: apply(fn, batch), batch_size=batch_size,
                             device=device, ragged_rows=ragged_rows,
                             chain_k=1 if fn.host_sync else None,
                             replicate=make_apply)

    return cached_graph_runner(gin, (batch_size, device, ragged_rows) + tuple(key),
                               make_runner)


class TFTransformer(Transformer, HasBatchSize):
    tfInputGraph = Param(
        None, "tfInputGraph", "ingested TF graph (TFInputGraph)",
        SparkDLTypeConverters.toTFInputGraph,
    )
    inputMapping = Param(
        None, "inputMapping",
        "dict: input column -> graph input (tensor name or signature key)",
        SparkDLTypeConverters.toColumnToTensorNameMap,
    )
    outputMapping = Param(
        None, "outputMapping",
        "dict: graph output (tensor name or signature key) -> output column",
        SparkDLTypeConverters.toTensorNameToColumnMap,
    )
    device = Param(None, "device", "'cuda' (default) or 'cpu'",
                   SparkDLTypeConverters.toDevice)

    def __init__(self, tfInputGraph=None, inputMapping=None, outputMapping=None,
                 batchSize=None, device=None):
        super().__init__()
        self._setDefault(batchSize=256, device="cuda")
        self._set(tfInputGraph=tfInputGraph, inputMapping=inputMapping,
                  outputMapping=outputMapping, batchSize=batchSize, device=device)

    def getTFInputGraph(self) -> TFInputGraph:
        return self.getOrDefault("tfInputGraph")

    def getInputMapping(self) -> dict:
        return self.getOrDefault("inputMapping")

    def getOutputMapping(self) -> dict:
        return self.getOrDefault("outputMapping")

    def _transform(self, dataset):
        gin = self.getTFInputGraph()
        batch_size = self.getBatchSize()
        device = self.getOrDefault("device")

        # column -> canonical input tensor name (signature keys resolved)
        col_to_tensor = gin.translateInputMapping(self.getInputMapping())
        # canonical output tensor name -> column
        tensor_to_col = gin.translateOutputMapping(self.getOutputMapping())

        tensor_to_colin = {t: c for c, t in col_to_tensor.items()}
        missing = [t for t in gin.input_names if t not in tensor_to_colin]
        if missing:
            raise ValueError(
                f"inputMapping covers no column for graph inputs {missing}; "
                f"graph inputs are {gin.input_names}"
            )
        # ordered column feed matching gin.input_names / to_torch arg order
        feed_cols = [tensor_to_colin[t] for t in gin.input_names]

        out_indices, out_cols = [], []
        for t, col in tensor_to_col.items():
            if t not in gin.output_names:
                raise ValueError(
                    f"outputMapping names {t!r}, not a graph output "
                    f"{gin.output_names}"
                )
            out_indices.append(gin.output_names.index(t))
            out_cols.append(col)

        in_dtypes = [s.dtype for s in placeholder_specs(gin.graph_def, gin.input_names)]
        names = list(gin.input_names)

        def partition_fn(rows) -> Iterator[dict]:
            rows = list(rows)
            if not rows:
                return iter(())
            runner = graph_runner(
                gin, batch_size, device,
                lambda fn, batch: fn(*(batch[n] for n in names)))

            def feeds():
                for r in rows:
                    yield {
                        t: np.asarray(r[c], dtype=dt)
                        for t, c, dt in zip(names, feed_cols, in_dtypes)
                    }

            def emit():
                outputs = runner.run(feeds())
                for r, out in zip(rows, outputs):
                    new = dict(r)
                    for idx, col in zip(out_indices, out_cols):
                        new[col] = np.asarray(out[idx], dtype=np.float32)
                    yield new

            return emit()

        schema = [(c, "array<float>") for c in out_cols]
        return transform_partitions(dataset, partition_fn, schema)
