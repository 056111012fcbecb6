"""TFImageTransformer — apply an arbitrary TF graph to the image column.

The port of ``sparkdl_tpu/transformers/tf_image.py`` (SURVEY.md 2.5, [U:
python/sparkdl/transformers/tf_image.py]): the user supplies a graph
(``TFInputGraph``, a ``TFGraph`` written in code, or a tf.Graph/GraphDef)
plus its input/output tensor names; the transformer feeds decoded images
and emits either a flat float vector (``outputMode="vector"``) or a new
image struct (``outputMode="image"``). Decode happens host-side
(imageIO), resize targets the graph's static spatial shape when it has
one, and the graph itself runs as torch ops on ``device`` (``cuda``
unless the caller passes ``device="cpu"``), one CUDA graph per bucket
(eagerly when it holds If/While). A rank-3 graph is fed one row a call.
Float32 products run with TF32 off, process-wide while a batch runs
(``f32_precision="highest"``, graph/tf2torch.py).
"""

from __future__ import annotations

import numpy as np

from sparkdl_torch.dataframe import transform_partitions
from sparkdl_torch.graph.builder import placeholder_specs
from sparkdl_torch.graph.input import TFInputGraph
from sparkdl_torch.graph.tfgraph import TFGraph
from sparkdl_torch.param import (
    HasBatchSize,
    HasInputCol,
    HasOutputCol,
    Param,
    SparkDLTypeConverters,
    Transformer,
)
from sparkdl_torch.transformers._inference import run_partition_with_passthrough
from sparkdl_torch.transformers.named_image import _image_to_rgb_array, _resize_host
from sparkdl_torch.transformers.tf_tensor import graph_runner

OUTPUT_MODES = ("vector", "image")


class TFImageTransformer(Transformer, HasInputCol, HasOutputCol, HasBatchSize):
    graph = Param(None, "graph",
                  "TFInputGraph (or TFGraph, tf.Graph, GraphDef) to apply to images")
    inputTensor = Param(
        None, "inputTensor",
        "name of the graph's image input tensor (needed for raw graphs)",
    )
    outputTensor = Param(
        None, "outputTensor",
        "name of the graph's output tensor (needed for raw graphs)",
    )
    outputMode = Param(
        None, "outputMode", "'vector' (flat floats) or 'image' (image struct)",
        SparkDLTypeConverters.supportedNameConverter(list(OUTPUT_MODES)),
    )
    device = Param(None, "device", "'cuda' (default) or 'cpu'",
                   SparkDLTypeConverters.toDevice)

    def __init__(self, inputCol=None, outputCol=None, graph=None,
                 inputTensor=None, outputTensor=None, outputMode=None,
                 batchSize=None, device=None):
        super().__init__()
        self._setDefault(outputMode="vector", batchSize=64, device="cuda")
        self._set(inputCol=inputCol, outputCol=outputCol, graph=graph,
                  inputTensor=inputTensor, outputTensor=outputTensor,
                  outputMode=outputMode, batchSize=batchSize, device=device)

    def getGraph(self):
        return self.getOrDefault("graph")

    def _resolved_graph(self) -> TFInputGraph:
        g = self.getGraph()
        if isinstance(g, TFInputGraph):
            return g
        from sparkdl_torch.graph import utils as tfx

        in_name = self.getOrDefault("inputTensor")
        out_name = self.getOrDefault("outputTensor")
        if in_name is None or out_name is None:
            raise ValueError(
                "raw graphs need inputTensor/outputTensor names; or pass a "
                "TFInputGraph"
            )
        in_name, out_name = tfx.tensor_name(in_name), tfx.tensor_name(out_name)
        if isinstance(g, TFGraph):  # written in code: no TF needed
            return TFInputGraph.fromGraphDef(g, [in_name], [out_name])
        from sparkdl_torch.graph._tf import require_tf

        tf = require_tf()
        if isinstance(g, tf.Graph):
            with tf.compat.v1.Session(graph=g) as sess:
                return TFInputGraph.fromGraph(g, sess, [in_name], [out_name])
        # assume GraphDef proto
        return TFInputGraph.fromGraphDef(g, [in_name], [out_name])

    def _transform(self, dataset):
        gin = self._resolved_graph()
        if len(gin.input_names) != 1 or len(gin.output_names) != 1:
            raise ValueError(
                "TFImageTransformer expects a single-input single-output "
                f"graph, got {gin.input_names} -> {gin.output_names}"
            )
        (spec,) = placeholder_specs(gin.graph_def, gin.input_names)
        shape = spec.shape
        if shape is not None and len(shape) == 4:
            batched_input, spatial = True, shape[1:3]
        elif shape is not None and len(shape) == 3:
            batched_input, spatial = False, shape[0:2]
        else:
            raise ValueError(
                f"image input tensor must be rank 3 or 4, got shape {shape}"
            )
        static_size = (
            (int(spatial[0]), int(spatial[1]))
            if all(s is not None for s in spatial)
            else None
        )
        in_dtype = spec.dtype
        input_col = self.getInputCol()
        output_col = self.getOutputCol()
        output_mode = self.getOrDefault("outputMode")
        batch_size = self.getBatchSize() if batched_input else 1
        device = self.getOrDefault("device")

        def partition_fn(rows):
            rows = list(rows)
            if not rows:
                return iter(())
            runner = self._runner(gin, batched_input, batch_size, device,
                                  ragged_rows=static_size is None)

            def extract(row):
                arr = _image_to_rgb_array(row[input_col])
                if static_size is not None:
                    arr = _resize_host(arr, static_size)
                return {"img": np.asarray(arr, dtype=in_dtype)}

            return run_partition_with_passthrough(
                rows, extract, runner, output_col,
                self._postprocess(output_mode), input_cols=(input_col,),
            )

        schema = [(output_col,
                   "array<float>" if output_mode == "vector"
                   else "struct<origin:string,height:int,width:int,"
                        "nChannels:int,mode:int,data:binary>")]
        return transform_partitions(dataset, partition_fn, schema)

    @staticmethod
    def _runner(gin: TFInputGraph, batched_input: bool, batch_size: int, device: str,
                ragged_rows: bool = False):
        if batched_input:
            def apply(fn, batch):
                return fn(batch["img"])[0]
        else:  # rank-3 graphs: one image per call (leading dim stripped)
            def apply(fn, batch):
                return fn(batch["img"][0])[0][None]
        return graph_runner(gin, batch_size, device, apply, key=(batched_input,),
                            ragged_rows=ragged_rows)

    @staticmethod
    def _postprocess(output_mode: str):
        if output_mode == "vector":
            return lambda o: np.asarray(o, np.float32).reshape(-1)

        def to_image(o):
            from sparkdl_torch.image.imageIO import imageArrayToStructBGR

            arr = np.asarray(o)
            if arr.ndim == 2:
                arr = arr[:, :, None]
            if arr.ndim != 3:
                raise ValueError(
                    f"outputMode='image' needs a (H,W,C) output, got {arr.shape}"
                )
            return imageArrayToStructBGR(arr.astype(np.float32))

        return to_image
