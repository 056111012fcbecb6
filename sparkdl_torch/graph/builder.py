"""Graph surgery: IsolatedSession, GraphFunction, freeze/strip, torch lowering.

The port of ``sparkdl_tpu/graph/builder.py`` (SURVEY.md 2.9, [U:
python/sparkdl/graph/builder.py]). ``IsolatedSession`` keeps every
ingestion in a fresh ``tf.Graph`` so no state leaks across models;
``GraphFunction`` is the serializable (graph, inputs, outputs) unit, in
the reference's file format, so files interchange.
:meth:`GraphFunction.to_torch` rebuilds the graph as torch ops on the
card (graph/tf2torch.py). There is no ``call_tf`` fallback: the reference
latches TF's own execution when translation fails, which would run the
graph in host TF, hiding the card (whose machine has no TF).

Only ``IsolatedSession``, ``strip_and_freeze_upto``, :meth:`GraphFunction.load`
and reading a GraphDef need TF; a ``GraphFunction`` over a ``TFGraph``
written in code runs without it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Sequence

from sparkdl_torch.graph import utils as tfx
from sparkdl_torch.graph._tf import require_tf


@dataclasses.dataclass
class GraphFunction:
    """A frozen TF computation: a GraphDef (or a ``TFGraph``) plus
    ordered input/output tensor names."""

    graph_def: Any  # tf.compat.v1.GraphDef or sparkdl_torch.graph.tfgraph.TFGraph
    input_names: list[str]
    output_names: list[str]

    def dump(self, path: str) -> None:
        """Serialize to a file (proto bytes + name lists, self-contained);
        the reference's format."""
        import json

        if not hasattr(self.graph_def, "SerializeToString"):
            raise TypeError("only a GraphDef serializes; a TFGraph written in "
                            "code has no file form")
        payload = {
            "input_names": self.input_names,
            "output_names": self.output_names,
        }
        with open(path, "wb") as f:
            header = json.dumps(payload).encode("utf-8")
            f.write(len(header).to_bytes(8, "little"))
            f.write(header)
            f.write(self.graph_def.SerializeToString())

    @staticmethod
    def load(path: str) -> "GraphFunction":
        import json

        tf = require_tf()
        with open(path, "rb") as f:
            n = int.from_bytes(f.read(8), "little")
            payload = json.loads(f.read(n).decode("utf-8"))
            gdef = tf.compat.v1.GraphDef()
            gdef.ParseFromString(f.read())
        return GraphFunction(gdef, payload["input_names"], payload["output_names"])

    def to_torch(self, device="cuda", validate: bool = True,
                 f32_precision: str = "highest", prefer_native: bool = True):
        """The graph as a :class:`~sparkdl_torch.graph.tf2torch.TranslatedGraph`,
        ``f(*tensors) -> tuple(tensors)`` on ``device`` (``cuda`` unless the
        caller passes ``device="cpu"``), inputs in ``input_names`` order.

        The supported-op surface (graph/op_surface.py) is enforced here:
        graphs holding host-side/stateful ops raise
        :class:`~sparkdl_torch.graph.op_surface.UnsupportedGraphOpsError`
        with per-node guidance; ``validate=False`` skips the prescreen,
        and the translator is then the only judge
        (:class:`~sparkdl_torch.graph.tf2torch.GraphTranslationError`).

        ``f32_precision``: "highest" (default, float32 contractions with
        TF32 off) or "default" (bfloat16 operands, float32 accumulation).
        "highest" turns the process's cuBLAS and cuDNN TF32 flags off for
        as long as a call runs, so other threads lose TF32 meanwhile.
        ``prefer_native=False`` asked the reference for its ``call_tf``
        lowering; the port has none, so it raises ``ValueError``.
        """
        from sparkdl_torch.graph.tf2torch import check_precision, translate_graph

        check_precision(f32_precision)
        if not prefer_native:
            raise ValueError(
                "prefer_native=False asks for the call_tf lowering, which runs "
                "the graph in host TensorFlow; the port has none: graphs run "
                "translated to torch ops on the card (ROADMAP C)")
        if validate:
            from sparkdl_torch.graph.op_surface import validate_graph_def

            validate_graph_def(self.graph_def, output_names=self.output_names)
        return translate_graph(self.graph_def, self.input_names, self.output_names,
                               device=device, f32_precision=f32_precision)


class PlaceholderSpec(NamedTuple):
    """A graph input: its op name, dtype (numpy, or ``torch.bfloat16``)
    and shape (None for an unknown rank, None entries for unknown dims)."""

    name: str
    dtype: Any
    shape: "list | None"


def placeholder_specs(graph, tensor_names: Sequence[str]) -> list:
    """:class:`PlaceholderSpec` of each named graph input, from a GraphDef
    or a ``TFGraph`` (the node attrs alone: no TF import)."""
    from sparkdl_torch.graph.reader import attr_value
    from sparkdl_torch.graph.tfgraph import TFGraph

    if isinstance(graph, TFGraph):
        by_op = graph.by_name

        def attrs(node):
            return node.attrs
    else:
        by_op = {n.name: n for n in graph.node}

        def attrs(node):
            return {k: attr_value(v) for k, v in node.attr.items()}

    specs = []
    for tname in tensor_names:
        node = by_op.get(tfx.op_name(tname))
        if node is None:
            raise KeyError(f"input op {tname!r} not found in the graph")
        a = attrs(node)
        shape = a.get("shape")
        if shape is not None:
            shape = [None if d < 0 else d for d in shape]
        specs.append(PlaceholderSpec(tfx.op_name(tname), a.get("dtype"), shape))
    return specs


class IsolatedSession:
    """A fresh tf.Graph + Session for safe, leak-free graph surgery.

    Reference parity ([U: python/sparkdl/graph/builder.py] IsolatedSession):
    a context manager whose graph/session never alias another model's.
    ``using_keras`` is accepted for API parity; Keras 3 is sessionless, so it
    only affects nothing and is recorded for introspection.
    """

    def __init__(self, graph=None, using_keras: bool = False):
        tf = require_tf()
        self._tf = tf
        self.graph = graph if graph is not None else tf.Graph()
        self.using_keras = bool(using_keras)
        self.sess = tf.compat.v1.Session(graph=self.graph)

    def __enter__(self) -> "IsolatedSession":
        self._graph_ctx = self.graph.as_default()
        self._graph_ctx.__enter__()
        return self

    def __exit__(self, *exc):
        self._graph_ctx.__exit__(*exc)
        self.sess.close()
        return False

    def run(self, fetches, feed_dict=None):
        return self.sess.run(fetches, feed_dict=feed_dict)

    def asGraphFunction(self, inputs, outputs, strip_and_freeze: bool = True) -> GraphFunction:
        """Export (a subgraph of) this session as a GraphFunction."""
        in_names = [tfx.tensor_name(i, self.graph) for i in inputs]
        out_names = [tfx.tensor_name(o, self.graph) for o in outputs]
        if strip_and_freeze:
            gdef = strip_and_freeze_upto(self.sess, self.graph, outputs)
        else:
            gdef = self.graph.as_graph_def()
        return GraphFunction(gdef, in_names, out_names)

    def importGraphFunction(self, gfn: GraphFunction, prefix: str = ""):
        """Splice a GraphFunction into this graph; returns (inputs, outputs)."""
        tf = self._tf
        with self.graph.as_default():
            scope = prefix if prefix else ""
            elems = tf.graph_util.import_graph_def(
                gfn.graph_def,
                return_elements=list(gfn.input_names) + list(gfn.output_names),
                name=scope,
            )
        n_in = len(gfn.input_names)
        return elems[:n_in], elems[n_in:]


def strip_and_freeze_upto(sess, graph, outputs):
    """Freeze variables to constants and prune nodes not feeding ``outputs``.

    Reference parity: strip_and_freeze_upto ([U: python/sparkdl/graph/
    builder.py]) — constant folding of variables plus dead-node removal, so
    the exported GraphDef is self-contained and minimal.
    """
    tf = require_tf()
    out_ops = [tfx.op_name(o) for o in outputs]
    gdef = graph.as_graph_def(add_shapes=True)
    has_variables = any(
        n.op in ("VariableV2", "Variable", "VarHandleOp") for n in gdef.node
    )
    if has_variables:
        import warnings

        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # tf1 freeze API is deprecated, not gone
            gdef = tf.compat.v1.graph_util.convert_variables_to_constants(
                sess, gdef, out_ops
            )
    else:
        gdef = tf.compat.v1.graph_util.extract_sub_graph(gdef, out_ops)
    return gdef
