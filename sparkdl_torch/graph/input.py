"""TFInputGraph — unified ingestion of TF model artifacts.

Parity with the reference (SURVEY.md 2.7, [U: python/sparkdl/graph/input.py]):
six constructors normalize (live graph | GraphDef | checkpoint | SavedModel,
each optionally signature-driven) into one frozen-graph value with optional
signature→tensor-name maps, consumed by TFTransformer/TFImageTransformer.
The port of ``sparkdl_tpu/graph/input.py``: the exit path, :meth:`to_torch`,
rebuilds the frozen graph as torch ops on the card instead of shipping it to
a JVM TF session. The constructors read TF artifacts and need TF on the
host; ``fromGraphDef`` also takes a ``TFGraph`` written in code, which
needs none.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

from sparkdl_torch.graph import utils as tfx
from sparkdl_torch.graph._tf import require_tf
from sparkdl_torch.graph.builder import GraphFunction, IsolatedSession, strip_and_freeze_upto
from sparkdl_torch.graph.tfgraph import TFGraph

_SERVING = "serving_default"
_SERVE_TAG = "serve"


@dataclasses.dataclass(eq=False)  # identity semantics: used as a cache key
class TFInputGraph:
    """A frozen TF graph (a GraphDef, or a ``TFGraph``) plus endpoint
    metadata.

    ``input_tensor_name_from_signature`` / ``output_tensor_name_from_signature``
    map signature keys (e.g. ``"images"``) to tensor names (``"x:0"``); they
    are None when the artifact carried no signature.
    """

    graph_def: Any
    input_tensor_name_from_signature: "dict[str, str] | None"
    output_tensor_name_from_signature: "dict[str, str] | None"
    input_names: list[str]
    output_names: list[str]

    # -- signature translation (reference API) ----------------------------
    def translateInputMapping(self, input_mapping) -> dict[str, str]:
        """column→signature-key mapping → column→tensor-name mapping."""
        items = input_mapping.items() if isinstance(input_mapping, dict) else input_mapping
        out = {}
        for col, key in sorted(items):
            out[col] = self._resolve(key, self.input_tensor_name_from_signature)
        return out

    def translateOutputMapping(self, output_mapping) -> dict[str, str]:
        """signature-key→column mapping → tensor-name→column mapping."""
        items = output_mapping.items() if isinstance(output_mapping, dict) else output_mapping
        out = {}
        for key, col in sorted(items):
            out[self._resolve(key, self.output_tensor_name_from_signature)] = col
        return out

    def _resolve(self, key: str, table: "dict[str, str] | None") -> str:
        if table is not None:
            if key in table:
                return table[key]
            raise KeyError(
                f"signature key {key!r} not found; available: {sorted(table)}"
            )
        return tfx.tensor_name(key)

    # -- the exit to the card ----------------------------------------------
    def asGraphFunction(self) -> GraphFunction:
        return GraphFunction(self.graph_def, list(self.input_names), list(self.output_names))

    def to_torch(self, device="cuda", validate: bool = True,
                 f32_precision: str = "highest") -> Callable[..., tuple]:
        """The graph as torch ops on ``device`` (``cuda`` unless the
        caller passes ``device="cpu"``), over tensors in ``input_names``
        order (:meth:`GraphFunction.to_torch`)."""
        return self.asGraphFunction().to_torch(
            device=device, validate=validate, f32_precision=f32_precision)

    # -- constructors -----------------------------------------------------
    @classmethod
    def fromGraph(cls, graph, sess, feed_names: Sequence[str], fetch_names: Sequence[str]) -> "TFInputGraph":
        """From a live tf.Graph + session (variables frozen through sess)."""
        return _from_session(graph, sess, feed_names, fetch_names, None)

    @classmethod
    def fromGraphDef(cls, graph_def, feed_names: Sequence[str], fetch_names: Sequence[str]) -> "TFInputGraph":
        """From a serialized (already frozen) GraphDef, or from a
        ``TFGraph`` (frozen by construction; no TF needed: the names are
        checked against its nodes)."""
        if isinstance(graph_def, TFGraph):
            return _from_tf_graph(graph_def, feed_names, fetch_names)
        tf = require_tf()
        with IsolatedSession() as issn:
            tf.graph_util.import_graph_def(graph_def, name="")
            return _from_session(
                issn.graph, issn.sess, feed_names, fetch_names, None
            )

    @classmethod
    def fromCheckpoint(cls, checkpoint_dir: str, feed_names: Sequence[str], fetch_names: Sequence[str]) -> "TFInputGraph":
        """From a TF-1-style checkpoint directory (MetaGraph + variables)."""
        with _restored_checkpoint(checkpoint_dir) as (issn, _meta):
            return _from_session(issn.graph, issn.sess, feed_names, fetch_names, None)

    @classmethod
    def fromCheckpointWithSignature(cls, checkpoint_dir: str, signature_def_key: str = _SERVING) -> "TFInputGraph":
        """Checkpoint whose MetaGraph carries a signature_def."""
        with _restored_checkpoint(checkpoint_dir) as (issn, meta):
            sig = _signature(meta, signature_def_key)
            return _from_session(issn.graph, issn.sess, None, None, sig)

    @classmethod
    def fromSavedModel(
        cls, saved_model_dir: str, tag_set: str = _SERVE_TAG,
        feed_names: Sequence[str] = (), fetch_names: Sequence[str] = (),
    ) -> "TFInputGraph":
        """From a SavedModel with explicit feed/fetch tensor names.

        TF2 (object-graph) SavedModels freeze through the TF2 loader; the
        feed/fetch names then address the FROZEN graph of the serving
        signature (arg placeholders like ``"x:0"`` plus the inlined body's
        hierarchical op names), since TF2 variables cannot restore into a
        v1 session.
        """
        if _is_tf2_saved_model(saved_model_dir, tag_set):
            return _from_tf2_saved_model(
                saved_model_dir, tag_set, feed_names, fetch_names, None
            )
        with _loaded_saved_model(saved_model_dir, tag_set) as (issn, _meta):
            return _from_session(issn.graph, issn.sess, feed_names, fetch_names, None)

    @classmethod
    def fromSavedModelWithSignature(
        cls, saved_model_dir: str, tag_set: str = _SERVE_TAG,
        signature_def_key: str = _SERVING,
    ) -> "TFInputGraph":
        """From a SavedModel, endpoints resolved through its signature_def.

        Handles both generations: TF1-style SavedModels load into a v1
        session and freeze there; TF2 (object-graph) SavedModels — what
        ``tf.saved_model.save``/Keras export — load through the TF2 loader
        and freeze via ``convert_variables_to_constants_v2``, which also
        inlines the ``tf.function`` call tree, so the result translates
        to torch ops.
        """
        if _is_tf2_saved_model(saved_model_dir, tag_set):
            return _from_tf2_saved_model(
                saved_model_dir, tag_set, None, None, signature_def_key
            )
        with _loaded_saved_model(saved_model_dir, tag_set) as (issn, meta):
            sig = _signature(meta, signature_def_key)
            return _from_session(issn.graph, issn.sess, None, None, sig)


# -- internals -------------------------------------------------------------

def _is_tf2_saved_model(saved_model_dir: str, tag_set: str) -> bool:
    """True when the tagged MetaGraph carries a TF2 object graph (saved by
    ``tf.saved_model.save`` / Keras export): its variables live in the
    object graph and cannot restore into a v1 session."""
    require_tf()
    from tensorflow.python.saved_model import loader_impl

    try:
        sm = loader_impl.parse_saved_model(saved_model_dir)
    except Exception:
        return False
    tags = {t for t in (tag_set or "").split(",") if t}
    for mg in sm.meta_graphs:
        if tags <= set(mg.meta_info_def.tags):
            return len(mg.object_graph_def.nodes) > 0
    return False


def _from_tf2_saved_model(
    saved_model_dir: str, tag_set: str,
    feed_names, fetch_names, signature_def_key: "str | None",
) -> TFInputGraph:
    """TF2 loader + ``convert_variables_to_constants_v2`` freeze.

    The v2 freeze inlines the traced ``tf.function`` call tree
    (PartitionedCall sites and their library bodies) while folding
    variables, so the stored GraphDef is flat and translatable — the
    card's form of the reference's "run any SavedModel" promise
    (SURVEY.md 2.7).
    """
    tf = require_tf()
    from tensorflow.python.framework.convert_to_constants import (
        convert_variables_to_constants_v2,
    )

    tags = [t for t in (tag_set or "").split(",") if t] or None
    obj = tf.saved_model.load(saved_model_dir, tags=tags)
    sigs = dict(obj.signatures)
    if signature_def_key is not None:
        if signature_def_key not in sigs:
            raise KeyError(
                f"signature_def {signature_def_key!r} not found; "
                f"available: {sorted(sigs)}"
            )
        key = signature_def_key
    elif _SERVING in sigs:
        key = _SERVING
    elif len(sigs) == 1:
        key = next(iter(sigs))
    else:
        raise ValueError(
            "TF2 SavedModel with multiple signatures and no "
            f"signature_def_key; available: {sorted(sigs)}"
        )

    cf = sigs[key]
    frozen = convert_variables_to_constants_v2(cf)
    gdef = frozen.graph.as_graph_def(add_shapes=True)

    # signature key -> frozen tensor name. Inputs: the signature wrapper's
    # arg specs are named by signature key and flatten in the same order
    # as the frozen placeholders. Outputs: structured_outputs of the
    # ORIGINAL signature fn keeps the key->tensor dict; the frozen fn's
    # outputs follow the same (key-sorted) flatten order.
    in_specs = [
        s for s in tf.nest.flatten(cf.structured_input_signature)
        if isinstance(s, tf.TensorSpec)
    ]
    in_map = {
        (spec.name or f"input_{i}"): t.name
        for i, (spec, t) in enumerate(zip(in_specs, frozen.inputs))
    }
    so = cf.structured_outputs
    if isinstance(so, dict):
        out_keys = sorted(so)
    else:
        out_keys = [f"output_{i}" for i in range(len(frozen.outputs))]
    out_map = dict(zip(out_keys, (t.name for t in frozen.outputs)))

    if signature_def_key is None and (feed_names or fetch_names):
        input_names = [
            tfx.validated_input(t, frozen.graph) for t in feed_names
        ]
        output_names = [
            tfx.validated_output(t, frozen.graph) for t in fetch_names
        ]
        return TFInputGraph(gdef, None, None, input_names, output_names)

    input_names = [tfx.tensor_name(v) for v in in_map.values()]
    output_names = [tfx.tensor_name(v) for v in out_map.values()]
    return TFInputGraph(gdef, dict(in_map), dict(out_map),
                        input_names, output_names)


def _from_tf_graph(graph: TFGraph, feed_names, fetch_names) -> TFInputGraph:
    input_names = [tfx.tensor_name(t) for t in feed_names]
    output_names = [tfx.tensor_name(t) for t in fetch_names]
    for t in input_names:
        node = graph.by_name.get(tfx.op_name(t))
        if node is None or node.op not in ("Placeholder", "PlaceholderWithDefault"):
            found = "no such node" if node is None else f"op type {node.op!r}"
            raise ValueError(f"input {t!r} must be a Placeholder, found {found}")
    for t in output_names:
        if tfx.op_name(graph.resolve(t)) not in graph.by_name:
            raise KeyError(f"output {t!r} not found in the TFGraph")
    return TFInputGraph(graph, None, None, input_names, output_names)


def _signature(meta_graph_def, key: str):
    sigs = meta_graph_def.signature_def
    if key not in sigs:
        raise KeyError(
            f"signature_def {key!r} not found; available: {sorted(sigs)}"
        )
    sig = sigs[key]
    inputs = {k: v.name for k, v in sig.inputs.items()}
    outputs = {k: v.name for k, v in sig.outputs.items()}
    return inputs, outputs


def _from_session(graph, sess, feed_names, fetch_names, sig) -> TFInputGraph:
    if sig is not None:
        in_map, out_map = sig
        input_names = [tfx.validated_input(t, graph) for t in in_map.values()]
        output_names = [tfx.validated_output(t, graph) for t in out_map.values()]
        in_table = {k: tfx.tensor_name(v) for k, v in in_map.items()}
        out_table = {k: tfx.tensor_name(v) for k, v in out_map.items()}
    else:
        input_names = [tfx.validated_input(t, graph) for t in feed_names]
        output_names = [tfx.validated_output(t, graph) for t in fetch_names]
        in_table = out_table = None
    gdef = strip_and_freeze_upto(sess, graph, output_names)
    return TFInputGraph(gdef, in_table, out_table, input_names, output_names)


class _restored_checkpoint:
    """Context manager: IsolatedSession with a checkpoint restored into it."""

    def __init__(self, checkpoint_dir: str):
        self.checkpoint_dir = checkpoint_dir

    def __enter__(self):
        tf = require_tf()
        ckpt = tf.train.latest_checkpoint(self.checkpoint_dir)
        if ckpt is None:
            raise FileNotFoundError(
                f"no checkpoint found under {self.checkpoint_dir!r}"
            )
        from tensorflow.python.framework import meta_graph as _mg

        meta = _mg.read_meta_graph_file(ckpt + ".meta")
        self._issn = IsolatedSession()
        self._issn.__enter__()
        try:
            saver = tf.compat.v1.train.import_meta_graph(meta, clear_devices=True)
            if saver is not None:
                saver.restore(self._issn.sess, ckpt)
        except BaseException:
            self._issn.__exit__(None, None, None)
            raise
        return self._issn, meta

    def __exit__(self, *exc):
        return self._issn.__exit__(*exc)


class _loaded_saved_model:
    """Context manager: IsolatedSession with a SavedModel loaded into it."""

    def __init__(self, saved_model_dir: str, tag_set: str):
        self.saved_model_dir = saved_model_dir
        self.tags = [t for t in (tag_set or "").split(",") if t]

    def __enter__(self):
        tf = require_tf()
        self._issn = IsolatedSession()
        self._issn.__enter__()
        try:
            meta = tf.compat.v1.saved_model.loader.load(
                self._issn.sess, self.tags, self.saved_model_dir
            )
        except BaseException:
            self._issn.__exit__(None, None, None)
            raise
        return self._issn, meta

    def __exit__(self, *exc):
        return self._issn.__exit__(*exc)
