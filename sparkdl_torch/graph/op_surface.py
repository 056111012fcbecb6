"""Supported-op surface for TF graph ingestion (SURVEY.md §7 hard part 1).

The reference executed arbitrary TF graphs in a JVM-side TF session
([U: tensorframes], SURVEY.md 2.15), so "supported" meant "any TF op with a
CPU/GPU kernel". Here ingestion rebuilds the frozen graph as torch ops on
the card (graph/tf2torch.py), with no TF at run time, so the support
boundary is **what the translator covers**:

* SUPPORTED — dense math (MatMul/Conv/pooling/elementwise/reductions),
  shape manipulation with static shapes, casts, softmax/activations,
  functional control flow (graph/tf2torch.py ``untranslatable_ops``).
* REJECTED UP FRONT (this module) — op categories that can never run on
  the card: host I/O and filesystem access, python callbacks, string
  processing, hash/lookup tables, queues/readers/datasets, summary
  writers, checkpoint save/restore, TF1 loop primitives, and un-frozen
  variables (freeze first; `strip_and_freeze_upto` does this).
* EVERYTHING ELSE — judged by the translator: an op or attr outside it
  raises ``GraphTranslationError`` naming the node. The prescreen exists
  so the common hopeless cases fail at ingestion time with actionable
  guidance.

`validate_graph_def` is called by `GraphFunction.to_torch()` (pass
``validate=False`` to skip the prescreen and let the translator be the
only judge). It scans a GraphDef or a ``TFGraph`` alike.
"""

from __future__ import annotations

from typing import Any

#: exact op names that cannot run on the card
_REJECT_EXACT = {
    # python callbacks
    "PyFunc", "PyFuncStateless", "EagerPyFunc",
    # host filesystem / IO
    "ReadFile", "WriteFile", "MatchingFiles", "Print", "PrintV2", "Assert",
    # image codecs (host-side work; use sparkdl_torch.image.imageIO /
    # native decode, then feed the decoded tensor)
    "DecodeJpeg", "DecodePng", "DecodeGif", "DecodeBmp", "DecodeImage",
    "EncodeJpeg", "EncodePng", "DecodeRaw", "DecodeCompressed",
    # checkpoint plumbing
    "Save", "SaveV2", "SaveSlices", "Restore", "RestoreV2", "RestoreSlice",
    "MergeV2Checkpoints", "ShardedFilename", "ShardedFilespec",
    # TF1 while-loop primitives (functional While/If translate; raw v1
    # loop graphs are cyclic and do not)
    "Enter", "Exit", "NextIteration", "LoopCond", "RefEnter", "RefExit",
    # misc host-state
    "Mutex", "MutexLock", "MutexV2", "Barrier", "GetSessionHandle",
    "GetSessionTensor", "DeleteSessionTensor", "Placeholder.deprecated",
}

#: op-name prefixes for whole rejected families
_REJECT_PREFIXES = (
    "String",        # string processing has no device representation
    "Regex", "StaticRegex",
    "AsString", "DecodeBase64", "EncodeBase64", "Substr", "UnicodeDecode",
    "ParseExample", "ParseSequenceExample", "ParseSingleExample",
    "DecodeCSV", "DecodeJSONExample", "SerializeTensor", "ParseTensor",
    "LookupTable", "HashTable", "MutableHashTable", "MutableDenseHashTable",
    "InitializeTable", "AnonymousHashTable",
    "Queue", "FIFOQueue", "PaddingFIFOQueue", "RandomShuffleQueue",
    "PriorityQueue", "Reader", "WholeFileReader", "TextLineReader",
    "FixedLengthRecordReader", "TFRecordReader", "IdentityReader",
    "Iterator", "OneShotIterator", "MultiDeviceIterator", "MakeIterator",
    "AnonymousIterator", "DeserializeIterator", "SerializeIterator",
    "BoostedTrees", "TensorForest",
    "Audio", "Summary", "ScalarSummary", "HistogramSummary", "ImageSummary",
    "MergeSummary", "WriteSummary", "CreateSummary",
)

#: variables must be frozen to constants before ingestion
_VARIABLE_OPS = {
    "Variable", "VariableV2", "VarHandleOp", "ReadVariableOp",
    "AssignVariableOp", "AssignAddVariableOp", "AssignSubVariableOp",
    "ResourceGather", "ResourceScatterAdd", "TemporaryVariable",
}

#: ops that match a rejected prefix but are, in fact, device-compilable
_ALLOW_EXACT = {
    "IteratorGetNextSync",  # never seen post-freeze, but harmless
    "SummaryWriter",        # resource handle: unreachable post-freeze
}


class UnsupportedGraphOpsError(ValueError):
    """Raised at ingestion when a frozen graph contains ops that can never
    run on the card. Carries ``violations`` as a list of
    (node_name, op_name, reason)."""

    def __init__(self, violations: list[tuple[str, str, str]]):
        self.violations = violations
        shown = violations[:10]
        lines = "\n".join(
            f"  - node {name!r}: op {op!r} ({reason})"
            for name, op, reason in shown
        )
        more = (
            f"\n  ... and {len(violations) - len(shown)} more"
            if len(violations) > len(shown) else ""
        )
        super().__init__(
            f"graph contains {len(violations)} op(s) outside the "
            f"surface that runs on the card:\n{lines}{more}\n"
            "Remedies: do host-side work (file IO, string parsing, image "
            "decode) outside the graph and feed tensors — imageIO/"
            "native decode covers the image case; freeze variables with "
            "strip_and_freeze_upto; or pass validate=False to skip this "
            "prescreen and let the translator report."
        )


def _classify(op: str) -> str | None:
    """Reason string when ``op`` is outside the surface, else None."""
    if op in _ALLOW_EXACT:
        return None
    if op in _VARIABLE_OPS:
        return "un-frozen variable; freeze to constants first"
    if op in _REJECT_EXACT:
        return "host-side / stateful: cannot run on the card"
    for prefix in _REJECT_PREFIXES:
        if op.startswith(prefix):
            return (
                f"'{prefix}*' family is host-side: cannot run on the "
                "card"
            )
    return None


def _is_tf_graph(graph) -> bool:
    from sparkdl_torch.graph.tfgraph import TFGraph

    return isinstance(graph, TFGraph)


def _referenced_functions(nodes) -> set[str]:
    """Function names referenced from GraphDef ``nodes``' attrs (call ops
    like PartitionedCall carry them in func/list-of-func attr values)."""
    names = set()
    for n in nodes:
        for attr in n.attr.values():
            if attr.func.name:
                names.add(attr.func.name)
            for f in attr.list.func:
                if f.name:
                    names.add(f.name)
    return names


def reachable_nodes(graph_def, output_names) -> list:
    """Main-graph nodes reachable from ``output_names`` via DATA edges.

    Control edges (``^dep``) are deliberately not followed: the translator
    ignores them (frozen graphs carry no state), and a dead Assert/Print
    hooked on only by control dependency never runs — scanning it would
    reject graphs the translator can in fact run. Shared with
    tf2torch.untranslatable_ops (single reachability definition for the
    whole ingestion stack). ``graph_def`` is a GraphDef or a ``TFGraph``.
    """
    if _is_tf_graph(graph_def):
        return graph_def.reachable(output_names)
    by_name = {n.name: n for n in graph_def.node}
    pending = [name.split(":")[0].lstrip("^") for name in output_names]
    seen: set[str] = set()
    reached = []
    while pending:
        cur = pending.pop()
        if cur in seen:
            continue
        seen.add(cur)
        node = by_name.get(cur)
        if node is None:
            continue  # missing node: the translator reports it better
        reached.append(node)
        for inp in node.input:
            if inp.startswith("^"):
                continue
            pending.append(inp.split(":")[0])
    return reached


def _library_bodies(graph, main_nodes):
    """(function name, body nodes) of every library function reachable
    from ``main_nodes``, nested references followed."""
    if _is_tf_graph(graph):
        pending = [(graph, f) for f in graph.referenced_functions(main_nodes)]
        seen: set[int] = set()
        while pending:
            owner, name = pending.pop()
            fn = owner.library[name]
            if id(fn) in seen:
                continue
            seen.add(id(fn))
            body = fn.graph
            yield name, body.nodes
            pending.extend((body, f) for f in body.referenced_functions(body.nodes))
        return
    by_name = {fn.signature.name: fn for fn in graph.library.function}
    pending = _referenced_functions(main_nodes)
    seen_names: set[str] = set()
    while pending:
        name = pending.pop()
        if name in seen_names:
            continue
        seen_names.add(name)
        fn = by_name.get(name)
        if fn is None:
            continue
        yield name, fn.node_def
        pending |= _referenced_functions(fn.node_def) - seen_names


def scan_graph_def(
    graph_def: Any, output_names: "list[str] | None" = None
) -> list[tuple[str, str, str]]:
    """All (node_name, op, reason) violations in ``graph_def`` (a GraphDef
    or a ``TFGraph``) and in the function-library bodies REACHABLE from it
    (defun bodies can hide host ops). Unreachable library functions are
    ignored: TF2 SavedModels keep dead ``__inference__traced_save/restore``
    machinery in the library, and dead save/restore ops can't hurt a
    program that never calls them.

    When ``output_names`` is given, the main-graph scan is likewise
    restricted to the subgraph feeding those outputs, so unpruned frozen
    GraphDefs carrying dead Assert/SaveV2/Print nodes validate the same
    way the pruned ones do (`strip_and_freeze_upto` would drop them).
    """
    violations = []

    def scan_nodes(nodes, where=""):
        for n in nodes:
            reason = _classify(n.op)
            if reason is not None:
                violations.append((where + n.name, n.op, reason))

    if output_names is not None:
        main_nodes = reachable_nodes(graph_def, output_names)
    elif _is_tf_graph(graph_def):
        main_nodes = list(graph_def.nodes)
    else:
        main_nodes = list(graph_def.node)
    scan_nodes(main_nodes)
    for name, body in _library_bodies(graph_def, main_nodes):
        scan_nodes(body, where=f"{name}/")
    return violations


def validate_graph_def(
    graph_def: Any, output_names: "list[str] | None" = None
) -> None:
    """Raise :class:`UnsupportedGraphOpsError` if the graph contains ops
    that can never run on the card; silently pass otherwise (the
    translator remains the final authority). ``output_names`` restricts
    the scan to the output-feeding subgraph."""
    violations = scan_graph_def(graph_def, output_names=output_names)
    if violations:
        raise UnsupportedGraphOpsError(violations)
