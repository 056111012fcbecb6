"""GraphDef -> :class:`~sparkdl_torch.graph.tfgraph.TFGraph`: the host side
of ingestion.

The TF-touching half of the reference's translator (``tf2jax.py``'s attr
plumbing, ``Const`` materialization and FunctionDef conversion), run once
at read time. Function-call sites (``PartitionedCall`` & friends) are
inlined first (graph/flatten.py); the bodies of ``If``/``While`` become
the library's sub-graphs, each read the same way. Reading needs TF
(``tf.make_ndarray`` and TF's FunctionDef converter); what it returns does
not.
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np

from sparkdl_torch.graph import utils as tfx
from sparkdl_torch.graph.tfgraph import TFFunction, TFGraph, TFNode

#: TF DataType enum -> numpy dtype (14, bfloat16, becomes torch.bfloat16;
#: 7, string, numpy's object dtype)
_DTYPES = {
    1: np.float32, 2: np.float64, 3: np.int32, 4: np.uint8, 5: np.int16,
    6: np.int8, 7: object, 9: np.int64, 10: np.bool_, 17: np.uint16,
    19: np.float16, 22: np.uint32, 23: np.uint64,
}


def tf_dtype(enum: int):
    """The numpy dtype (or ``torch.bfloat16``) of a TF DataType enum; None
    for types with no counterpart (resources, variants, references)."""
    if enum == 14:
        import torch

        return torch.bfloat16
    dt = _DTYPES.get(enum)
    return None if dt is None else np.dtype(dt)


def attr_value(a) -> Any:
    """An ``AttrValue`` proto as a Python value (tfgraph.py conventions)."""
    kind = a.WhichOneof("value")
    if kind == "i":
        return int(a.i)
    if kind == "f":
        return float(a.f)
    if kind == "b":
        return bool(a.b)
    if kind == "s":
        return a.s.decode(errors="replace")
    if kind == "type":
        return tf_dtype(a.type)
    if kind == "list":
        if a.list.i:
            return [int(v) for v in a.list.i]
        if a.list.f:
            return [float(v) for v in a.list.f]
        if a.list.s:
            return [v.decode(errors="replace") for v in a.list.s]
        if a.list.type:
            return [tf_dtype(v) for v in a.list.type]
        if a.list.func:
            return [f.name for f in a.list.func]
        return []
    if kind == "shape":
        if a.shape.unknown_rank:
            return None
        return [int(d.size) for d in a.shape.dim]
    if kind == "func":
        return a.func.name
    return None


def _const_value(node) -> "np.ndarray | None":
    """A Const node's tensor as numpy; None for dtypes numpy cannot hold."""
    from sparkdl_torch.graph._tf import require_tf

    tf = require_tf()
    try:
        return np.asarray(tf.make_ndarray(node.attr["value"].tensor))
    except TypeError:
        return None


def _topo(by_name: dict, roots: Sequence[str]) -> list:
    """Names of the nodes feeding ``roots`` (data edges), inputs first."""
    from sparkdl_torch.graph.tf2torch import GraphTranslationError

    order: list[str] = []
    state: dict[str, int] = {}  # 0 = visiting, 1 = done
    for root in roots:
        stack = [(root, False)]
        while stack:
            cur, expanded = stack.pop()
            if state.get(cur) == 1:
                continue
            if expanded:
                state[cur] = 1
                order.append(cur)
                continue
            if state.get(cur) == 0:
                raise GraphTranslationError(f"graph has a cycle through {cur!r}")
            state[cur] = 0
            stack.append((cur, True))
            node = by_name.get(cur)
            if node is None:
                raise GraphTranslationError(f"missing node {cur!r}")
            for inp in node.input:
                if inp.startswith("^"):
                    continue  # control edges: frozen graphs carry no state
                dep = tfx.op_name(inp)
                if state.get(dep) != 1:
                    stack.append((dep, False))
    return order


def read_graph_def(graph_def, output_names: "Sequence[str] | None" = None) -> TFGraph:
    """Read a (frozen) GraphDef into a :class:`TFGraph`.

    With ``output_names``, only the nodes feeding them are read; without,
    every node. Function-call sites are inlined first; the returned
    graph's ``aliases`` map the given output names to the inlined ones.
    Ops are read whatever they are: judging them is the op surface's and
    the translator's job.
    """
    return _read(graph_def, output_names, every_node=output_names is None)


def _read(graph_def, output_names, every_node: bool) -> TFGraph:
    from sparkdl_torch.graph.flatten import (
        has_function_calls,
        inline_function_calls,
    )

    aliases: dict[str, str] = {}
    if has_function_calls(graph_def):
        from sparkdl_torch.graph.tf2torch import GraphTranslationError

        names = list(output_names or [])
        try:
            graph_def, flat = inline_function_calls(graph_def, names)
        except Exception as e:  # TF's converter raises many types
            raise GraphTranslationError(
                f"function-library inlining failed: {e}") from e
        aliases = {tfx.tensor_name(o): tfx.tensor_name(f)
                   for o, f in zip(names, flat) if tfx.tensor_name(o) != tfx.tensor_name(f)}
        output_names = flat

    by_name = {n.name: n for n in graph_def.node}
    roots = ([n.name for n in graph_def.node] if every_node
             else [tfx.op_name(o) for o in output_names])
    fdefs = {f.signature.name: f for f in graph_def.library.function}
    nodes, funcs = [], []
    for name in _topo(by_name, roots):
        node = by_name[name]
        attrs = {k: attr_value(v) for k, v in node.attr.items()}
        for a in node.attr.values():  # func-valued attrs: If/While bodies
            for fname in [a.func.name] + [f.name for f in a.list.func]:
                if fname and fname not in funcs:
                    funcs.append(fname)
        if node.op == "Const":
            attrs["value"] = _const_value(node)
        nodes.append(TFNode(name, node.op,
                            tuple(i for i in node.input if not i.startswith("^")),
                            attrs))
    graph = TFGraph(nodes, aliases=aliases)
    for fname in funcs:
        if fname in fdefs:
            graph.library[fname] = _read_function(fdefs[fname])
    return graph


def _read_function(fdef) -> TFFunction:
    """A library FunctionDef as a :class:`TFFunction` (its own call sites
    inlined, its own If/While bodies read into its library)."""
    from sparkdl_torch.graph._tf import require_tf

    require_tf()
    from tensorflow.python.framework import function_def_to_graph as _fd2g

    sub, nested = _fd2g.function_def_to_graph_def(
        fdef, include_library_functions=True)
    in_names = [f"{a.name}:0" for a in fdef.signature.input_arg]
    out_names = [nested[fdef.ret[a.name]] for a in fdef.signature.output_arg]
    # every node: a body's host ops hang on control edges (an Assert
    # guard) and the op surface must still see them
    graph = _read(sub, out_names, every_node=True)
    return TFFunction(graph, in_names, [graph.resolve(o) for o in out_names])
