"""A frozen TF graph as plain data: the hand-off between reading and running.

The port's counterpart of the GraphDef the reference hands to its
translator. Reading a GraphDef, SavedModel or checkpoint needs TensorFlow
and runs on the host (graph/reader.py); running the graph needs only
torch (graph/tf2torch.py). A :class:`TFGraph` sits between the two: node
names, ops, data inputs and attrs as Python values, each ``Const`` value
as a numpy array, and the function library (the bodies of ``If`` and
``While``) as sub-graphs. It imports neither TensorFlow nor protobuf, so
a graph written in code runs where TF is not installed.

Conventions (what the reader produces, and what a graph written in code
must follow):

- ``inputs`` holds data edges only, as ``"node"`` or ``"node:index"``;
  control edges are dropped (a frozen inference graph carries no state);
- ``attrs`` maps each attr name to ``int``, ``float``, ``bool``, ``str``,
  a list of them, a numpy dtype (``torch.bfloat16`` for TF's bfloat16,
  ``None`` for a dtype with no numpy/torch counterpart), a shape as a
  list with -1 for an unknown dim (``None`` for an unknown rank), or a
  function name (``str``) for a func-valued attr; a ``Const``'s
  ``"value"`` is its numpy array;
- ``nodes`` are in topological order: every data input names an earlier
  node.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Iterable

from sparkdl_torch.graph import utils as tfx


@dataclasses.dataclass(frozen=True)
class TFNode:
    """One node: its name, op, data inputs and attrs."""

    name: str
    op: str
    inputs: tuple = ()
    attrs: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(eq=False)
class TFFunction:
    """A library function: its body and the tensor names of its arguments
    (placeholders in ``graph``) and of its results, in signature order."""

    graph: "TFGraph"
    inputs: list
    outputs: list


@dataclasses.dataclass(eq=False)  # identity semantics: used as a cache key
class TFGraph:
    """Nodes in topological order plus the function library.

    ``aliases`` maps a tensor name of the graph as the user wrote it to
    its name after the reader inlined function-call sites (a call node's
    outputs become its body's tensors); :meth:`resolve` applies it.
    """

    nodes: list
    library: dict = dataclasses.field(default_factory=dict)
    aliases: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        self.nodes = list(self.nodes)
        seen: set[str] = set()
        for n in self.nodes:
            if n.name in seen:
                raise ValueError(f"TFGraph has two nodes named {n.name!r}")
            for ref in n.inputs:
                if tfx.op_name(ref) not in seen:
                    raise ValueError(
                        f"TFGraph nodes are not in topological order: node "
                        f"{n.name!r} reads {ref!r} before it is defined")
            seen.add(n.name)
        self.by_name = {n.name: n for n in self.nodes}

    def resolve(self, name: str) -> str:
        """The canonical tensor name that ``name`` addresses here."""
        t = tfx.tensor_name(name)
        return self.aliases.get(t, t)

    def reachable(self, output_names: "Iterable[str] | None") -> list:
        """Nodes feeding ``output_names`` through data edges, in graph
        order (every node when ``output_names`` is None)."""
        if output_names is None:
            return list(self.nodes)
        pending = [tfx.op_name(self.resolve(o)) for o in output_names]
        keep: set[str] = set()
        while pending:
            cur = pending.pop()
            if cur in keep or cur not in self.by_name:
                continue
            keep.add(cur)
            pending.extend(tfx.op_name(i) for i in self.by_name[cur].inputs)
        return [n for n in self.nodes if n.name in keep]

    def referenced_functions(self, nodes: "Iterable[TFNode]") -> list:
        """Library functions named by ``nodes``' attrs, in first-use order."""
        out = []
        for n in nodes:
            for v in n.attrs.values():
                for name in (v if isinstance(v, list) else [v]):
                    if isinstance(name, str) and name in self.library \
                            and name not in out:
                        out.append(name)
        return out


def const(name: str, value: Any) -> TFNode:
    """A ``Const`` node holding ``value`` (converted with ``np.asarray``)."""
    import numpy as np

    arr = np.asarray(value)
    return TFNode(name, "Const", (), {"value": arr, "dtype": arr.dtype})


def placeholder(name: str, dtype: Any, shape: "list | None") -> TFNode:
    """A ``Placeholder`` node; ``shape`` uses -1 (or None) for unknown dims."""
    import numpy as np

    dims = None if shape is None else [-1 if d is None else int(d) for d in shape]
    return TFNode(name, "Placeholder", (), {"dtype": np.dtype(dtype), "shape": dims})
