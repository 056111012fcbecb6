"""Tensor/op name normalization utilities.

Parity with the reference's name utilities (SURVEY.md 2.9, [U:
python/sparkdl/graph/utils.py]): TF graphs address values by ``"op:idx"``
tensor names while ops are addressed bare; user-facing APIs accept either and
these helpers normalize, optionally validating against a graph.
"""

from __future__ import annotations


def op_name(name, graph=None) -> str:
    """Strip a tensor suffix: ``"dense/Relu:0" -> "dense/Relu"``.

    Accepts a string, tf.Tensor or tf.Operation. With ``graph``, validates
    that the op exists there.
    """
    raw = _as_name(name)
    base = raw.split(":")[0]
    if graph is not None:
        graph.get_operation_by_name(base)  # raises KeyError/ValueError if absent
    return base


def tensor_name(name, graph=None) -> str:
    """Canonical tensor name: append ``:0`` when no output index given."""
    raw = _as_name(name)
    parts = raw.split(":")
    if len(parts) == 1:
        out = f"{raw}:0"
    elif len(parts) == 2:
        if not parts[1].isdigit():
            raise ValueError(f"invalid tensor name {raw!r}")
        out = raw
    else:
        raise ValueError(f"invalid tensor name {raw!r}")
    if graph is not None:
        graph.get_tensor_by_name(out)
    return out


def output_index(name) -> int:
    """Output slot of a tensor reference: ``"op:2" -> 2``, bare op -> 0."""
    raw = _as_name(name)
    parts = raw.split(":")
    if len(parts) == 2 and parts[1].isdigit():
        return int(parts[1])
    if len(parts) == 1:
        return 0
    raise ValueError(f"invalid tensor name {raw!r}")


def get_tensor(name, graph):
    return graph.get_tensor_by_name(tensor_name(name))


def get_op(name, graph):
    return graph.get_operation_by_name(op_name(name))


def validated_input(name, graph) -> str:
    """Tensor name that must be produced by a graph *input* (Placeholder)."""
    t = tensor_name(name, graph)
    op = graph.get_operation_by_name(op_name(t))
    if op.type not in ("Placeholder", "PlaceholderV2", "PlaceholderWithDefault"):
        raise ValueError(
            f"input {name!r} must be a Placeholder, found op type {op.type!r}"
        )
    return t


def validated_output(name, graph) -> str:
    """Tensor name validated to exist in the graph (any producing op)."""
    return tensor_name(name, graph)


def _as_name(obj) -> str:
    if isinstance(obj, str):
        return obj
    name = getattr(obj, "name", None)
    if isinstance(name, str):
        return name
    raise TypeError(f"cannot interpret {type(obj).__name__} as a graph name")
