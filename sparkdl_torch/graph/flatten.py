"""Function-library inlining: flatten PartitionedCall graphs for translation.

TF2 tracing compiles every ``tf.function`` into a FunctionDef and leaves a
``PartitionedCall``/``StatefulPartitionedCall`` node (or a node whose op IS
the function name, for legacy defuns) in the calling graph. The reference
executed such graphs in a real TF session where function calls are native
(SURVEY.md 2.7/2.18); the port reads a flat node list into a ``TFGraph``
(graph/reader.py) on the host, so call sites are flattened first. ``inline_function_calls``
splices each called function's body into the main graph — bodies converted
through TF's ``function_def_to_graph_def`` (which resolves the
``node:out_arg:idx`` nested tensor syntax to flat ``node:idx`` form),
prefixed with the call-site name for uniqueness, arg placeholders replaced
by the call's actual inputs, and every consumer of a call output rewired to
the corresponding body tensor. Iterates to a fixpoint so nested calls
(functions calling functions) flatten too.

Functional control flow (``If``/``While`` families) is NOT a call site —
their bodies are read into the ``TFGraph``'s library and run as Python
branches and loops over torch ops (graph/tf2torch.py).
"""

from __future__ import annotations

from typing import Any, Sequence

_CALL_OPS = ("PartitionedCall", "StatefulPartitionedCall")

#: nested-call depth guard; real model graphs nest a handful deep
_MAX_ROUNDS = 64


def _split(ref: str) -> tuple[str, int]:
    """'node:3' -> ('node', 3); 'node' -> ('node', 0) (data refs only)."""
    if ":" in ref:
        name, idx = ref.rsplit(":", 1)
        return name, int(idx)
    return ref, 0


def has_function_calls(graph_def) -> bool:
    lib = {f.signature.name for f in graph_def.library.function}
    return any(
        n.op in _CALL_OPS or n.op in lib for n in graph_def.node
    )


def _call_target(node, lib) -> "str | None":
    """Function name a node calls, or None if it is not a call site."""
    if node.op in _CALL_OPS:
        f = node.attr["f"].func.name
        return f or None
    if node.op in lib:
        return node.op
    return None


def inline_function_calls(
    graph_def, output_names: Sequence[str]
) -> tuple[Any, list[str]]:
    """Return ``(flat_graph_def, new_output_names)`` with every call site
    spliced out. No-op (same objects) when the graph has no call sites.

    Control edges: a call node's control inputs are copied onto every
    inlined body node; a control edge *to* a call node becomes control
    edges to the ops producing its return values. The reader drops control
    edges entirely (frozen inference graphs carry no state), so this only
    preserves ordering for any TF re-execution of the flattened graph.
    """
    lib = {f.signature.name: f for f in graph_def.library.function}
    if not has_function_calls(graph_def):
        return graph_def, list(output_names)

    from sparkdl_torch.graph._tf import require_tf

    require_tf()
    from tensorflow.python.framework import (
        function_def_to_graph as _fd2g,
    )

    gd = type(graph_def)()
    gd.CopyFrom(graph_def)

    for _ in range(_MAX_ROUNDS):
        calls = [n for n in gd.node if _call_target(n, lib)]
        if not calls:
            break
        existing = {n.name for n in gd.node}
        new_nodes = []
        #: call-site name -> (output idx -> replacement data ref,
        #:                    control-target op names)
        repl: dict[str, tuple[dict[int, str], list[str]]] = {}

        for n in gd.node:
            fname = _call_target(n, lib)
            if fname is None:
                new_nodes.append(n)
                continue
            fdef = lib[fname]
            sub, nested = _fd2g.function_def_to_graph_def(fdef)
            prefix = n.name + "/"
            while any(name.startswith(prefix) for name in existing):
                prefix = prefix[:-1] + "_inlined/"
            arg_names = [a.name for a in fdef.signature.input_arg]
            data_in = [i for i in n.input if not i.startswith("^")]
            ctrl_in = [i for i in n.input if i.startswith("^")]
            if len(data_in) != len(arg_names):
                raise ValueError(
                    f"call node {n.name!r} feeds {len(data_in)} args to "
                    f"{fname!r} which declares {len(arg_names)}"
                )
            argmap = dict(zip(arg_names, data_in))

            for bn in sub.node:
                if bn.op == "Placeholder" and bn.name in argmap:
                    continue  # arg: consumers rewire to the call input
                nn = type(bn)()
                nn.CopyFrom(bn)
                nn.name = prefix + bn.name
                rewired = []
                for inp in bn.input:
                    is_ctrl = inp.startswith("^")
                    name, idx = _split(inp.lstrip("^"))
                    if name in argmap:
                        tgt = argmap[name]
                        rewired.append(
                            "^" + _split(tgt)[0] if is_ctrl else tgt
                        )
                    elif is_ctrl:
                        rewired.append("^" + prefix + name)
                    else:
                        rewired.append(f"{prefix}{name}:{idx}")
                # the call's control deps gate every inlined node
                rewired.extend(c for c in ctrl_in if c not in rewired)
                del nn.input[:]
                nn.input.extend(rewired)
                new_nodes.append(nn)
                existing.add(nn.name)

            outmap: dict[int, str] = {}
            ctrl_tgts: list[str] = []
            for i, oarg in enumerate(fdef.signature.output_arg):
                flat = nested[fdef.ret[oarg.name]]
                name, idx = _split(flat)
                if name in argmap:  # passthrough: fn returns an arg as-is
                    outmap[i] = argmap[name]
                else:
                    outmap[i] = f"{prefix}{name}:{idx}"
                ctrl_tgts.append(_split(outmap[i])[0])
            repl[n.name] = (outmap, ctrl_tgts)

        def _resolve_data(ref: str) -> str:
            # chains happen when a call's passthrough return is another
            # call's output replaced in the same round
            seen = set()
            while True:
                name, idx = _split(ref)
                entry = repl.get(name)
                if entry is None:
                    return ref
                if (name, idx) in seen:
                    raise ValueError(
                        f"cyclic call passthrough at {name!r}:{idx}"
                    )
                seen.add((name, idx))
                ref = entry[0][idx]

        def _resolve_ctrl(op: str) -> "list[str]":
            entry = repl.get(op)
            if entry is None:
                return [op]
            out = []
            for t in entry[1]:
                for r in _resolve_ctrl(t):
                    if r not in out:
                        out.append(r)
            return out

        def _rewrite(ref: str) -> "list[str]":
            if ref.startswith("^"):
                return ["^" + t for t in _resolve_ctrl(ref[1:])]
            return [_resolve_data(ref)]

        for n in new_nodes:
            rewired = []
            for inp in n.input:
                for r in _rewrite(inp):
                    # dedup CONTROL edges only — duplicate data edges are
                    # meaningful (AddN(y, y), Mul(y, y)) and must survive
                    if r.startswith("^"):
                        if r not in rewired:
                            rewired.append(r)
                    else:
                        rewired.append(r)
            del n.input[:]
            n.input.extend(rewired)

        del gd.node[:]
        gd.node.extend(new_nodes)

        output_names = [
            _rewrite(o)[0] for o in output_names
        ]
    else:
        raise ValueError(
            f"function-call nesting exceeded {_MAX_ROUNDS} inline rounds "
            "— cyclic function library?"
        )

    return gd, list(output_names)
