"""Shared helpers for the TF-graph ingestion parity tests: the same frozen
GraphDef through TF, the JAX package's translator and the port's, on the
same numpy inputs.

Tolerances: port vs JAX package, float32, within ``PORT_TOL`` of max|ref|
(both are float32 op-for-op rebuilds of one graph; only the summation
order of convolutions and matrix products differs); integers, argmax and
shapes exact. Against TF itself the JAX suite's own tolerance (atol 1e-5,
rtol 1e-4): TF on this CPU runs oneDNN kernels (TF_ENABLE_ONEDNN_OPTS),
whose blocked summation differs from both rebuilds by more than 1e-5
relative on some elements.
"""

from __future__ import annotations

import numpy as np

PORT_TOL = 1e-5
TF_ATOL, TF_RTOL = 1e-5, 1e-4


def assert_port_close(got, want, tol: float = PORT_TOL) -> None:
    """``got`` equals ``want`` exactly for integer/bool dtypes, within
    ``tol`` x max|want| for floats; shapes always exact."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    if not np.issubdtype(want.dtype, np.floating):
        np.testing.assert_array_equal(got, want)
        return
    scale = max(float(np.abs(want).max(initial=0.0)), 1e-30)
    err = float(np.abs(got.astype(np.float64) - want).max(initial=0.0))
    assert err <= tol * scale, f"max |diff| {err:.3e} > {tol} x max|ref| {scale:.3e}"


def as_numpy(x) -> np.ndarray:
    import torch

    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.detach().cpu().numpy()
    return np.asarray(x)


def to_graph_def(graph):
    """A ``TFGraph`` written back as a GraphDef (test-only: it needs TF),
    so TF and the JAX package can run a graph built in code. Attr values
    map back by type: bool, int, float, str, numpy dtype, lists of them,
    shapes under "shape", a Const's "value"."""
    import tensorflow as tf

    gd = tf.compat.v1.GraphDef()
    for n in graph.nodes:
        nd = gd.node.add()
        nd.name, nd.op = n.name, n.op
        nd.input.extend(n.inputs)
        for key, value in n.attrs.items():
            a = nd.attr[key]
            if key == "value" and n.op == "Const":
                a.tensor.CopyFrom(tf.make_tensor_proto(value))
            elif key == "shape":
                if value is None:
                    a.shape.unknown_rank = True
                else:
                    a.shape.CopyFrom(tf.TensorShape(
                        [None if d < 0 else d for d in value]).as_proto())
            elif isinstance(value, bool):
                a.b = value
            elif isinstance(value, int):
                a.i = value
            elif isinstance(value, float):
                a.f = value
            elif isinstance(value, str):
                a.s = value.encode()
            elif isinstance(value, np.dtype):
                a.type = tf.as_dtype(value).as_datatype_enum
            elif isinstance(value, list) and all(isinstance(v, int) for v in value):
                a.list.i.extend(value)
            else:
                raise TypeError(f"attr {key}={value!r} of {n.name} has no GraphDef form")
    return gd
