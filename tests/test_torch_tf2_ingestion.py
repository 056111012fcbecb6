"""TF2 function-call-graph ingestion in the port, against the JAX package
and TF: every case of tests/graph/test_tf2_ingestion.py. A Keras-exported
TF2 SavedModel (the TF2 loader + freeze path), GraphDefs that still carry
call sites (graph/flatten.py inlining before the reader), functional
If/While (library sub-graphs run as Python branches and loops over torch
ops), and duplicate data edges surviving the inlining. The port has no
call_tf path, so every pass here is the translated graph running."""

from __future__ import annotations

import numpy as np
import pytest

tf = pytest.importorskip("tensorflow")

import jax  # noqa: E402
from torch_graph_parity import as_numpy, assert_port_close  # noqa: E402

from sparkdl_torch.graph.builder import GraphFunction  # noqa: E402
from sparkdl_torch.graph.flatten import has_function_calls, inline_function_calls  # noqa: E402
from sparkdl_torch.graph.input import TFInputGraph  # noqa: E402
from sparkdl_torch.graph.reader import read_graph_def  # noqa: E402
from sparkdl_torch.graph.tf2torch import translate_graph, untranslatable_ops  # noqa: E402
from sparkdl_tpu.graph.builder import GraphFunction as JaxGraphFunction  # noqa: E402
from sparkdl_tpu.graph.input import TFInputGraph as JaxTFInputGraph  # noqa: E402

rng = np.random.default_rng(7)

_EXPORT_SCRIPT = """
import sys, numpy as np
import tensorflow as tf

d = sys.argv[1]
rng = np.random.default_rng(7)
inp = tf.keras.Input([4])
h = tf.keras.layers.Dense(8, activation="relu")(inp)
h = tf.keras.layers.BatchNormalization()(h)
out = tf.keras.layers.Dense(3, activation="softmax")(h)
m = tf.keras.Model(inp, out)

@tf.function(input_signature=[tf.TensorSpec([None, 4], tf.float32)])
def serve(x):
    return {"probs": m(x, training=False)}

tf.saved_model.save(m, d, signatures={"serving_default": serve})
x = rng.standard_normal((6, 4)).astype(np.float32)
np.savez(d + "/oracle.npz", x=x, y=m(x, training=False).numpy())
"""


@pytest.fixture(scope="module")
def keras_savedmodel(tmp_path_factory):
    """A Keras-exported TF2 SavedModel + oracle outputs, exported in a
    clean subprocess (the JAX package sets KERAS_BACKEND=jax here)."""
    import os
    import subprocess
    import sys

    d = str(tmp_path_factory.mktemp("tf2sm") / "sm")
    env = dict(os.environ, KERAS_BACKEND="tensorflow", TF_CPP_MIN_LOG_LEVEL="2")
    subprocess.run([sys.executable, "-c", _EXPORT_SCRIPT, d],
                   check=True, env=env, capture_output=True, text=True)
    data = np.load(d + "/oracle.npz")
    return d, data["x"], data["y"]


def _both(gd, ins, outs, *arrays):
    """(port outputs, JAX package outputs) of one GraphDef."""
    port = GraphFunction(gd, ins, outs).to_torch(device="cpu")
    ref = JaxGraphFunction(gd, ins, outs).to_jax(prefer_native=True)
    return [as_numpy(o) for o in port(*arrays)], [np.asarray(o) for o in ref(*arrays)]


def test_keras_tf2_savedmodel_ingests(keras_savedmodel):
    d, x, want = keras_savedmodel
    from tensorflow.python.saved_model import loader_impl

    mg = loader_impl.parse_saved_model(d).meta_graphs[0]
    assert "StatefulPartitionedCall" in {n.op for n in mg.graph_def.node}
    assert len(mg.graph_def.library.function) > 0

    tig = TFInputGraph.fromSavedModelWithSignature(d)
    jig = JaxTFInputGraph.fromSavedModelWithSignature(d)
    assert tig.input_names == jig.input_names and tig.output_names == jig.output_names
    assert untranslatable_ops(tig.graph_def, tig.output_names) == []
    got = as_numpy(tig.to_torch(device="cpu")(x)[0])
    ref = np.asarray(jax.jit(lambda a: jig.to_jax()(a)[0])(x))
    assert_port_close(got, ref)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4)
    om = tig.translateOutputMapping({"probs": "out_col"})
    assert list(om.values()) == ["out_col"]
    assert om == jig.translateOutputMapping({"probs": "out_col"})


def test_tf2_savedmodel_explicit_fetch_names(keras_savedmodel):
    d, x, want = keras_savedmodel
    sig = TFInputGraph.fromSavedModelWithSignature(d)
    tig = TFInputGraph.fromSavedModel(
        d, feed_names=[sig.input_names[0]], fetch_names=[sig.output_names[0]])
    got = as_numpy(tig.to_torch(device="cpu")(x)[0])
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4)


def _concrete_graphdef(fn, *specs):
    cf = fn.get_concrete_function(*specs)
    gd = cf.graph.as_graph_def(add_shapes=True)
    return cf, gd, [t.name for t in cf.inputs], [t.name for t in cf.outputs]


def test_inline_nested_partitioned_calls():
    """Two-level tf.function nesting with a multi-output inner fn and a
    passthrough return — the flatten fixpoint must resolve chains, and
    the reader's aliases map the call's output name to the inlined one."""

    @tf.function
    def inner(x):
        return tf.nn.relu(x) * 2.0, x

    @tf.function
    def mid(x):
        a, b = inner(x)
        return a + b

    @tf.function
    def outer(x):
        return mid(x) - 1.0

    cf, gd, ins, outs = _concrete_graphdef(outer, tf.TensorSpec([None, 3], tf.float32))
    assert has_function_calls(gd)
    flat, flat_outs = inline_function_calls(gd, outs)
    assert not has_function_calls(flat)
    assert untranslatable_ops(flat, flat_outs) == []
    g = read_graph_def(gd, outs)
    assert not {"PartitionedCall", "StatefulPartitionedCall"} & {n.op for n in g.nodes}
    x = rng.standard_normal((4, 3)).astype(np.float32)
    (got,), (ref,) = _both(gd, ins, outs, x)
    assert_port_close(got, ref)
    np.testing.assert_allclose(got, cf(tf.constant(x)).numpy(), atol=1e-6)


def test_functional_if_runs_its_branches():
    @tf.function
    def f(pred, x):
        return tf.cond(pred, lambda: x * 2.0 + 1.0, lambda: -x)

    cf, gd, ins, outs = _concrete_graphdef(
        f, tf.TensorSpec([], tf.bool), tf.TensorSpec([None, 3], tf.float32))
    node_ops = {n.op for n in gd.node} | {n.op for fn_ in gd.library.function
                                          for n in fn_.node_def}
    assert node_ops & {"If", "StatelessIf"}, node_ops
    fn = translate_graph(gd, ins, outs, device="cpu")
    assert fn.host_sync  # the predicate is read to the host
    x = rng.standard_normal((2, 3)).astype(np.float32)
    for pred in (True, False):
        (got,), (ref,) = _both(gd, ins, outs, np.asarray(pred), x)
        assert_port_close(got, ref)
        np.testing.assert_allclose(got, cf(tf.constant(pred), tf.constant(x)).numpy(),
                                   atol=1e-6)


def test_functional_while_runs_its_loop():
    @tf.function
    def f(x):
        i = tf.constant(0)

        def cond(i, acc):
            return i < 5

        def body(i, acc):
            return i + 1, acc + tf.cast(i, tf.float32)

        _, out = tf.while_loop(cond, body, [i, x])
        return out

    cf, gd, ins, outs = _concrete_graphdef(f, tf.TensorSpec([2, 2], tf.float32))
    node_ops = {n.op for n in gd.node} | {n.op for fn_ in gd.library.function
                                          for n in fn_.node_def}
    assert node_ops & {"While", "StatelessWhile"}, node_ops
    x = rng.standard_normal((2, 2)).astype(np.float32)
    (got,), (ref,) = _both(gd, ins, outs, x)
    assert_port_close(got, ref)
    np.testing.assert_allclose(got, cf(tf.constant(x)).numpy(), atol=1e-6)


def test_duplicate_data_edges_survive_inlining():
    """AddN(y, y) where y is a call output: both data edges must survive."""

    @tf.function
    def inner(x):
        return x * 2.0 + 1.0

    @tf.function
    def outer(x):
        y = inner(x)
        return tf.add_n([y, y, y]) * tf.raw_ops.Mul(x=y, y=y)

    cf, gd, ins, outs = _concrete_graphdef(outer, tf.TensorSpec([2, 2], tf.float32))
    x = rng.standard_normal((2, 2)).astype(np.float32)
    (got,), (ref,) = _both(gd, ins, outs, x)
    assert_port_close(got, ref)
    np.testing.assert_allclose(got, cf(tf.constant(x)).numpy(), atol=1e-5)


def test_translate_graph_def_handles_call_sites_directly():
    """translate_graph on a raw call-site GraphDef reads (and inlines) it
    itself: no pre-flatten required."""

    @tf.function
    def inner(x):
        return tf.tanh(x)

    @tf.function
    def outer(x):
        return inner(x) + 0.5

    cf, gd, ins, outs = _concrete_graphdef(outer, tf.TensorSpec([3], tf.float32))
    fn = translate_graph(gd, ins, outs, device="cpu")
    x = rng.standard_normal(3).astype(np.float32)
    np.testing.assert_allclose(as_numpy(fn(x)[0]), cf(tf.constant(x)).numpy(), atol=1e-6)


def test_host_op_inside_function_body_still_surfaces():
    @tf.function
    def inner(x):
        return tf.linalg.inv(x)  # MatrixInverse: outside the surface

    @tf.function
    def outer(x):
        return inner(x) + 1.0

    _, gd, ins, outs = _concrete_graphdef(outer, tf.TensorSpec([3, 3], tf.float32))
    assert "MatrixInverse" in untranslatable_ops(gd, outs)


def test_tf2_transformer_end_to_end(keras_savedmodel):
    """TFTransformer over a DataFrame with a TF2 SavedModel input graph
    matches the JAX package's transformer and the Keras forward."""
    d, x, want = keras_savedmodel
    from sparkdl_torch.dataframe import LocalDataFrame
    from sparkdl_torch.transformers.tf_tensor import TFTransformer
    from sparkdl_tpu.dataframe import LocalDataFrame as JaxLocalDataFrame
    from sparkdl_tpu.transformers.tf_tensor import TFTransformer as JaxTFTransformer

    rows = [{"v": x[i].tolist()} for i in range(len(x))]
    got = TFTransformer(
        tfInputGraph=TFInputGraph.fromSavedModelWithSignature(d),
        inputMapping={"v": "x"}, outputMapping={"probs": "probs"}, device="cpu",
    ).transform(LocalDataFrame.from_rows(rows, 2)).collect()
    ref = JaxTFTransformer(
        tfInputGraph=JaxTFInputGraph.fromSavedModelWithSignature(d),
        inputMapping={"v": "x"}, outputMapping={"probs": "probs"},
    ).transform(JaxLocalDataFrame.from_rows(rows, 2)).collect()
    got = np.asarray([r["probs"] for r in got])
    assert_port_close(got, np.asarray([r["probs"] for r in ref]))
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-3)
