"""The port's TFInputGraph (sparkdl_torch/graph/input.py) against the JAX
package's: every case of tests/graph/test_input.py. One small model is
exported every way TF can; each export is ingested by both packages and
run, the port as torch ops on the CPU, and both are held to the direct
TF session's output on the same batch (tolerances in
tests/torch_graph_parity.py). Also the TF-free constructor path, a
TFGraph written in code."""

import numpy as np
import pytest

tf = pytest.importorskip("tensorflow")

import jax  # noqa: E402
from torch_graph_parity import as_numpy, assert_port_close  # noqa: E402

from sparkdl_torch.graph import tfgraph as tg  # noqa: E402
from sparkdl_torch.graph.builder import IsolatedSession  # noqa: E402
from sparkdl_torch.graph.input import TFInputGraph  # noqa: E402
from sparkdl_tpu.graph.input import TFInputGraph as JaxTFInputGraph  # noqa: E402

DIM = 4
OUT = 3


def _build_model():
    """y = relu(x @ w + b) with variable weights, TF1-style graph."""
    x = tf.compat.v1.placeholder(tf.float32, [None, DIM], name="x")
    w = tf.compat.v1.get_variable(
        "w", initializer=np.arange(DIM * OUT, dtype=np.float32).reshape(DIM, OUT))
    b = tf.compat.v1.get_variable("b", initializer=np.ones(OUT, np.float32))
    y = tf.identity(tf.nn.relu(tf.matmul(x, w) + b), name="y")
    return x, y


@pytest.fixture(scope="module")
def batch():
    return np.random.default_rng(7).standard_normal((5, DIM)).astype(np.float32)


@pytest.fixture(scope="module")
def oracle(batch):
    with IsolatedSession() as issn:
        x, y = _build_model()
        issn.run(tf.compat.v1.global_variables_initializer())
        return issn.run(y, {x: batch})


def _check(gin, jin, batch, oracle):
    """The port's graph against the JAX package's ingestion of the same
    artifact and against the session."""
    assert gin.input_names == jin.input_names
    assert gin.output_names == jin.output_names
    assert gin.input_tensor_name_from_signature == jin.input_tensor_name_from_signature
    assert gin.output_tensor_name_from_signature == jin.output_tensor_name_from_signature
    (out,) = gin.to_torch(device="cpu")(batch)
    (ref,) = jax.jit(jin.to_jax())(batch)
    assert_port_close(as_numpy(out), np.asarray(ref))
    np.testing.assert_allclose(as_numpy(out), oracle, rtol=1e-5, atol=1e-5)


def test_from_graph(batch, oracle):
    with IsolatedSession() as issn:
        _build_model()
        issn.run(tf.compat.v1.global_variables_initializer())
        gin = TFInputGraph.fromGraph(issn.graph, issn.sess, ["x"], ["y"])
        jin = JaxTFInputGraph.fromGraph(issn.graph, issn.sess, ["x"], ["y"])
    _check(gin, jin, batch, oracle)


def test_from_graph_def(batch, oracle):
    with IsolatedSession() as issn:
        _build_model()
        issn.run(tf.compat.v1.global_variables_initializer())
        gin0 = TFInputGraph.fromGraph(issn.graph, issn.sess, ["x"], ["y:0"])
    gin = TFInputGraph.fromGraphDef(gin0.graph_def, ["x:0"], ["y:0"])
    jin = JaxTFInputGraph.fromGraphDef(gin0.graph_def, ["x:0"], ["y:0"])
    _check(gin, jin, batch, oracle)


@pytest.fixture(scope="module")
def checkpoint_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("ckpt")
    with IsolatedSession() as issn:
        x, y = _build_model()
        issn.run(tf.compat.v1.global_variables_initializer())
        saver = tf.compat.v1.train.Saver()
        path = saver.save(issn.sess, str(d / "model"))
        meta = saver.export_meta_graph()
        sig = tf.compat.v1.saved_model.signature_def_utils.predict_signature_def(
            {"input_sig": x}, {"output_sig": y})
        meta.signature_def["serving_default"].CopyFrom(sig)
        with open(path + ".meta", "wb") as f:
            f.write(meta.SerializeToString())
    return str(d)


def test_from_checkpoint(checkpoint_dir, batch, oracle):
    _check(TFInputGraph.fromCheckpoint(checkpoint_dir, ["x"], ["y"]),
           JaxTFInputGraph.fromCheckpoint(checkpoint_dir, ["x"], ["y"]), batch, oracle)


def test_from_checkpoint_with_signature(checkpoint_dir, batch, oracle):
    gin = TFInputGraph.fromCheckpointWithSignature(checkpoint_dir)
    assert gin.input_tensor_name_from_signature == {"input_sig": "x:0"}
    assert gin.output_tensor_name_from_signature == {"output_sig": "y:0"}
    _check(gin, JaxTFInputGraph.fromCheckpointWithSignature(checkpoint_dir), batch, oracle)


@pytest.fixture(scope="module")
def saved_model_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("savedmodel") / "model"
    with IsolatedSession() as issn:
        x, y = _build_model()
        issn.run(tf.compat.v1.global_variables_initializer())
        builder = tf.compat.v1.saved_model.Builder(str(d))
        sig = tf.compat.v1.saved_model.signature_def_utils.predict_signature_def(
            {"input_sig": x}, {"output_sig": y})
        builder.add_meta_graph_and_variables(
            issn.sess, ["serve"], signature_def_map={"serving_default": sig})
        builder.save()
    return str(d)


def test_from_saved_model(saved_model_dir, batch, oracle):
    kw = dict(tag_set="serve", feed_names=["x"], fetch_names=["y"])
    _check(TFInputGraph.fromSavedModel(saved_model_dir, **kw),
           JaxTFInputGraph.fromSavedModel(saved_model_dir, **kw), batch, oracle)


def test_from_saved_model_with_signature(saved_model_dir, batch, oracle):
    _check(TFInputGraph.fromSavedModelWithSignature(saved_model_dir),
           JaxTFInputGraph.fromSavedModelWithSignature(saved_model_dir), batch, oracle)


def test_translate_mappings(saved_model_dir):
    gin = TFInputGraph.fromSavedModelWithSignature(saved_model_dir)
    jin = JaxTFInputGraph.fromSavedModelWithSignature(saved_model_dir)
    for g in (gin, jin):
        assert g.translateInputMapping({"features": "input_sig"}) == {"features": "x:0"}
        assert g.translateOutputMapping({"output_sig": "preds"}) == {"y:0": "preds"}
        with pytest.raises(KeyError):
            g.translateInputMapping({"features": "nope"})


def test_non_placeholder_input_rejected():
    with IsolatedSession() as issn:
        _build_model()
        issn.run(tf.compat.v1.global_variables_initializer())
        with pytest.raises(ValueError, match="Placeholder"):
            TFInputGraph.fromGraph(issn.graph, issn.sess, ["y"], ["y"])


def test_from_tf2_object_based_saved_model(tmp_path):
    """Modern (TF2 object-based, function-traced) SavedModels ingest through
    the same constructor as TF1 frozen-graph ones."""

    class M(tf.Module):
        def __init__(self):
            self.w = tf.Variable(tf.random.normal([8, 4], seed=1))

        @tf.function(input_signature=[tf.TensorSpec([None, 8], tf.float32)])
        def serve(self, x):
            return {"y": tf.nn.relu(x @ self.w)}

    m = M()
    d = str(tmp_path / "tf2sm")
    tf.saved_model.save(m, d, signatures={"serving_default": m.serve})
    x = np.random.default_rng(0).standard_normal((3, 8)).astype(np.float32)
    out = as_numpy(TFInputGraph.fromSavedModelWithSignature(d).asGraphFunction()
                   .to_torch(device="cpu")(x)[0])
    ref = np.asarray(JaxTFInputGraph.fromSavedModelWithSignature(d).asGraphFunction()
                     .to_jax()(x)[0])
    assert_port_close(out, ref)
    np.testing.assert_allclose(out, np.maximum(x @ m.w.numpy(), 0), atol=1e-5)


def test_from_tf_graph_written_in_code(batch, oracle):
    """fromGraphDef takes a TFGraph built in code, with no TF: the same
    model as above, its names checked against the nodes."""
    w = np.arange(DIM * OUT, dtype=np.float32).reshape(DIM, OUT)
    f32 = np.dtype("float32")
    g = tg.TFGraph([
        tg.placeholder("x", f32, [None, DIM]),
        tg.const("w", w), tg.const("b", np.ones(OUT, np.float32)),
        tg.TFNode("MatMul", "MatMul", ("x", "w"), {"T": f32}),
        tg.TFNode("add", "AddV2", ("MatMul", "b"), {"T": f32}),
        tg.TFNode("Relu", "Relu", ("add",), {"T": f32}),
        tg.TFNode("y", "Identity", ("Relu",), {"T": f32}),
    ])
    gin = TFInputGraph.fromGraphDef(g, ["x"], ["y"])
    assert gin.input_names == ["x:0"] and gin.output_names == ["y:0"]
    np.testing.assert_allclose(as_numpy(gin.to_torch(device="cpu")(batch)[0]), oracle,
                               rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="Placeholder"):
        TFInputGraph.fromGraphDef(g, ["w"], ["y"])
    with pytest.raises(KeyError, match="nope"):
        TFInputGraph.fromGraphDef(g, ["x"], ["nope"])


def test_to_tf_input_graph_converter(saved_model_dir):
    """SparkDLTypeConverters.toTFInputGraph passes the port's TFInputGraph
    through and refuses anything else (the reference's own included), as
    the reference's converter does with its own."""
    from sparkdl_torch.param import SparkDLTypeConverters
    from sparkdl_tpu.param import SparkDLTypeConverters as JaxConverters

    gin = TFInputGraph.fromSavedModelWithSignature(saved_model_dir)
    jin = JaxTFInputGraph.fromSavedModelWithSignature(saved_model_dir)
    assert SparkDLTypeConverters.toTFInputGraph(gin) is gin
    assert JaxConverters.toTFInputGraph(jin) is jin
    for bad in (jin, "graph.pb", None):
        with pytest.raises(TypeError, match="TFInputGraph"):
            SparkDLTypeConverters.toTFInputGraph(bad)
    with pytest.raises(TypeError, match="TFInputGraph"):
        JaxConverters.toTFInputGraph("graph.pb")
