"""The port's TFImageTransformer and TFTransformer against the JAX
package's on the same LocalDataFrame rows: every case of
tests/transformers/test_tf_image.py and test_tf_tensor.py, each also held
to its numpy or TF-session oracle. The port runs with device="cpu" (the
default, "cuda", raises here). Tolerances as tests/torch_graph_parity.py."""

import numpy as np
import pytest

tf = pytest.importorskip("tensorflow")

import torch  # noqa: E402
from torch_graph_parity import assert_port_close  # noqa: E402

from sparkdl_torch import TFImageTransformer, TFTransformer  # noqa: E402
from sparkdl_torch.dataframe.local import LocalDataFrame  # noqa: E402
from sparkdl_torch.graph.builder import IsolatedSession  # noqa: E402
from sparkdl_torch.graph.input import TFInputGraph  # noqa: E402
from sparkdl_torch.image.imageIO import imageArrayToStructBGR, imageStructToArray  # noqa: E402
from sparkdl_torch.transformers import tf_tensor  # noqa: E402
from sparkdl_tpu import TFImageTransformer as JaxTFImageTransformer  # noqa: E402
from sparkdl_tpu import TFTransformer as JaxTFTransformer  # noqa: E402
from sparkdl_tpu.dataframe.local import LocalDataFrame as JaxLocalDataFrame  # noqa: E402
from sparkdl_tpu.graph.input import TFInputGraph as JaxTFInputGraph  # noqa: E402

H = W = 8


def _image_rows(n=6, size=(H, W)):
    rng = np.random.default_rng(5)
    return [{"i": i, "image": imageArrayToStructBGR(
        rng.integers(0, 256, (*size, 3), dtype=np.uint8))} for i in range(n)]


def _both_graphs(build, feeds, fetches):
    """The same TF1 graph ingested by each package (fromGraph)."""
    with IsolatedSession() as issn:
        build()
        gin = TFInputGraph.fromGraph(issn.graph, issn.sess, feeds, fetches)
        jin = JaxTFInputGraph.fromGraph(issn.graph, issn.sess, feeds, fetches)
    return gin, jin


def _image_transform(gin, jin, rows, parts=1, **kw):
    """(port rows, JAX package rows) of one TFImageTransformer setting."""
    ours = TFImageTransformer(graph=gin, device="cpu", **kw).transform(
        LocalDataFrame.from_rows(rows, num_partitions=parts)).collect()
    theirs = JaxTFImageTransformer(graph=jin, **kw).transform(
        JaxLocalDataFrame.from_rows(rows, num_partitions=parts)).collect()
    return ours, theirs


def _mean_graph():
    x = tf.compat.v1.placeholder(tf.float32, [None, H, W, 3], name="img_in")
    tf.identity(tf.reduce_mean(x, axis=[1, 2]), name="means")


@pytest.fixture(scope="module")
def mean_graphs():
    """Graph: batched image -> per-channel spatial mean (rank-4 input)."""
    return _both_graphs(_mean_graph, ["img_in"], ["means"])


def test_vector_mode_matches_numpy_oracle(mean_graphs):
    rows = _image_rows()
    ours, theirs = _image_transform(*mean_graphs, rows, parts=2, inputCol="image",
                                    outputCol="v", batchSize=4)
    for r_in, r_out, r_ref in zip(rows, ours, theirs):
        assert r_out["i"] == r_in["i"]
        assert_port_close(r_out["v"], r_ref["v"])
        rgb = imageStructToArray(r_in["image"])[..., ::-1].astype(np.float32)
        np.testing.assert_allclose(r_out["v"], rgb.mean(axis=(0, 1)), rtol=1e-5, atol=1e-4)


def test_image_output_mode():
    gin, jin = _both_graphs(
        lambda: tf.identity(255.0 - tf.compat.v1.placeholder(
            tf.float32, [None, H, W, 3], name="img_in"), name="inverted"),
        ["img_in"], ["inverted"])
    rows = _image_rows()
    ours, theirs = _image_transform(gin, jin, rows, inputCol="image", outputCol="inv",
                                    outputMode="image")
    for r_in, r_out, r_ref in zip(rows, ours, theirs):
        inv = r_out["inv"]
        assert inv["height"] == H and inv["nChannels"] == 3
        assert inv == r_ref["inv"]  # the same struct, bytes included
        rgb_in = imageStructToArray(r_in["image"])[..., ::-1].astype(np.float32)
        np.testing.assert_allclose(imageStructToArray(inv)[..., ::-1], 255.0 - rgb_in,
                                   atol=1e-4)


def test_rank3_graph_per_row():
    gin, jin = _both_graphs(
        lambda: tf.identity(tf.reduce_max(tf.compat.v1.placeholder(
            tf.float32, [H, W, 3], name="one"), axis=[0, 1]), name="mx"),
        ["one"], ["mx"])
    rows = _image_rows(3)
    ours, theirs = _image_transform(gin, jin, rows, inputCol="image", outputCol="mx")
    for r_in, r_out, r_ref in zip(rows, ours, theirs):
        np.testing.assert_array_equal(r_out["mx"], r_ref["mx"])
        rgb = imageStructToArray(r_in["image"])[..., ::-1].astype(np.float32)
        np.testing.assert_allclose(r_out["mx"], rgb.max(axis=(0, 1)), atol=1e-4)


def test_uint8_image_graph():
    """A graph whose image input is uint8 gets the pixels as uint8."""
    gin, jin = _both_graphs(
        lambda: tf.identity(tf.reduce_mean(tf.cast(tf.compat.v1.placeholder(
            tf.uint8, [None, H, W, 3], name="u8"), tf.float32), axis=[1, 2]), name="m"),
        ["u8"], ["m"])
    rows = _image_rows(3)
    ours, theirs = _image_transform(gin, jin, rows, inputCol="image", outputCol="m")
    for r_in, r_out, r_ref in zip(rows, ours, theirs):
        assert_port_close(r_out["m"], r_ref["m"])
        rgb = imageStructToArray(r_in["image"])[..., ::-1].astype(np.float32)
        np.testing.assert_allclose(r_out["m"], rgb.mean(axis=(0, 1)), rtol=1e-5)


def test_resize_to_static_shape(mean_graphs):
    """Images at the wrong size get host-resized to the graph's (H, W)."""
    rows = _image_rows(4, size=(2 * H, 2 * W))
    ours, theirs = _image_transform(*mean_graphs, rows, inputCol="image", outputCol="v")
    for r_out, r_ref in zip(ours, theirs):
        assert r_out["v"] is not None and len(r_out["v"]) == 3
        assert_port_close(r_out["v"], r_ref["v"])


def test_multi_io_graph_rejected():
    def build():
        a = tf.compat.v1.placeholder(tf.float32, [None, H, W, 3], name="a")
        b = tf.compat.v1.placeholder(tf.float32, [None, H, W, 3], name="b")
        tf.identity(a + b, name="y")

    gin, _ = _both_graphs(build, ["a", "b"], ["y"])
    df = LocalDataFrame.from_rows(_image_rows(2))
    with pytest.raises(ValueError, match="single-input"):
        TFImageTransformer(inputCol="image", outputCol="o", graph=gin,
                           device="cpu").transform(df)


def test_raw_graph_def_with_tensor_names(mean_graphs):
    """A raw GraphDef plus inputTensor/outputTensor, as the reference takes it."""
    gin, _ = mean_graphs
    rows = _image_rows(3)
    out = TFImageTransformer(inputCol="image", outputCol="v", graph=gin.graph_def,
                             inputTensor="img_in", outputTensor="means",
                             device="cpu").transform(LocalDataFrame.from_rows(rows)).collect()
    want = TFImageTransformer(inputCol="image", outputCol="v", graph=gin,
                              device="cpu").transform(LocalDataFrame.from_rows(rows)).collect()
    for a, b in zip(out, want):
        np.testing.assert_array_equal(a["v"], b["v"])


def test_default_device_is_the_card(mean_graphs, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    t = TFImageTransformer(inputCol="image", outputCol="v", graph=mean_graphs[0])
    assert t.getOrDefault("device") == "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t.transform(LocalDataFrame.from_rows(_image_rows(2))).collect()


DIM = 6


def _model():
    x = tf.compat.v1.placeholder(tf.float32, [None, DIM], name="x")
    w = tf.compat.v1.get_variable(
        "w", initializer=np.linspace(-1, 1, DIM * 2, dtype=np.float32).reshape(DIM, 2))
    y = tf.identity(tf.nn.sigmoid(x @ w), name="y")
    z = tf.identity(tf.reduce_sum(x, axis=1, keepdims=True), name="z")
    return x, y, z


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(11)
    return [{"idx": i, "feat": rng.standard_normal(DIM).astype(np.float32)}
            for i in range(13)]


@pytest.fixture(scope="module")
def graphs_and_oracle(data):
    with IsolatedSession() as issn:
        x, y, z = _model()
        issn.run(tf.compat.v1.global_variables_initializer())
        gin = TFInputGraph.fromGraph(issn.graph, issn.sess, ["x"], ["y", "z"])
        jin = JaxTFInputGraph.fromGraph(issn.graph, issn.sess, ["x"], ["y", "z"])
        oracle_y, oracle_z = issn.run([y, z], {x: np.stack([r["feat"] for r in data])})
    return gin, jin, oracle_y, oracle_z


def _tensor_transform(gin, jin, data, parts, **kw):
    ours = TFTransformer(tfInputGraph=gin, device="cpu", **kw).transform(
        LocalDataFrame.from_rows(data, num_partitions=parts)).collect()
    theirs = JaxTFTransformer(tfInputGraph=jin, **kw).transform(
        JaxLocalDataFrame.from_rows(data, num_partitions=parts)).collect()
    return ours, theirs


def test_single_output(graphs_and_oracle, data):
    gin, jin, oracle_y, _ = graphs_and_oracle
    ours, theirs = _tensor_transform(gin, jin, data, 3, inputMapping={"feat": "x"},
                                     outputMapping={"y": "preds"}, batchSize=4)
    got = np.stack([r["preds"] for r in ours])
    assert_port_close(got, np.stack([r["preds"] for r in theirs]))
    np.testing.assert_allclose(got, oracle_y, rtol=1e-5, atol=1e-6)
    assert all("feat" in r and "idx" in r for r in ours)  # passthrough


def test_multi_output(graphs_and_oracle, data):
    gin, jin, oracle_y, oracle_z = graphs_and_oracle
    ours, theirs = _tensor_transform(gin, jin, data, 2, inputMapping={"feat": "x"},
                                     outputMapping={"y": "preds", "z": "sums"})
    for col, oracle in (("preds", oracle_y), ("sums", oracle_z)):
        got = np.stack([r[col] for r in ours])
        assert_port_close(got, np.stack([r[col] for r in theirs]))
        np.testing.assert_allclose(got, oracle, rtol=1e-5, atol=1e-6)


def test_signature_keys(data, tmp_path):
    with IsolatedSession() as issn:
        x, y, _ = _model()
        issn.run(tf.compat.v1.global_variables_initializer())
        oracle = issn.run(y, {x: np.stack([r["feat"] for r in data])})
        d = str(tmp_path / "sm")
        builder = tf.compat.v1.saved_model.Builder(d)
        sig = tf.compat.v1.saved_model.signature_def_utils.predict_signature_def(
            {"features_in": x}, {"preds_out": y})
        builder.add_meta_graph_and_variables(
            issn.sess, ["serve"], signature_def_map={"serving_default": sig})
        builder.save()
    ours, theirs = _tensor_transform(
        TFInputGraph.fromSavedModelWithSignature(d),
        JaxTFInputGraph.fromSavedModelWithSignature(d), data, 2,
        inputMapping={"feat": "features_in"}, outputMapping={"preds_out": "preds"})
    got = np.stack([r["preds"] for r in ours])
    assert_port_close(got, np.stack([r["preds"] for r in theirs]))
    np.testing.assert_allclose(got, oracle, rtol=1e-5, atol=1e-6)


def test_bad_mappings_rejected(graphs_and_oracle, data):
    gin, *_ = graphs_and_oracle
    df = LocalDataFrame.from_rows(data)
    with pytest.raises(ValueError, match="not a graph output"):
        TFTransformer(tfInputGraph=gin, inputMapping={"feat": "x"},
                      outputMapping={"nope": "preds"}, device="cpu").transform(df)
    with pytest.raises(TypeError):
        TFTransformer(tfInputGraph="not a graph")


def test_control_flow_graph_runs_eagerly_with_the_same_rows(data):
    """A graph holding If and While reads its predicates to the host, so
    its runner is pinned eager (chain_k=1: no CUDA-graph capture); its
    rows equal the translated graph's own outputs and the TF session's."""
    def build():
        x = tf.compat.v1.placeholder(tf.float32, [None, DIM], name="x")
        # a predicate on the device, the same for every batch
        pred = tf.reduce_max(tf.constant([0.5, -1.0])) > 0.0
        h = tf.cond(pred, lambda: x * 2.0 + 1.0, lambda: -x)
        _, h = tf.while_loop(lambda i, a: i < 3,
                             lambda i, a: (i + 1, a * 0.5 + tf.tanh(a)), [0, h])
        tf.identity(h, name="y")

    with IsolatedSession() as issn:
        build()
        gin = TFInputGraph.fromGraph(issn.graph, issn.sess, ["x"], ["y"])
        batch = np.stack([r["feat"] for r in data])
        oracle = issn.run("y:0", {"x:0": batch})
    assert {"If", "StatelessIf", "While", "StatelessWhile"} & {
        n.op for n in gin.graph_def.node}
    out = TFTransformer(tfInputGraph=gin, inputMapping={"feat": "x"},
                        outputMapping={"y": "y"}, batchSize=4, device="cpu").transform(
        LocalDataFrame.from_rows(data, num_partitions=2)).collect()
    runner = tf_tensor.graph_runner(gin, 4, "cpu", None)  # the cached runner
    assert runner._chainer.chain_k == 1 and not runner._chainer.graphs
    got = np.stack([r["y"] for r in out])
    fn = gin.to_torch(device="cpu")
    assert fn.host_sync
    direct = np.concatenate([fn(batch[i:i + 4])[0].numpy() for i in range(0, len(batch), 4)])
    np.testing.assert_array_equal(got, direct)
    np.testing.assert_allclose(got, oracle, rtol=1e-5, atol=1e-6)
