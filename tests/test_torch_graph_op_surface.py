"""The port's supported-op surface (sparkdl_torch/graph/op_surface.py)
against the JAX package's: every case of tests/graph/test_op_surface.py.
Hopeless graphs fail at ingestion with the same per-node violations in
both packages; clean graphs pass the prescreen and run via to_torch. The
same scan holds for a TFGraph (read, or written in code)."""

from __future__ import annotations

import numpy as np
import pytest

tf = pytest.importorskip("tensorflow")

from torch_graph_parity import as_numpy  # noqa: E402

from sparkdl_torch.graph.builder import IsolatedSession  # noqa: E402
from sparkdl_torch.graph.op_surface import (  # noqa: E402
    UnsupportedGraphOpsError,
    scan_graph_def,
    validate_graph_def,
)
from sparkdl_torch.graph.reader import read_graph_def  # noqa: E402
from sparkdl_torch.graph.tf2torch import GraphTranslationError  # noqa: E402
from sparkdl_tpu.graph.op_surface import scan_graph_def as jax_scan  # noqa: E402


def _graph_fn(build):
    with IsolatedSession() as sess:
        inputs, outputs = build(sess)
        return sess.asGraphFunction(inputs, outputs)


def _same_scan(graph_def, output_names=None):
    """The port's scan of a GraphDef finds the JAX package's (node, op)
    pairs (the reasons are worded for the card), and so does the scan of
    its read TFGraph."""
    ours = scan_graph_def(graph_def, output_names=output_names)
    assert [v[:2] for v in ours] == [
        v[:2] for v in jax_scan(graph_def, output_names=output_names)]
    read = scan_graph_def(read_graph_def(graph_def, output_names), output_names)
    assert sorted(v[:2] for v in read) == sorted(v[:2] for v in ours)
    return ours


def test_clean_mlp_passes_and_runs():
    def build(sess):
        x = tf.compat.v1.placeholder(tf.float32, [None, 4], name="x")
        w = tf.constant(np.ones((4, 3), np.float32) * 0.5)
        return [x], [tf.nn.relu(tf.matmul(x, w), name="y")]

    gfn = _graph_fn(build)
    assert _same_scan(gfn.graph_def) == []
    out = gfn.to_torch(device="cpu")(np.ones((2, 4), np.float32))[0]
    np.testing.assert_allclose(as_numpy(out), np.full((2, 3), 2.0), rtol=1e-6)


def test_decode_jpeg_rejected_with_node_name_and_remedy():
    def build(sess):
        raw = tf.compat.v1.placeholder(tf.string, [], name="raw")
        img = tf.io.decode_jpeg(raw, name="decode")
        return [raw], [tf.cast(img, tf.float32, name="out")]

    gfn = _graph_fn(build)
    _same_scan(gfn.graph_def)
    with pytest.raises(UnsupportedGraphOpsError) as ei:
        gfn.to_torch(device="cpu")
    msg = str(ei.value)
    assert "decode" in msg and "DecodeJpeg" in msg
    assert "imageIO" in msg  # the remedy points at the host-side decoder
    assert ei.value.violations[0][1] == "DecodeJpeg"


def test_pyfunc_rejected():
    def build(sess):
        x = tf.compat.v1.placeholder(tf.float32, [2], name="x")
        return [x], [tf.compat.v1.py_func(lambda a: a * 2, [x], tf.float32, name="py")]

    gfn = _graph_fn(build)
    _same_scan(gfn.graph_def)
    with pytest.raises(UnsupportedGraphOpsError, match="PyFunc"):
        gfn.to_torch(device="cpu")


def test_string_family_rejected_by_prefix():
    def build(sess):
        s = tf.compat.v1.placeholder(tf.string, [None], name="s")
        return [s], [tf.strings.join([s, s], name="joined")]

    gfn = _graph_fn(build)
    violations = _same_scan(gfn.graph_def)
    assert any(op == "StringJoin" for _, op, _ in violations)
    with pytest.raises(UnsupportedGraphOpsError, match="host-side"):
        validate_graph_def(gfn.graph_def)


def test_unfrozen_variable_rejected_with_freeze_hint():
    def build(sess):
        x = tf.compat.v1.placeholder(tf.float32, [None, 2], name="x")
        v = tf.compat.v1.get_variable("w", initializer=np.ones((2, 2), np.float32))
        return [x], [tf.matmul(x, v, name="y")]

    with IsolatedSession() as sess:
        inputs, outputs = build(sess)
        sess.run(tf.compat.v1.global_variables_initializer())
        gfn = sess.asGraphFunction(inputs, outputs, strip_and_freeze=False)
    assert [v[:2] for v in scan_graph_def(gfn.graph_def)] == [
        v[:2] for v in jax_scan(gfn.graph_def)]
    with pytest.raises(UnsupportedGraphOpsError, match="freeze"):
        gfn.to_torch(device="cpu")

    with IsolatedSession() as sess:
        inputs, outputs = build(sess)
        sess.run(tf.compat.v1.global_variables_initializer())
        frozen = sess.asGraphFunction(inputs, outputs)
    assert _same_scan(frozen.graph_def) == []


def test_validate_false_leaves_the_translator_as_judge():
    """The reference returns a callable here (its call_tf path takes the
    graph); the port has no such path, so the translator names the op."""
    def build(sess):
        raw = tf.compat.v1.placeholder(tf.string, [], name="raw")
        img = tf.io.decode_jpeg(raw, name="decode")
        return [raw], [tf.cast(img, tf.float32, name="out")]

    gfn = _graph_fn(build)
    with pytest.raises(GraphTranslationError, match=r"'decode' \(DecodeJpeg\)"):
        gfn.to_torch(device="cpu", validate=False)


def test_dead_nodes_ignored_when_outputs_given():
    with IsolatedSession() as sess:
        x = tf.compat.v1.placeholder(tf.float32, [None, 2], name="x")
        tf.compat.v1.Assert(tf.constant(True), [tf.constant(1.0)], name="dead_assert")
        y = tf.identity(x * 2.0, name="y")
        gfn = sess.asGraphFunction([x], [y], strip_and_freeze=False)

    assert any(op == "Assert" for _, op, _ in _same_scan(gfn.graph_def))
    assert _same_scan(gfn.graph_def, output_names=gfn.output_names) == []
    out = gfn.to_torch(device="cpu")(np.ones((2, 2), np.float32))[0]
    np.testing.assert_allclose(as_numpy(out), np.full((2, 2), 2.0), rtol=1e-6)


def test_violation_list_capped_in_message():
    def build(sess):
        ins, outs = [], []
        for i in range(13):
            s = tf.compat.v1.placeholder(tf.string, [], name=f"s{i}")
            ins.append(s)
            outs.append(tf.strings.length(s, name=f"len{i}"))
        return ins, outs

    gfn = _graph_fn(build)
    with pytest.raises(UnsupportedGraphOpsError) as ei:
        gfn.to_torch(device="cpu")
    assert len(ei.value.violations) == 13
    assert "and 3 more" in str(ei.value)
    assert "card" in str(ei.value)  # the port's wording: what runs on the card
