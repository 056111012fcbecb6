"""The port's GraphFunction / IsolatedSession surgery and image pieces
(sparkdl_torch/graph/builder.py, pieces.py) against the JAX package's:
every case of tests/graph/test_builder.py and tests/graph/test_pieces.py.
GraphFunction files are in the reference's format, so each package loads
the other's."""

import numpy as np
import pytest

tf = pytest.importorskip("tensorflow")

import jax  # noqa: E402
import torch  # noqa: E402
from torch_graph_parity import as_numpy  # noqa: E402

from sparkdl_torch.graph import utils as tfx  # noqa: E402
from sparkdl_torch.graph.builder import (  # noqa: E402
    GraphFunction,
    IsolatedSession,
    placeholder_specs,
)
from sparkdl_torch.graph.pieces import (  # noqa: E402
    buildSpImageConverter,
    image_batch_to_float,
)
from sparkdl_tpu.graph import utils as jtfx  # noqa: E402
from sparkdl_tpu.graph.builder import GraphFunction as JaxGraphFunction  # noqa: E402
from sparkdl_tpu.graph.builder import placeholder_specs as jax_placeholder_specs  # noqa: E402
from sparkdl_tpu.graph.pieces import image_batch_to_float as jax_image_batch_to_float  # noqa: E402


def _linear_gfn(scale: float) -> GraphFunction:
    with IsolatedSession() as issn:
        x = tf.compat.v1.placeholder(tf.float32, [None, 3], name="x")
        y = tf.identity(x * scale, name="y")
        return issn.asGraphFunction([x], [y])


def test_isolated_sessions_do_not_alias():
    with IsolatedSession() as a:
        tf.constant(1.0, name="only_in_a")
        assert a.graph.get_operation_by_name("only_in_a") is not None
    with IsolatedSession() as b:
        with pytest.raises(Exception):
            b.graph.get_operation_by_name("only_in_a")


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_graph_function_roundtrip(tmp_path, writer):
    """dump/load in the reference's format: each package reads a file the
    other wrote, and both run it to the same values."""
    gfn = _linear_gfn(2.0)
    p = str(tmp_path / "fn.gfn")
    (gfn if writer == "port" else JaxGraphFunction(
        gfn.graph_def, gfn.input_names, gfn.output_names)).dump(p)
    loaded, jloaded = GraphFunction.load(p), JaxGraphFunction.load(p)
    assert loaded.input_names == jloaded.input_names == gfn.input_names
    assert loaded.output_names == jloaded.output_names == gfn.output_names
    x = np.ones((2, 3), np.float32)
    (out,) = loaded.to_torch(device="cpu")(x)
    (ref,) = jax.jit(jloaded.to_jax())(x)
    np.testing.assert_array_equal(as_numpy(out), np.asarray(ref))
    np.testing.assert_allclose(as_numpy(out), x * 2.0)


def test_import_graph_function_composes():
    """Splice two GraphFunctions: y = (x*2)*3."""
    double, triple = _linear_gfn(2.0), _linear_gfn(3.0)
    with IsolatedSession() as issn:
        (i1,), (o1,) = issn.importGraphFunction(double, prefix="a")
        (i2,), (o2,) = issn.importGraphFunction(triple, prefix="b")
        composed = issn.run(o2, {i2: issn.run(o1, {i1: np.ones((1, 3), np.float32)})})
    np.testing.assert_allclose(composed, np.full((1, 3), 6.0))


def test_freeze_prunes_dead_nodes():
    with IsolatedSession() as issn:
        x = tf.compat.v1.placeholder(tf.float32, [None, 2], name="x")
        tf.identity(x * 100.0, name="dead_branch")
        y = tf.identity(x + 1.0, name="y")
        gfn = issn.asGraphFunction([x], [y])
    assert "dead_branch" not in {n.name for n in gfn.graph_def.node}


def test_name_utils():
    for mod in (tfx, jtfx):
        assert mod.op_name("a/b:0") == "a/b"
        assert mod.tensor_name("a/b") == "a/b:0"
        assert mod.tensor_name("a/b:1") == "a/b:1"
        with pytest.raises(ValueError):
            mod.tensor_name("a:b:c")
        with pytest.raises(ValueError):
            mod.tensor_name("a:x")


def test_placeholder_specs_match_the_reference():
    """Dtype and shape of each input, from the GraphDef's node attrs, as
    the reference's TensorSpecs give them; unknown dims are None."""
    with IsolatedSession() as issn:
        a = tf.compat.v1.placeholder(tf.float32, [None, 8, 8, 3], name="a")
        b = tf.compat.v1.placeholder(tf.uint8, [4, None], name="b")
        gfn = issn.asGraphFunction([a, b], [tf.identity(a, name="y")], strip_and_freeze=False)
    ours = placeholder_specs(gfn.graph_def, ["a:0", "b"])
    theirs = jax_placeholder_specs(gfn.graph_def, ["a:0", "b"])
    for o, t in zip(ours, theirs):
        assert o.dtype == t.dtype.as_numpy_dtype
        assert o.shape == t.shape.as_list()
    with pytest.raises(KeyError):
        placeholder_specs(gfn.graph_def, ["nope"])


@pytest.fixture(scope="module")
def bgr_image():
    return np.random.default_rng(3).integers(0, 256, (5, 4, 3), dtype=np.uint8)


def _run_piece(gfn, img: np.ndarray) -> np.ndarray:
    h, w, c = img.shape
    with IsolatedSession() as issn:
        ins, outs = issn.importGraphFunction(gfn)
        return issn.run(outs[0], dict(zip(ins, [h, w, c, img.tobytes()])))


def test_sp_image_converter_bgr(bgr_image):
    out = _run_piece(buildSpImageConverter(channelOrder="BGR"), bgr_image)
    np.testing.assert_allclose(out, bgr_image[..., ::-1].astype(np.float32))


def test_sp_image_converter_rgb_passthrough(bgr_image):
    out = _run_piece(buildSpImageConverter(channelOrder="RGB"), bgr_image)
    np.testing.assert_allclose(out, bgr_image.astype(np.float32))


@pytest.mark.parametrize("order", ["BGR", "RGB"])
def test_torch_twin_matches_tf_piece_and_jax_twin(bgr_image, order):
    tf_out = _run_piece(buildSpImageConverter(channelOrder=order), bgr_image)
    out = image_batch_to_float(torch.from_numpy(bgr_image[None]), order)[0]
    assert out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(), tf_out)
    np.testing.assert_array_equal(
        out.numpy(), np.asarray(jax_image_batch_to_float(bgr_image[None], order))[0])


def test_invalid_args_rejected():
    with pytest.raises(ValueError):
        buildSpImageConverter(channelOrder="HSV")
    with pytest.raises(ValueError):
        buildSpImageConverter(img_dtype="int64")
