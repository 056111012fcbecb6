"""The port's GraphDef -> torch translator (sparkdl_torch/graph/tf2torch.py)
against the JAX package's GraphDef -> JAX translator and TF itself: every
case of tests/graph/test_tf2jax.py, the same frozen graph and numpy inputs
through all three (tolerances in tests/torch_graph_parity.py). The
reference's three call_tf fallback cases become checks that the port
raises, naming what is missing: the port has no fallback."""

from __future__ import annotations

import numpy as np
import pytest

tf = pytest.importorskip("tensorflow")

import jax  # noqa: E402
import torch  # noqa: E402
from torch_graph_parity import (  # noqa: E402
    TF_ATOL,
    TF_RTOL,
    as_numpy,
    assert_port_close,
)

from sparkdl_torch.graph import tf2torch  # noqa: E402
from sparkdl_torch.graph.builder import GraphFunction, IsolatedSession  # noqa: E402
from sparkdl_torch.graph.reader import read_graph_def  # noqa: E402
from sparkdl_torch.graph.tf2torch import (  # noqa: E402
    GraphTranslationError,
    translate_graph,
    untranslatable_ops,
)
from sparkdl_tpu.graph.tf2jax import translate_graph_def as jax_translate  # noqa: E402
from sparkdl_tpu.graph.tf2jax import untranslatable_ops as jax_untranslatable  # noqa: E402

v1 = tf.compat.v1


def _freeze(build):
    """Run ``build()`` in an IsolatedSession; returns (gfn, oracle_fn)."""
    with IsolatedSession() as sess:
        inputs, outputs = build()
        sess.run(v1.global_variables_initializer())
        gfn = sess.asGraphFunction(inputs, outputs)

    def oracle(*arrays):
        with IsolatedSession() as s2:
            ins, outs = s2.importGraphFunction(gfn)
            return s2.run(outs, feed_dict=dict(zip(ins, arrays)))

    return gfn, oracle


def _port(gfn, *arrays, **kw):
    fn = translate_graph(gfn.graph_def, gfn.input_names, gfn.output_names,
                         device="cpu", **kw)
    return [as_numpy(o) for o in fn(*arrays)]


def _jax(gfn, *arrays, **kw):
    fn = jax_translate(gfn.graph_def, gfn.input_names, gfn.output_names, **kw)
    return [np.asarray(o) for o in jax.jit(fn)(*arrays)]


def _check(build, *arrays, atol=TF_ATOL):
    gfn, oracle = _freeze(build)
    assert untranslatable_ops(gfn.graph_def) == []
    assert jax_untranslatable(gfn.graph_def) == []
    got, ref, want = _port(gfn, *arrays), _jax(gfn, *arrays), oracle(*arrays)
    assert len(got) == len(ref) == len(want)
    for g, r, w in zip(got, ref, want):
        assert_port_close(g, r)
        np.testing.assert_allclose(g, np.asarray(w), atol=atol, rtol=TF_RTOL)
    return gfn


rng = np.random.default_rng(0)


def test_cnn_conv_bn_pool_dense_softmax():
    """The shape of every frozen Keras CNN: conv/BN-eval/relu/pool stacks
    into a flatten + dense + softmax head, including Shape-math flatten."""
    x_np = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)

    def build():
        x = v1.placeholder(tf.float32, [None, 16, 16, 3], name="x")
        k = v1.get_variable(
            "k", initializer=rng.standard_normal((3, 3, 3, 8))
            .astype(np.float32) * 0.2)
        h = tf.nn.conv2d(x, k, strides=[1, 1, 1, 1], padding="SAME")
        h = tf.nn.bias_add(h, tf.constant(np.zeros(8, np.float32) + 0.1))
        mean = tf.constant(rng.standard_normal(8).astype(np.float32) * 0.1)
        var = tf.constant(np.abs(rng.standard_normal(8)).astype(np.float32))
        gamma = tf.constant(np.ones(8, np.float32))
        beta = tf.constant(np.zeros(8, np.float32))
        h, _, _ = tf.compat.v1.nn.fused_batch_norm(
            h, gamma, beta, mean, var, epsilon=1e-3, is_training=False)
        h = tf.nn.relu(h)
        h = tf.nn.max_pool2d(h, 2, 2, "VALID")
        h = tf.nn.avg_pool2d(h, 3, 1, "SAME")
        shp = tf.shape(h)
        flat = tf.reshape(h, tf.stack([shp[0], 8 * 8 * 8]))
        w = v1.get_variable(
            "w", initializer=rng.standard_normal((8 * 8 * 8, 5))
            .astype(np.float32) * 0.05)
        y = tf.nn.softmax(tf.matmul(flat, w), name="y")
        return [x], [y]

    gfn = _check(build, x_np)
    # and through the public ingestion surface
    (out,) = gfn.to_torch(device="cpu")(x_np)
    assert out.shape == (2, 5) and out.device.type == "cpu"


def test_depthwise_conv_matches_tf():
    x_np = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)

    def build():
        x = v1.placeholder(tf.float32, [None, 8, 8, 4], name="x")
        k = tf.constant(rng.standard_normal((3, 3, 4, 2)).astype(np.float32) * 0.3)
        y = tf.nn.depthwise_conv2d(x, k, strides=[1, 2, 2, 1], padding="SAME", name="y")
        return [x], [y]

    _check(build, x_np)


def test_strided_conv_valid_and_dilation():
    x_np = rng.standard_normal((1, 12, 12, 3)).astype(np.float32)

    def build():
        x = v1.placeholder(tf.float32, [None, 12, 12, 3], name="x")
        k = tf.constant(rng.standard_normal((3, 3, 3, 6)).astype(np.float32) * 0.2)
        y = tf.nn.conv2d(x, k, strides=[1, 1, 1, 1], padding="VALID",
                         dilations=[1, 2, 2, 1], name="y")
        return [x], [y]

    _check(build, x_np)


def test_matmul_transpose_flags_and_reductions():
    a_np = rng.standard_normal((4, 6)).astype(np.float32)

    def build():
        a = v1.placeholder(tf.float32, [None, 6], name="a")
        b = tf.constant(rng.standard_normal((5, 6)).astype(np.float32))
        m = tf.matmul(a, b, transpose_b=True)
        s = tf.reduce_mean(m, axis=1, keepdims=True)
        t = tf.reduce_sum(m, axis=[0])
        return [a], [m, s, t]

    _check(build, a_np)


def test_elementwise_menagerie():
    x_np = np.abs(rng.standard_normal((3, 7)).astype(np.float32)) + 0.1

    def build():
        x = v1.placeholder(tf.float32, [None, 7], name="x")
        y = tf.sqrt(x) + tf.math.rsqrt(x) * tf.sigmoid(x)
        y = tf.tanh(y) - tf.nn.relu6(y) + tf.nn.elu(-y)
        y = tf.clip_by_value(y * tf.exp(-x), -2.0, 2.0)
        y = tf.where(x > 0.5, y, tf.zeros_like(y))
        return [x], [y]

    _check(build, x_np)


def test_concat_split_transpose_pad():
    x_np = rng.standard_normal((2, 4, 6)).astype(np.float32)

    def build():
        x = v1.placeholder(tf.float32, [None, 4, 6], name="x")
        a, b = tf.split(x, 2, axis=2)
        y = tf.concat([b, a], axis=2)
        y = tf.transpose(y, [0, 2, 1])
        y = tf.pad(y, [[0, 0], [1, 1], [0, 2]])
        return [x], [y]

    _check(build, x_np)


def test_strided_slice_shrink_mask():
    x_np = rng.standard_normal((5, 4, 3)).astype(np.float32)

    def build():
        x = v1.placeholder(tf.float32, [None, 4, 3], name="x")
        return [x], [tf.identity(x[:, 1, :2], name="y")]

    _check(build, x_np)


def test_resize_bilinear_matches_tf():
    x_np = rng.standard_normal((2, 8, 10, 3)).astype(np.float32)

    def build():
        x = v1.placeholder(tf.float32, [None, 8, 10, 3], name="x")
        y = tf.compat.v1.image.resize_bilinear(
            x, [16, 20], half_pixel_centers=True, name="y")
        return [x], [y]

    _check(build, x_np, atol=1e-4)


def test_resize_bilinear_tf1_legacy_convention_matches_tf():
    """half_pixel_centers=False (the TF1 frozen-graph default) uses the
    legacy src = dst * scale sampling — must match TF exactly, not be
    silently approximated by the half-pixel path."""
    x_np = rng.standard_normal((2, 7, 9, 3)).astype(np.float32)

    def build():
        x = v1.placeholder(tf.float32, [None, 7, 9, 3], name="x")
        y = tf.compat.v1.image.resize_bilinear(
            x, [13, 5], half_pixel_centers=False, name="y")
        return [x], [y]

    _check(build, x_np, atol=1e-5)


def test_resize_nearest_half_pixel_on_uint8_matches_tf():
    """ResizeNearestNeighbor (half-pixel centers, TF2's default) on uint8
    pixels keeps the dtype and picks TF's source pixels exactly."""
    x_np = rng.integers(0, 256, (2, 7, 9, 3)).astype(np.uint8)

    def build():
        x = v1.placeholder(tf.uint8, [None, 7, 9, 3], name="x")
        y = tf.compat.v1.image.resize_nearest_neighbor(
            x, [13, 5], half_pixel_centers=True, name="y")
        return [x], [y]

    _check(build, x_np)


def test_attr_level_gap_raises_naming_node_and_attr():
    """Ops all covered by name, but an attr (align_corners resize) is
    outside the surface: the reference latches call_tf at the first call;
    the port raises GraphTranslationError naming the node and the attr,
    on every call (no latch, no TF)."""
    x_np = rng.standard_normal((2, 8, 8, 3)).astype(np.float32)

    def build():
        x = v1.placeholder(tf.float32, [None, 8, 8, 3], name="x")
        y = tf.compat.v1.image.resize_bilinear(x, [16, 16], align_corners=True, name="y")
        return [x], [y]

    gfn, _ = _freeze(build)
    assert untranslatable_ops(gfn.graph_def) == []  # names all covered
    fn = gfn.to_torch(device="cpu")
    for _ in range(2):
        with pytest.raises(GraphTranslationError, match=r"'y' \(ResizeBilinear\).*align_corners"):
            fn(x_np)


def test_translator_typeerror_surfaces_with_the_node(monkeypatch):
    """A translator bug surfacing as TypeError is not masked by a
    fallback: it propagates, noting the node and op it came from."""
    x_np = rng.standard_normal((2, 5)).astype(np.float32)

    def build():
        x = v1.placeholder(tf.float32, [None, 5], name="x")
        return [x], [tf.tanh(x, name="y")]

    gfn, _ = _freeze(build)

    def boom(xp, ctx, node, x):
        raise TypeError("synthetic translator bug")

    monkeypatch.setitem(tf2torch._TRANSLATORS, "Tanh", boom)
    fn = gfn.to_torch(device="cpu")
    with pytest.raises(TypeError, match="synthetic translator bug") as ei:
        fn(x_np)
    assert any("'y' (Tanh)" in note for note in ei.value.__notes__)


def test_gather_argmax_cast():
    x_np = rng.standard_normal((4, 9)).astype(np.float32)

    def build():
        x = v1.placeholder(tf.float32, [None, 9], name="x")
        idx = tf.argmax(x, axis=1, output_type=tf.int32)
        emb = tf.constant(rng.standard_normal((9, 5)).astype(np.float32))
        y = tf.gather(emb, idx, axis=0)
        return [x], [tf.cast(y, tf.float32, name="y"), idx]

    _check(build, x_np)


def test_untranslatable_op_reported_and_raises_naming_the_node():
    def build():
        x = v1.placeholder(tf.float32, [3, 3], name="x")
        return [x], [tf.linalg.inv(x, name="y")]  # MatrixInverse: outside

    gfn, _ = _freeze(build)
    assert untranslatable_ops(gfn.graph_def) == ["MatrixInverse"]
    with pytest.raises(GraphTranslationError, match=r"node 'y' \(MatrixInverse\)"):
        translate_graph(gfn.graph_def, gfn.input_names, gfn.output_names, device="cpu")
    # the public surface raises too: there is no call_tf lowering
    with pytest.raises(GraphTranslationError, match="MatrixInverse"):
        gfn.to_torch(device="cpu")


def test_cumsum_onehot_topk_trig():
    x_np = rng.standard_normal((4, 6)).astype(np.float32)

    def build():
        x = v1.placeholder(tf.float32, [None, 6], name="x")
        c = tf.cumsum(x, axis=1)
        idx = tf.argmax(x, axis=1, output_type=tf.int32)
        oh = tf.one_hot(idx, 6, on_value=2.0, off_value=-1.0)
        oh_bool = tf.one_hot(idx, 6, on_value=True, off_value=False, dtype=tf.bool)
        vals, inds = tf.math.top_k(x, k=3)
        trig = tf.sin(x) + tf.cos(x) * tf.atan2(x, 1.0 + tf.abs(x))
        return [x], [c, oh, tf.cast(oh_bool, tf.float32), vals, inds, trig]

    _check(build, x_np)


@pytest.mark.parametrize("exclusive", [False, True])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("axis", [0, 1])
def test_cumsum_cumprod_exclusive_reverse(exclusive, reverse, axis):
    x_np = rng.standard_normal((3, 5)).astype(np.float32) * 0.5

    def build():
        x = v1.placeholder(tf.float32, [3, 5], name="x")
        s = tf.cumsum(x, axis=axis, exclusive=exclusive, reverse=reverse)
        p = tf.math.cumprod(1.0 + x * 0.1, axis=axis, exclusive=exclusive, reverse=reverse)
        return [x], [s, p]

    _check(build, x_np)


def test_gather_batch_dims():
    params = rng.standard_normal((4, 7, 3)).astype(np.float32)
    idx = rng.integers(0, 7, size=(4, 5)).astype(np.int32)

    def build():
        p = v1.placeholder(tf.float32, [4, 7, 3], name="p")
        i = v1.placeholder(tf.int32, [4, 5], name="i")
        return [p, i], [tf.gather(p, i, axis=1, batch_dims=1, name="y")]

    _check(build, params, idx)


def test_gather_batch_dims_deeper_axis():
    params = rng.standard_normal((2, 3, 6, 4)).astype(np.float32)
    idx = rng.integers(0, 6, size=(2, 3, 2)).astype(np.int32)

    def build():
        p = v1.placeholder(tf.float32, [2, 3, 6, 4], name="p")
        i = v1.placeholder(tf.int32, [2, 3, 2], name="i")
        return [p, i], [tf.gather(p, i, axis=2, batch_dims=2, name="y")]

    _check(build, params, idx)


def test_strided_slice_ellipsis_and_new_axis():
    x_np = rng.standard_normal((3, 4, 5)).astype(np.float32)

    def build():
        x = v1.placeholder(tf.float32, [3, 4, 5], name="x")
        a = tf.identity(x[..., 0], name="a")
        b = tf.identity(x[:, tf.newaxis, 1:], name="b")
        c = tf.identity(x[..., 1:3, tf.newaxis], name="c")
        return [x], [a, b, c]

    _check(build, x_np)


def test_strided_slice_negative_strides():
    """x[..., ::-1] (an in-graph BGR<->RGB flip) and x[:, 3:0:-2]: torch
    slices have no negative steps, so the port flips and slices."""
    x_np = rng.standard_normal((2, 5, 3)).astype(np.float32)

    def build():
        x = v1.placeholder(tf.float32, [2, 5, 3], name="x")
        return [x], [tf.identity(x[..., ::-1], name="a"),
                     tf.identity(x[:, 3:0:-2], name="b")]

    _check(build, x_np)


def test_select_v1_rank1_cond_broadcasts_leading_axis():
    """TF Select (v1) broadcasts a rank-1 cond along the LEADING axis."""
    c_np = np.array([True, False, True], np.bool_)
    a_np = rng.standard_normal((3, 3)).astype(np.float32)
    b_np = rng.standard_normal((3, 3)).astype(np.float32)

    def build():
        c = v1.placeholder(tf.bool, [3], name="c")
        a = v1.placeholder(tf.float32, [3, 3], name="a")
        b = v1.placeholder(tf.float32, [3, 3], name="b")
        return [c, a, b], [tf.raw_ops.Select(condition=c, x=a, y=b, name="y")]

    _check(build, c_np, a_np, b_np)


def test_reduction_empty_axis_list_is_identity():
    x_np = rng.standard_normal((3, 4)).astype(np.float32)

    def build():
        x = v1.placeholder(tf.float32, [3, 4], name="x")
        return [x], [tf.reduce_mean(x, axis=[], name="m"),
                     tf.reduce_sum(x, axis=[], name="s")]

    _check(build, x_np)


def test_floor_div_mod_and_int_cast_on_negatives():
    """FloorDiv/FloorMod round toward -inf (torch's "floor" division and
    remainder, not C truncation); float -> int Cast truncates."""
    a_np = np.array([[-7, 7, -3, 5]], np.int32)
    x_np = np.array([[-2.7, 2.7, -0.5, 3.5]], np.float32)

    def build():
        a = v1.placeholder(tf.int32, [None, 4], name="a")
        x = v1.placeholder(tf.float32, [None, 4], name="x")
        b = tf.constant(np.array([2, -2, 2, -3], np.int32))
        return [a, x], [tf.math.floordiv(a, b), tf.math.floormod(a, b),
                        tf.cast(x, tf.int32), tf.math.floordiv(x, 2.0)]

    _check(build, a_np, x_np)


def test_nchw_graph_translates():
    """GPU-era frozen graphs use NCHW; conv/BN/pool/bias all translate.
    TF on CPU often cannot EXECUTE NCHW convs, so when the session
    refuses, the oracle is the NHWC-equivalent computation."""
    x_np = rng.standard_normal((2, 3, 10, 10)).astype(np.float32)
    k_np = (rng.standard_normal((3, 3, 3, 8)) * 0.2).astype(np.float32)
    bias_np = rng.standard_normal(8).astype(np.float32)
    mean_np = rng.standard_normal(8).astype(np.float32) * 0.1
    var_np = np.abs(rng.standard_normal(8)).astype(np.float32) + 0.5
    gamma_np = np.ones(8, np.float32)
    beta_np = np.zeros(8, np.float32)

    def build():
        x = v1.placeholder(tf.float32, [None, 3, 10, 10], name="x")
        h = tf.nn.conv2d(x, tf.constant(k_np), strides=[1, 1, 1, 1],
                         padding="SAME", data_format="NCHW")
        h = tf.nn.bias_add(h, tf.constant(bias_np), data_format="NCHW")
        h, _, _ = tf.compat.v1.nn.fused_batch_norm(
            h, tf.constant(gamma_np), tf.constant(beta_np),
            tf.constant(mean_np), tf.constant(var_np),
            epsilon=1e-3, is_training=False, data_format="NCHW")
        h = tf.nn.relu(h)
        h = tf.nn.max_pool2d(h, 2, 2, "VALID", data_format="NCHW")
        y = tf.nn.avg_pool2d(h, 3, 1, "SAME", data_format="NCHW", name="y")
        return [x], [y]

    gfn, oracle = _freeze(build)
    assert untranslatable_ops(gfn.graph_def, gfn.output_names) == []
    (got,) = _port(gfn, x_np)
    (ref,) = _jax(gfn, x_np)
    assert_port_close(got, ref)
    try:
        want = np.asarray(oracle(x_np)[0])
    except Exception:
        # CPU TF refused NCHW execution: NHWC-equivalent reference
        xh = np.transpose(x_np, (0, 2, 3, 1))
        h = tf.nn.conv2d(xh, k_np, strides=[1, 1, 1, 1], padding="SAME")
        h = tf.nn.bias_add(h, bias_np)
        h, _, _ = tf.compat.v1.nn.fused_batch_norm(
            h, gamma_np, beta_np, mean_np, var_np, epsilon=1e-3, is_training=False)
        h = tf.nn.relu(h)
        h = tf.nn.max_pool2d(h, 2, 2, "VALID")
        h = tf.nn.avg_pool2d(h, 3, 1, "SAME")
        want = np.transpose(h.numpy(), (0, 3, 1, 2))
    np.testing.assert_allclose(got, want, atol=TF_ATOL, rtol=TF_RTOL)


@pytest.mark.parametrize("padding", ["SAME", "EXPLICIT"])
@pytest.mark.parametrize("fmt", ["NHWC", "NCHW"])
def test_stride2_padding_follows_tf(padding, fmt):
    """Stride 2 over an even size: TF's SAME puts the extra row and column
    after (torch's padding= cannot); EXPLICIT paddings follow the
    data_format's dim order. Max pooling pads with -inf and average
    pooling leaves the pad out of its divisor."""
    x_np = rng.standard_normal((2, 3, 8, 8)).astype(np.float32)
    k_np = (rng.standard_normal((3, 3, 3, 4)) * 0.3).astype(np.float32)
    pads = [[0, 0], [0, 0], [1, 2], [2, 1]] if fmt == "NCHW" else [[0, 0], [1, 2], [2, 1], [0, 0]]

    def build():
        x = v1.placeholder(tf.float32, [2, 3, 8, 8], name="x")
        h = x if fmt == "NCHW" else tf.transpose(x, [0, 2, 3, 1])
        strides = [1, 1, 2, 2] if fmt == "NCHW" else [1, 2, 2, 1]
        y = tf.raw_ops.Conv2D(input=h, filter=tf.constant(k_np), strides=strides,
                              padding=padding, data_format=fmt,
                              explicit_paddings=sum(pads, []) if padding == "EXPLICIT" else [])
        m = tf.raw_ops.MaxPool(input=y, ksize=[1, 1, 3, 3] if fmt == "NCHW" else [1, 3, 3, 1],
                               strides=strides, padding="SAME", data_format=fmt)
        a = tf.raw_ops.AvgPool(value=y, ksize=[1, 1, 3, 3] if fmt == "NCHW" else [1, 3, 3, 1],
                               strides=strides, padding="SAME", data_format=fmt)
        return [x], [y, m, a]

    gfn, _ = _freeze(build)
    got, ref = _port(gfn, x_np), _jax(gfn, x_np)
    for g, r in zip(got, ref):
        assert_port_close(g, r)
    # the NHWC form runs in TF on this CPU: hold it to TF as well
    if fmt == "NHWC":
        want = _freeze(build)[1](x_np)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, atol=TF_ATOL, rtol=TF_RTOL)


def test_f32_precision_knob():
    """'highest' (default) and 'default' both run and agree with TF within
    bf16 rounding; 'highest' turns TF32 off for the call and restores the
    process's flags; invalid values raise on every path."""
    x_np = rng.standard_normal((3, 6)).astype(np.float32)

    def build():
        x = v1.placeholder(tf.float32, [None, 6], name="x")
        w = tf.constant(rng.standard_normal((6, 4)).astype(np.float32))
        return [x], [tf.matmul(x, w, name="y")]

    gfn, oracle = _freeze(build)
    want = oracle(x_np)[0]
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    seen = []
    real = torch.matmul

    def spy(a, b):
        seen.append((torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32, a.dtype))
        return real(a, b)

    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(torch, "matmul", spy)
            (hi,) = _port(gfn, x_np, f32_precision="highest")
            (lo,) = _port(gfn, x_np, f32_precision="default")
        assert seen == [(False, False, torch.float32), (True, True, torch.bfloat16)]
        assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    (ref,) = _jax(gfn, x_np, f32_precision="highest")
    assert_port_close(hi, ref)
    np.testing.assert_allclose(hi, want, atol=TF_ATOL)
    assert lo.dtype == np.float32
    np.testing.assert_allclose(lo, want, atol=2.0 ** -6 * np.abs(want).max())
    with pytest.raises(ValueError, match="f32_precision"):
        translate_graph(gfn.graph_def, gfn.input_names, gfn.output_names,
                        device="cpu", f32_precision="hgihest")
    with pytest.raises(ValueError, match="f32_precision"):
        gfn.to_torch(device="cpu", f32_precision="bogus")


def test_prefer_native_false_raises_saying_why():
    def build():
        x = v1.placeholder(tf.float32, [None, 2], name="x")
        return [x], [tf.identity(x, name="y")]

    gfn, _ = _freeze(build)
    with pytest.raises(ValueError, match="call_tf"):
        gfn.to_torch(device="cpu", prefer_native=False)


def test_dynamic_reshape_from_traced_tensor_rejected():
    def build():
        x = v1.placeholder(tf.float32, [None, 4], name="x")
        n = tf.cast(tf.reduce_max(x), tf.int32)  # reshape target FROM x's values
        return [x], [tf.reshape(x, tf.stack([n, -1]), name="y")]

    gfn, _ = _freeze(build)
    fn = translate_graph(gfn.graph_def, gfn.input_names, gfn.output_names, device="cpu")
    with pytest.raises(GraphTranslationError, match="statically"):
        fn(np.ones((2, 4), np.float32))


def test_training_mode_batch_norm_raises():
    def build():
        x = v1.placeholder(tf.float32, [2, 4, 4, 3], name="x")
        y, _, _ = tf.compat.v1.nn.fused_batch_norm(
            x, tf.ones(3), tf.zeros(3), is_training=True, name="bn")
        return [x], [tf.identity(y, name="y")]

    gfn, _ = _freeze(build)
    fn = translate_graph(gfn.graph_def, gfn.input_names, gfn.output_names, device="cpu")
    with pytest.raises(GraphTranslationError, match="is_training"):
        fn(np.ones((2, 4, 4, 3), np.float32))


def test_cuda_default_raises_without_a_card(monkeypatch):
    """The default device is the card; without one it raises rather than
    running on the CPU."""
    def build():
        x = v1.placeholder(tf.float32, [None, 2], name="x")
        return [x], [tf.identity(x, name="y")]

    gfn, _ = _freeze(build)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        gfn.to_torch()


def test_shape_math_and_constants_stay_off_the_host_path(monkeypatch):
    """A translated graph puts its weights on the device once, when it is
    translated, and its shape math runs in numpy: the second call copies
    nothing from the host (so a runner can capture it as a CUDA graph)."""
    x_np = rng.standard_normal((2, 6, 6, 3)).astype(np.float32)

    def build():
        x = v1.placeholder(tf.float32, [None, 6, 6, 3], name="x")
        k = tf.constant(rng.standard_normal((3, 3, 3, 4)).astype(np.float32))
        h = tf.nn.conv2d(x, k, strides=[1, 2, 2, 1], padding="SAME")
        shp = tf.shape(h)
        return [x], [tf.reshape(h, tf.stack([shp[0], -1]), name="y")]

    gfn, _ = _freeze(build)
    fn = translate_graph(gfn.graph_def, gfn.input_names, gfn.output_names, device="cpu")
    assert not fn.host_sync
    xt = torch.from_numpy(x_np)
    first = fn(xt)[0]
    calls = []
    real = tf2torch._to_tensor
    monkeypatch.setattr(tf2torch, "_to_tensor", lambda *a: calls.append(a) or real(*a))
    second = fn(xt)[0]
    assert calls == [] and torch.equal(first, second)


def test_reader_keeps_values_and_attrs():
    """read_graph_def gives nodes in topological order, Const values as
    numpy and attrs as Python values."""
    def build():
        x = v1.placeholder(tf.float32, [None, 4], name="x")
        w = tf.constant(np.arange(8, dtype=np.float32).reshape(4, 2), name="w")
        return [x], [tf.nn.relu(tf.matmul(x, w, transpose_b=False), name="y")]

    gfn, _ = _freeze(build)
    g = read_graph_def(gfn.graph_def, gfn.output_names)
    names = [n.name for n in g.nodes]
    assert sorted(names[:2]) == ["w", "x"] and names[2:] == ["MatMul", "y"]
    np.testing.assert_array_equal(g.by_name["w"].attrs["value"],
                                  np.arange(8, dtype=np.float32).reshape(4, 2))
    assert g.by_name["MatMul"].attrs["transpose_a"] is False
    assert g.by_name["x"].attrs["dtype"] == np.float32
    assert g.by_name["x"].attrs["shape"] == [-1, 4]
    fn = GraphFunction(g, gfn.input_names, gfn.output_names).to_torch(device="cpu")
    x = rng.standard_normal((3, 4)).astype(np.float32)
    assert_port_close(as_numpy(fn(x)[0]), np.maximum(x @ np.arange(8).reshape(4, 2), 0))


def test_chip_smoke_resnet50_tf_graph_at_32px():
    """chip_smoke.py's [tf_graph] phase writes ResNet50's frozen tf.keras
    graph in code (the card has no TF). At 32 px on the CPU: every op is
    on the surface, TF imports and runs it (written back as a GraphDef),
    and its translation equals KerasGraphModule over resnet50_keras_graph
    (the same weights) and TF."""
    import chip_smoke
    from torch_graph_parity import to_graph_def

    from sparkdl_torch.graph.op_surface import scan_graph_def
    from sparkdl_torch.models.keras_graph import KerasGraphModule

    graph = chip_smoke.resnet50_tf_graph(seed=3, size=32)
    assert untranslatable_ops(graph) == [] and scan_graph_def(graph) == []
    assert {n.op for n in graph.nodes} == {
        "Placeholder", "Const", "Pad", "Conv2D", "BiasAdd", "FusedBatchNormV3", "Relu",
        "MaxPool", "AddV2", "Mean"}
    x = np.random.default_rng(11).uniform(0, 255, (2, 32, 32, 3)).astype(np.float32)
    (got,) = translate_graph(graph, ["input_1"], ["avg_pool/Mean"], device="cpu")(x)
    keras = KerasGraphModule(chip_smoke.resnet50_keras_graph(seed=3, size=32), device="cpu")
    with torch.inference_mode():
        want = keras(torch.from_numpy(x))
    assert got.shape == (2, 2048)
    assert_port_close(as_numpy(got), as_numpy(want))
    gd = to_graph_def(graph)
    with IsolatedSession() as issn:
        tf.graph_util.import_graph_def(gd, name="")
        ref = issn.run("avg_pool/Mean:0", {"input_1:0": x})
    np.testing.assert_allclose(as_numpy(got), ref, atol=TF_ATOL * np.abs(ref).max(),
                               rtol=TF_RTOL)


def test_chip_smoke_mlp_and_control_flow_graphs():
    """[tf_graph]'s other two graphs written in code: the MLP equals its
    numpy math and TF; the If/While graph equals its numpy math on both
    branches, and is marked host_sync (runners keep it eager)."""
    import chip_smoke
    from torch_graph_parity import to_graph_def

    rng = np.random.default_rng(4)
    mlp, weights = chip_smoke.mlp_tf_graph(seed=1, widths=(16, 32, 8))
    x = rng.standard_normal((5, 16)).astype(np.float32)
    (got,) = translate_graph(mlp, ["x"], ["probs"], device="cpu")(x)
    h = np.maximum(x @ weights[0][0] + weights[0][1], 0) @ weights[1][0] + weights[1][1]
    want = np.exp(h - h.max(-1, keepdims=True))
    assert_port_close(as_numpy(got), want / want.sum(-1, keepdims=True))
    with IsolatedSession() as issn:
        tf.graph_util.import_graph_def(to_graph_def(mlp), name="")
        np.testing.assert_allclose(as_numpy(got), issn.run("probs:0", {"x:0": x}),
                                   atol=TF_ATOL, rtol=TF_RTOL)

    flow = chip_smoke.control_flow_tf_graph(width=8)
    fn = translate_graph(flow, ["x"], ["loop:1"], device="cpu")
    assert fn.host_sync
    for sign in (1.0, -1.0):
        xs = np.abs(rng.standard_normal((3, 8))).astype(np.float32) * sign
        a = 2 * xs + 1 if xs.mean() > 0 else -xs
        for _ in range(5):
            a = 0.5 * a + np.tanh(a)
        assert_port_close(as_numpy(fn(xs)[0]), a)


def test_shape_outputs_follow_each_call():
    """A static output (Shape of the input) is recomputed each call and
    put on the device for each value it takes; a TFGraph written in code
    translates with no TF."""
    from sparkdl_torch.graph import tfgraph as tg

    f32 = np.dtype("float32")
    g = tg.TFGraph([tg.placeholder("x", f32, [None, 3]),
                    tg.TFNode("s", "Shape", ("x",), {"out_type": np.dtype("int32")}),
                    tg.TFNode("y", "Relu", ("x",), {"T": f32})])
    fn = translate_graph(g, ["x"], ["s", "y"], device="cpu")
    for n in (2, 4, 2):
        s, y = fn(-np.ones((n, 3), np.float32))
        assert s.tolist() == [n, 3] and s.dtype == torch.int32
        assert torch.equal(y, torch.zeros(n, 3))


def test_integer_sums_products_and_scans_keep_their_dtype():
    """TF's Sum, Prod and Cumsum over int32 stay int32 (torch's widen to
    int64 unless told)."""
    a_np = rng.integers(-5, 6, (3, 4)).astype(np.int32)

    def build():
        a = v1.placeholder(tf.int32, [3, 4], name="a")
        return [a], [tf.reduce_sum(a, axis=1), tf.reduce_prod(a, axis=[0, 1]),
                     tf.cumsum(a, axis=0), tf.reduce_max(a, axis=0)]

    gfn = _check(build, a_np)
    for out in _port(gfn, a_np):
        assert out.dtype == np.int32


def test_chip_smoke_shape_math_graph_keeps_a_copy_per_batch_size(monkeypatch):
    """chip_smoke.py's shape_math_tf_graph: its device operands (n =
    Shape(x)[0] as a float, and Fill([n, w], 2)) come from the batch's
    shape. It equals the JAX translator and TF; alternating batch sizes
    uploads each size's operands once and keeps them (a CUDA graph
    captured for one size holds their addresses), and TFTransformer over
    a batch and a tail gives 2x on every row."""
    import chip_smoke
    from torch_graph_parity import to_graph_def

    from sparkdl_torch import LocalDataFrame, TFInputGraph, TFTransformer

    graph = chip_smoke.shape_math_tf_graph(width=8)
    gd = to_graph_def(graph)
    assert untranslatable_ops(graph) == [] and jax_untranslatable(gd) == []
    x = np.random.default_rng(6).standard_normal((5, 8)).astype(np.float32)
    (got,) = translate_graph(graph, ["x"], ["y"], device="cpu")(x)
    (ref,) = jax.jit(jax_translate(gd, ["x"], ["y"]))(x)
    assert_port_close(as_numpy(got), np.asarray(ref))
    with IsolatedSession() as issn:
        tf.graph_util.import_graph_def(gd, name="")
        np.testing.assert_allclose(as_numpy(got), issn.run("y:0", {"x:0": x}),
                                   atol=TF_ATOL, rtol=TF_RTOL)

    fn = translate_graph(graph, ["x"], ["y"], device="cpu")
    uploads = []
    real = tf2torch._to_tensor
    monkeypatch.setattr(tf2torch, "_to_tensor",
                        lambda v, d: uploads.append(np.shape(v)) or real(v, d))
    for n in (4, 2, 4, 2, 4):
        assert torch.equal(fn(torch.from_numpy(x[:n]))[0], torch.from_numpy(2 * x[:n]))
    assert sorted(uploads) == [(), (), (2, 8), (4, 8)]
    monkeypatch.undo()

    rows = np.random.default_rng(7).standard_normal((12, 8)).astype(np.float32)
    df = LocalDataFrame.from_rows([{"v": r} for r in rows], 1)
    tft = TFTransformer(tfInputGraph=TFInputGraph.fromGraphDef(graph, ["x"], ["y"]),
                        inputMapping={"v": "x"}, outputMapping={"y": "y"}, batchSize=8,
                        device="cpu")
    for _ in range(2):
        out = np.stack([r["y"] for r in tft.transform(df).collect()])
        np.testing.assert_array_equal(out, 2 * rows)
