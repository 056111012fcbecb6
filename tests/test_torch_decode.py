"""The port's native decode (sparkdl_torch/native/decode.py over
csrc/sdl_decode.cc, copies of the JAX package's), after the JAX package's
suite (tests/native/test_decode.py): PIL oracle on PNG (lossless ->
exact), JPEG near-match, resize vs jax.image.resize sampling, threaded
batch with corrupt rows, and the imageIO struct hook; and side by side
with the JAX package: the same structs from ``native_decode_bytes`` and
``readImages`` on PNG, JPEG, grayscale, GIF and corrupt files made here
with PIL."""

import io

import numpy as np
import pytest
from PIL import Image

from sparkdl_torch.image import imageIO
from sparkdl_torch.native import _lib, decode
from sparkdl_tpu.image import imageIO as jax_io


def _png_bytes(arr):
    b = io.BytesIO()
    Image.fromarray(arr).save(b, format="PNG")
    return b.getvalue()


def _jpeg_bytes(arr, quality=95):
    b = io.BytesIO()
    Image.fromarray(arr).save(b, format="JPEG", quality=quality)
    return b.getvalue()


@pytest.fixture(scope="module")
def rgb():
    return np.random.default_rng(0).integers(
        0, 255, (40, 56, 3)
    ).astype(np.uint8)


def test_image_info(rgb):
    assert decode.image_info(_png_bytes(rgb)) == (40, 56, 3)
    assert decode.image_info(_jpeg_bytes(rgb)) == (40, 56, 3)
    gray = rgb[:, :, 0]
    assert decode.image_info(_png_bytes(gray)) == (40, 56, 1)
    assert decode.image_info(b"garbage") is None


def test_partial_target_size_rejected(rgb):
    with pytest.raises(ValueError, match="both height and width"):
        decode.decode_resize(_png_bytes(rgb), height=24)


def test_grayscale_struct_matches_pil(rgb):
    # Grayscale must produce the same 1-channel struct whichever decoder
    # a host has — the native path defers to PIL for it.
    raw = _png_bytes(rgb[:, :, 0])
    got = imageIO.native_decode_bytes(raw, "o")
    want = imageIO.PIL_decode_bytes(raw, "o")
    assert got["mode"] == want["mode"]
    np.testing.assert_array_equal(
        imageIO.imageStructToArray(got), imageIO.imageStructToArray(want)
    )


def test_png_decode_exact(rgb):
    got = decode.decode_resize(_png_bytes(rgb))
    np.testing.assert_array_equal(got, rgb)


def test_jpeg_decode_close_to_pil(rgb):
    raw = _jpeg_bytes(rgb)
    got = decode.decode_resize(raw).astype(np.int16)
    want = np.asarray(Image.open(io.BytesIO(raw)).convert("RGB"), np.int16)
    # Two libjpeg IDCT paths may round differently by a few counts.
    assert np.mean(np.abs(got - want)) < 2.0


def test_resize_matches_jax_bilinear(rgb):
    import jax
    import jax.numpy as jnp

    got = decode.decode_resize(_png_bytes(rgb), 24, 32).astype(np.float32)
    want = np.asarray(
        jax.image.resize(
            jnp.asarray(rgb, jnp.float32), (24, 32, 3), method="bilinear"
        )
    )
    # u8 quantization on the native path; sampling grid must agree.
    assert np.mean(np.abs(got - want)) < 1.0
    assert np.max(np.abs(got - want)) <= 3.0


def test_batch_decode_with_corrupt_rows(rgb):
    other = (255 - rgb)[:30, :20]
    raws = [_png_bytes(rgb), b"not an image", _jpeg_bytes(other)]
    batch, statuses = decode.decode_resize_batch(raws, 24, 24, n_threads=4)
    assert batch.shape == (3, 24, 24, 3)
    assert statuses[0] == 0 and statuses[2] == 0
    assert statuses[1] != 0
    assert np.all(batch[1] == 0)  # failed row zeroed
    assert batch[0].any() and batch[2].any()


def test_batch_empty():
    batch, statuses = decode.decode_resize_batch([], 8, 8)
    assert batch.shape == (0, 8, 8, 3) and statuses.shape == (0,)


def test_native_decode_bytes_struct_matches_pil(rgb):
    raw = _png_bytes(rgb)
    got = imageIO.native_decode_bytes(raw, origin="mem://x")
    want = imageIO.PIL_decode_bytes(raw, origin="mem://x")
    assert got["mode"] == want["mode"]
    np.testing.assert_array_equal(
        imageIO.imageStructToArray(got), imageIO.imageStructToArray(want)
    )


def test_native_decode_bytes_falls_back_on_garbage():
    assert imageIO.native_decode_bytes(b"garbage", "o") is None


def test_decoder_builds_here():
    """g++, libjpeg and libpng are in this image: the decoder must build
    (into the port's own build directory)."""
    assert decode.available(), _lib.DECODE.build_error
    assert "sparkdl_torch" in _lib.DECODE.path()


def _gif_bytes(arr):
    b = io.BytesIO()
    Image.fromarray(arr).save(b, format="GIF")
    return b.getvalue()


FORMATS = {
    "png": lambda a: _png_bytes(a),
    "jpeg": lambda a: _jpeg_bytes(a),
    "jpeg_q50": lambda a: _jpeg_bytes(a, quality=50),
    "gray_png": lambda a: _png_bytes(a[:, :, 0]),
    "gray_jpeg": lambda a: _jpeg_bytes(a[:, :, 0]),
    "gif": lambda a: _gif_bytes(a),
    "rgba_png": lambda a: _png_bytes(np.dstack([a, a[:, :, :1]])),
    "garbage": lambda a: b"\x89PNG\r\n\x1a\n not an image",
}


@pytest.mark.parametrize("fmt", sorted(FORMATS))
def test_native_decode_bytes_matches_the_jax_package(rgb, fmt):
    raw = FORMATS[fmt](rgb)
    got = imageIO.native_decode_bytes(raw, "o")
    want = jax_io.native_decode_bytes(raw, "o")
    if want is None:
        assert got is None
        return
    assert {k: got[k] for k in ("height", "width", "nChannels", "mode", "origin")} \
        == {k: want[k] for k in ("height", "width", "nChannels", "mode", "origin")}
    assert got["data"] == want["data"]  # bitwise


def test_read_images_matches_the_jax_package(tmp_path, rgb):
    from sparkdl_tpu.image import readImages as jax_read

    from sparkdl_torch.image import readImages

    for fmt, make in FORMATS.items():
        ext = "jpg" if "jpeg" in fmt else fmt.split("_")[-1]
        (tmp_path / f"{fmt}.{ext}").write_bytes(make(rgb))
    ours = readImages(str(tmp_path), numPartition=2).collect()
    theirs = jax_read(str(tmp_path), numPartition=2).collect()
    assert len(ours) == len(theirs) == len(FORMATS)
    for a, b in zip(ours, theirs):
        assert a["filePath"] == b["filePath"]
        assert dict(a["image"]) == dict(b["image"])
