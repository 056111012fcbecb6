"""Reusable graph pieces: the Spark-image-struct → float-tensor converter.

The port of ``sparkdl_tpu/graph/pieces.py`` (SURVEY.md 2.10, [U:
python/sparkdl/graph/pieces.py] buildSpImageConverter): a graph fragment
that turns the raw image struct fields (height, width, nChannels, data
bytes) into a float image tensor inside the model graph, handling
BGR→RGB. Two forms are provided:

- :func:`buildSpImageConverter` — a TF ``GraphFunction`` piece, for
  splicing into ingested TF graphs (needs TF);
- :func:`image_batch_to_float` — the torch equivalent for the hot path,
  where decode already happened host-side and the batch is a dense
  uint8/float32 NHWC tensor on the card.
"""

from __future__ import annotations

import torch

from sparkdl_torch.graph._tf import require_tf


def buildSpImageConverter(channelOrder: str = "BGR", img_dtype: str = "uint8"):
    """Build the struct→tensor converter as a TF GraphFunction.

    Inputs (placeholders): ``height`` (int32), ``width`` (int32),
    ``image_buffer`` (raw bytes, string scalar), ``nChannels`` (int32).
    Output: ``sp_image`` float32 tensor of shape (height, width, nChannels)
    in **RGB** channel order (flipped when the struct stores BGR).
    """
    if img_dtype not in ("uint8", "float32"):
        raise ValueError(f"unsupported image dtype {img_dtype!r}")
    if channelOrder not in ("BGR", "RGB", "L"):
        raise ValueError(f"unsupported channelOrder {channelOrder!r}")
    tf = require_tf()
    from sparkdl_torch.graph.builder import IsolatedSession

    with IsolatedSession() as issn:
        height = tf.compat.v1.placeholder(tf.int32, [], name="height")
        width = tf.compat.v1.placeholder(tf.int32, [], name="width")
        num_channels = tf.compat.v1.placeholder(tf.int32, [], name="nChannels")
        image_buffer = tf.compat.v1.placeholder(tf.string, [], name="image_buffer")

        decode_dtype = tf.uint8 if img_dtype == "uint8" else tf.float32
        flat = tf.io.decode_raw(image_buffer, decode_dtype)
        shape = tf.stack([height, width, num_channels])
        image = tf.reshape(flat, shape)
        image = tf.cast(image, tf.float32)
        if channelOrder == "BGR":
            image = tf.reverse(image, axis=[-1])
        image = tf.identity(image, name="sp_image")
        return issn.asGraphFunction(
            [height, width, num_channels, image_buffer], [image],
            strip_and_freeze=False,
        )


def image_batch_to_float(batch: torch.Tensor, channel_order: str = "BGR") -> torch.Tensor:
    """Dense NHWC batch → float32 RGB batch, on the batch's device.

    The hot-path twin of :func:`buildSpImageConverter`: by the time data
    is on the card it is already a dense tensor (host decode via imageIO),
    so the remaining conversion — dtype cast and BGR→RGB — is two
    elementwise ops there.
    """
    x = torch.as_tensor(batch).to(torch.float32)
    if channel_order == "BGR" and x.shape[-1] >= 3:
        x = torch.cat([x[..., :3].flip(-1), x[..., 3:]], dim=-1)
    return x
