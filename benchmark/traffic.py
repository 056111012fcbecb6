"""The one traffic generator: rows, partitions and batches from a cell's
parameters and the seed.

Featurization traffic is Spark image structs (``ImageSchema``: origin,
height, width, nChannels, mode, data; BGR uint8 bytes, mode 16 =
CV_8UC3), already at the model's input size, as after an upstream resize
stage. Each task of a cell cycles through its own partitions. Their
image counts are the cell's ``partition_images``, the same for every seed
and task, in an order drawn from (seed, task): uneven splits, as a
DataFrame's are, so that tasks doing equal work do not run in lockstep.
Every partition also holds ``undefined_per_partition`` undefined rows
(mode -1, as a failed decode leaves them) at places drawn from the seed.
Each image's bytes come from its own stream of (seed, task, partition,
row), so any row can be made again alone.

Training traffic is a pool of distinct batches (images and labels), made
on the device from the seed and cycled.
"""

from __future__ import annotations

import numpy as np

CV_8UC3, UNDEFINED_MODE = 16, -1


def image_struct(data: bytes, height: int, width: int, origin: str = "") -> dict:
    return {"origin": origin, "height": height, "width": width,
            "nChannels": 3, "mode": CV_8UC3, "data": data}


def undefined_struct(origin: str = "") -> dict:
    return {"origin": origin, "height": -1, "width": -1, "nChannels": -1,
            "mode": UNDEFINED_MODE, "data": b""}


def image_bytes(seed: int, task: int, part: int, row: int, size) -> bytes:
    """The BGR bytes of one image row."""
    h, w = size
    return np.random.default_rng([int(seed), task, part, row]).bytes(h * w * 3)


def partition_images(seed: int, task: int, traffic: dict) -> list[int]:
    """The image count of each of a task's partitions, in its order."""
    sizes = traffic["partition_images"]
    order = np.random.default_rng([int(seed), task, 2 ** 33]).permutation(len(sizes))
    return [int(sizes[i]) for i in order]


def partition_len(seed: int, task: int, part: int, traffic: dict) -> int:
    """Rows of a partition, undefined ones included."""
    return partition_images(seed, task, traffic)[part] + traffic["undefined_per_partition"]


def undefined_at(seed: int, task: int, part: int, traffic: dict) -> list[int]:
    """Positions (among all rows of the partition) of its undefined rows."""
    n = partition_len(seed, task, part, traffic)
    rng = np.random.default_rng([int(seed), task, part, 2 ** 31])
    return sorted(rng.choice(n, traffic["undefined_per_partition"], replace=False).tolist())


def row_id(task: int, part: int, pos: int, traffic: dict) -> int:
    stride = max(traffic["partition_images"]) + traffic["undefined_per_partition"]
    return (task * len(traffic["partition_images"]) + part) * stride + pos


def partition_rows(seed: int, task: int, part: int, traffic: dict, size) -> list[dict]:
    """One partition: ``{"id": int, "image": struct}`` rows in order; an
    image row at position ``pos`` holds ``image_bytes(..., row=pos)``."""
    holes = set(undefined_at(seed, task, part, traffic))
    n = partition_len(seed, task, part, traffic)
    return [{"id": row_id(task, part, pos, traffic),
             "image": undefined_struct("undefined") if pos in holes else
             image_struct(image_bytes(seed, task, part, pos, size), *size)}
            for pos in range(n)]


def sample_rows(seed: int, task: int, traffic: dict) -> list[tuple[int, int]]:
    """(partition, position) of the image rows whose features a run
    compares with the reference, drawn from the seed: every partition's
    first and last image row, the rest at random."""
    parts = len(traffic["partition_images"])
    picks = set()
    for part in range(parts):
        holes = set(undefined_at(seed, task, part, traffic))
        rows = [p for p in range(partition_len(seed, task, part, traffic)) if p not in holes]
        picks.update({(part, rows[0]), (part, rows[-1])})
    rng = np.random.default_rng([int(seed), task, 2 ** 32])
    while len(picks) < traffic["compared_rows_per_task"]:
        part = int(rng.integers(parts))
        pos = int(rng.integers(partition_len(seed, task, part, traffic)))
        if pos not in undefined_at(seed, task, part, traffic):
            picks.add((part, pos))
    return sorted(picks)


def bgr_bytes_to_rgb(data: bytes, size) -> np.ndarray:
    """An image struct's bytes as the RGB float32 [H, W, 3] array the
    models take."""
    h, w = size
    return np.frombuffer(data, np.uint8).reshape(h, w, 3)[..., ::-1].astype(np.float32)


def train_pool(seed: int, traffic: dict, size, num_classes: int, device, count=None):
    """``count`` (default: the whole pool) batches of preprocessed NHWC
    float32 images (uniform in [-127.5, 127.5), as caffe-mode pixels
    centred on the mean) and int64 labels, made on the device from the
    seed; the first ``count`` of a pool are the same whatever ``count``."""
    import torch

    from benchmark.weights import DATA_STREAM, generator

    g = generator(seed, DATA_STREAM, device)
    b, (h, w) = traffic["batch_size"], size
    xs, ys = [], []
    for _ in range(traffic["pool_batches"] if count is None else count):
        xs.append(torch.rand((b, h, w, 3), generator=g, device=device) * 255.0 - 127.5)
        ys.append(torch.randint(0, num_classes, (b,), generator=g, device=device))
    return xs, ys
