"""The generator: the same seed gives the same rows, structs the program
reads as the images they hold, samples that skip undefined rows."""

import numpy as np

from benchmark import traffic

TR = {"tasks": 2, "partition_images": [4, 6, 8], "undefined_per_partition": 1,
      "compared_rows_per_task": 5}
SIZE = (11, 13)
SEED = 2 ** 31 + 5


def test_same_seed_same_rows_other_seed_other_rows():
    a = traffic.partition_rows(SEED, 1, 2, TR, SIZE)
    assert a == traffic.partition_rows(SEED, 1, 2, TR, SIZE)
    assert a != traffic.partition_rows(SEED + 1, 1, 2, TR, SIZE)
    assert sum(r["image"]["mode"] == -1 for r in a) == 1
    assert len(a) == traffic.partition_images(SEED, 1, TR)[2] + 1


def test_ids_unique_across_tasks_and_partitions():
    ids = [r["id"] for t in range(2) for p in range(3)
           for r in traffic.partition_rows(SEED, t, p, TR, SIZE)]
    assert len(ids) == len(set(ids))


def test_structs_are_what_the_program_reads():
    from sparkdl_torch.image.imageIO import imageArrayToStructBGR, imageStructToArray
    from sparkdl_torch.image.schema import is_image_struct
    from sparkdl_torch.transformers.named_image import _image_to_rgb_array

    row = next(r for r in traffic.partition_rows(SEED, 0, 0, TR, SIZE) if r["image"]["mode"] != -1)
    rgb = traffic.bgr_bytes_to_rgb(row["image"]["data"], SIZE)
    assert is_image_struct(row["image"])
    np.testing.assert_array_equal(_image_to_rgb_array(row["image"]).astype(np.float32), rgb)
    again = imageArrayToStructBGR(rgb.astype(np.uint8))
    assert again["data"] == row["image"]["data"] and again["mode"] == row["image"]["mode"]
    np.testing.assert_array_equal(imageStructToArray(again)[..., ::-1], rgb)


def test_every_task_has_the_same_sizes_in_its_own_order():
    orders = [traffic.partition_images(SEED, t, TR) for t in range(6)]
    assert all(sorted(o) == [4, 6, 8] for o in orders)
    assert len({tuple(o) for o in orders}) > 1


def test_samples_cover_every_partition_and_skip_undefined_rows():
    pairs = traffic.sample_rows(SEED, 1, TR)
    assert len(pairs) >= TR["compared_rows_per_task"]
    assert {p for p, _ in pairs} == set(range(3))
    for part, pos in pairs:
        assert pos not in traffic.undefined_at(SEED, 1, part, TR)


def test_the_train_pool_prefix_does_not_depend_on_its_length():
    xs, ys = traffic.train_pool(SEED, {"batch_size": 2, "pool_batches": 4}, (4, 4), 10, "cpu")
    xs3, ys3 = traffic.train_pool(SEED, {"batch_size": 2, "pool_batches": 4}, (4, 4), 10,
                                  "cpu", count=3)
    assert len(xs) == 4 and all((a == b).all() for a, b in zip(xs, xs3))
    assert float(xs[0].min()) >= -127.5 and float(xs[0].max()) < 127.5
    assert not (xs[0] == xs[1]).all()
