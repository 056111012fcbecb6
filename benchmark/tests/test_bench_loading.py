"""Cells, configurations, modes and metric readers are found by name."""

import pytest

from benchmark import harness


def test_a_cell_and_its_configuration_load_by_name():
    cell = harness.load_cell("inceptionv3.featurize.tasks4")
    config = harness.load_config(cell["config"])
    assert cell["mode"] == "featurize" and config["model_name"] == "InceptionV3"
    assert config["input_size"] == [299, 299] and config["tf32"] is False


@pytest.mark.parametrize("mode", ["featurize", "train"])
def test_a_mode_loads_by_name_and_names_its_faults(mode):
    module = harness.load_mode(mode)
    assert callable(module.run) and module.FAULTS


def test_a_metric_reader_loads_by_its_dotted_name():
    reader = harness.load_reader("mfu.featurize")
    rec = {"mode": "featurize", "images": 1000, "window_s": 1.0,
           "config": harness.load_config("inceptionv3")}
    # 1000 images a second of 11.42 GFLOP at 165 TFLOP/s
    assert reader.read(rec) == pytest.approx(100 * 11.422336192e12 / 165e12)


def test_which_metrics_a_cell_reports():
    spec = harness.benchmark_spec()
    names = {m["name"] for m in harness.cell_metrics(spec, "resnet50.train.b64", "per_layer")}
    assert "gemm_bn_roofline" in names and "stem_roofline" not in names
    names = {m["name"] for m in harness.cell_metrics(spec, "resnet50.featurize.tasks4",
                                                     "end_to_end")}
    assert names == {"images_per_s", "setup_s"}
    names = {m["name"] for m in harness.cell_metrics(spec, "resnet50.featurize.tasks4",
                                                     "per_layer")}
    assert "partition_p90_ms" in names and "stem_roofline" not in names
