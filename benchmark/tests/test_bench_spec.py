"""BENCHMARK.json against the benchmark's contract: names, units, keys,
files found by name, and the time a full check takes."""

import json
import os
import re

import pytest

from benchmark import harness

SPEC = harness.benchmark_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
KEYS = {
    "configs": ({"name", "source", "file", "reduced", "why"}, set()),
    "workloads": ({"name", "config", "traffic", "chips", "why"}, set()),
    "end_to_end": ({"name", "unit", "better", "bound", "source"}, {"workloads"}),
    # a per-layer metric lists the cells whose reader finds something to read
    "per_layer": ({"name", "unit", "better", "source", "layer", "moves", "workloads"}, set()),
}


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_size():
    assert set(SPEC) == TOP_KEYS
    with open(os.path.join(harness.ROOT, "BENCHMARK.json"), "rb") as f:
        assert len(f.read()) <= 64 * 1024


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries_have_just_the_keys_and_valid_names(section):
    need, optional = KEYS[section]
    entries = SPEC[section]
    assert entries
    for e in entries:
        assert need <= set(e) <= need | optional, e
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e and section != "end_to_end" and section != "per_layer":
                assert _line(e[key]), (e["name"], key)
    names = [e["name"] for e in entries]
    assert len(names) == len(set(names))


def test_command_and_paths():
    assert all(_line(w) for w in SPEC["command"]) and len(SPEC["command"]) <= 32
    assert 1 <= len(SPEC["paths"]) <= 16
    for p in SPEC["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert not p.rstrip("/").endswith("_torch")
    for word in SPEC["command"][1:]:
        if "/" in word:
            assert any(word.startswith(p.rstrip("/") + "/") for p in SPEC["paths"])


def test_configs_live_under_paths_and_are_used():
    used = {w["config"] for w in SPEC["workloads"]}
    files = set()
    for c in SPEC["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("benchmark/") and c["file"] not in files
        files.add(c["file"])
        with open(os.path.join(harness.ROOT, c["file"])) as f:
            data = json.load(f)
        assert data["source"] == c["source"] and data["reduced"] == c["reduced"]
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        assert _line(c["source"]) and _line(c["why"])


def test_cells_agree_with_their_files():
    assert 1 <= len(SPEC["workloads"]) <= 24
    pairs = set()
    for w in SPEC["workloads"]:
        cell = harness.load_cell(w["name"])
        assert (cell["config"], cell["chips"], cell["traffic"]["name"], cell["why"]) == (
            w["config"], w["chips"], w["traffic"], w["why"])
        assert w["chips"] in (1, 4) and _line(w["why"]) and NAME.match(w["traffic"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        harness.load_mode(cell["mode"])
    four = sum(w["chips"] == 4 for w in SPEC["workloads"])
    assert four <= max(1, len(SPEC["workloads"]) // 4)


def test_metrics_bounds_and_what_each_cell_reports():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and 1 <= len(e2e) <= 16 and 1 <= len(SPEC["per_layer"]) <= 128
    for m in e2e.values():
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    cells = [w["name"] for w in SPEC["workloads"]]
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert _line(m["layer"])
        assert m["workloads"]
        for cell in m["workloads"]:
            assert cell in cells
            assert cell in e2e[m["moves"]].get("workloads", cells), (m["name"], cell)
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    layers = {}
    for m in SPEC["per_layer"]:
        layers.setdefault(m["layer"].split(":")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for k, v in layers.items() if k not in ("kernel",))
    for cell in cells:
        reported = harness.cell_metrics(SPEC, cell, "end_to_end")
        assert "setup_s" in {m["name"] for m in reported} and len(reported) >= 2
        assert harness.cell_metrics(SPEC, cell, "per_layer")


def test_every_per_layer_metric_has_a_reader():
    for m in SPEC["per_layer"]:
        reader = harness.load_reader(m["name"])
        assert reader.read({}) is None   # nothing to read: nothing returned


def test_a_full_check_fits_at_24_cells():
    run_s = SPEC["run_seconds"]
    assert isinstance(run_s, int) and 1 <= run_s <= 51
    cells = 24
    total = (2 + 14 * cells) * (run_s + 60) + cells * 2 * 90 + 1200
    assert total <= 43200
