"""BENCHMARK.json and the files it names: each one found by name, and the
manifest within the limits its readers hold it to."""
from __future__ import annotations

import re

import pytest

from benchmark.harness import manifest

M = manifest.load_json(manifest.MANIFEST)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = [w["name"] for w in M["workloads"]]


def test_manifest_keys():
    assert set(M) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert M["paths"] == ["benchmark"]
    assert M["command"][1].startswith("benchmark/")
    assert 1 <= M["run_seconds"] <= 51
    assert len((manifest.MANIFEST).read_bytes()) <= 64 * 1024


def test_names_units_and_text():
    names = [x["name"] for key in ("configs", "workloads", "end_to_end",
                                   "per_layer") for x in M[key]]
    assert all(NAME.match(n) for n in names)
    assert len(names) == len(set(names))
    for m in M["end_to_end"] + M["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for x in M["configs"] + M["workloads"]:
        assert 1 <= len(x["why"]) <= 200 and "\n" not in x["why"]
    for m in M["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in M["end_to_end"])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    c = manifest.load_cell(cell, M)
    assert c.chips == 1
    assert c.traffic["driver"] in ("offline", "serve")
    manifest.driver(c.traffic["driver"])
    for m in c.per_layer:
        assert callable(manifest.metric_reader(m["name"]))
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer
    for m in c.per_layer:
        assert m["moves"] in e2e


def test_configs_are_whole():
    for entry in M["configs"]:
        config = manifest.load_json(manifest.ROOT / entry["file"])
        assert entry["file"].startswith("benchmark/configs/")
        assert entry["reduced"] == []
        assert config["source"] == entry["source"]
        assert config["name"] == entry["name"]


def test_per_layer_lists_its_cells():
    layers = {}
    for m in M["per_layer"]:
        assert set(m["workloads"]) <= set(CELLS)
        layers.setdefault(m["layer"], []).append(m["name"])
        assert m["name"].endswith(("_roofline",)) or "roofline" not in \
            m["name"]
    assert {"Serving front end", "Fused step", "Kernels", "Device"} \
        == set(layers)
