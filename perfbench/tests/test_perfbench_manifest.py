"""BENCHMARK.json and the files it names: every cell, configuration, mix
and metric is found by its name, and the file keeps to the contract's
shape."""
import json
import os
import re

import pytest

from conftest import BENCH, ROOT
from harness import manifest

SPEC = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["perfbench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25
               for m in SPEC["end_to_end"])


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_each_cell_loads_by_name(cell):
    import importlib
    c = manifest.load_cell(cell)
    assert c.chips in (1, 4)
    assert importlib.import_module("harness." + c.traffic["driver"]).Driver
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer, "every cell reports a per-layer metric"
    assert c.config["limits"], "every configuration has a compared number"
    for m in c.per_layer:  # each has a reader
        assert callable(manifest.metric_reader(m["name"]))


def test_names_units_and_entry_keys():
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer",
                          "moves"}}
    for section, want in keys.items():
        names = [e["name"] for e in SPEC[section]]
        assert len(names) == len(set(names))
        for e in SPEC[section]:
            assert set(e) - {"workloads"} == want, e
            assert NAME.match(e["name"]), e["name"]
            if "unit" in e:
                assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", e["unit"])
            if "better" in e:
                assert e["better"] in ("lower", "higher")
    layers = {m["layer"] for m in SPEC["per_layer"]}
    assert all("\n" not in l for l in layers)
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    cells = {w["name"] for w in SPEC["workloads"]}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= cells


def test_config_files_lie_under_paths_and_list_their_cuts():
    for c in SPEC["configs"]:
        assert c["file"].startswith("perfbench/configs/")
        data = manifest.load_json(os.path.join(ROOT, c["file"]))
        assert data["reduced"] == c["reduced"]


def test_every_metric_file_is_named_in_the_manifest():
    names = {m["name"] for m in SPEC["per_layer"]}
    files = {f[:-3] for f in os.listdir(os.path.join(BENCH, "metrics"))
             if f.endswith(".py")}
    assert files == names
