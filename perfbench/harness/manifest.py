"""BENCHMARK.json and the files it names, found by name.

A cell (an entry of `workloads`) names a configuration and a traffic mix.
The configuration's file is the `file` of its `configs` entry; the mix is
perfbench/traffic/<traffic>.json; each per-layer metric is read by
perfbench/metrics/<name>.py and each kernel's operations and bytes are
counted by perfbench/rooflines/<kernel>.py. Adding a cell, a mix or a metric
adds files and entries; no file here needs an edit.
"""
from __future__ import annotations

import functools
import importlib.util
import json
import os
from dataclasses import dataclass
from typing import Callable, List

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


@dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict            # the configuration file's contents
    traffic_name: str
    traffic: dict           # the traffic mix's parameters
    end_to_end: List[dict]  # the end-to-end metrics this cell reports
    per_layer: List[dict]   # the per-layer metrics this cell reports


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def load_cell(name: str, manifest_path: str = None) -> Cell:
    """The cell `name` of BENCHMARK.json, with its files read."""
    manifest = load_json(manifest_path or os.path.join(ROOT,
                                                       "BENCHMARK.json"))
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has "
                         f"{sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in manifest["configs"]}
    cfg_entry = configs[w["config"]]
    return Cell(
        name=name, chips=int(w["chips"]), config_name=w["config"],
        config=load_json(os.path.join(ROOT, cfg_entry["file"])),
        traffic_name=w["traffic"],
        traffic=load_json(os.path.join(BENCH_DIR, "traffic",
                                       w["traffic"] + ".json")),
        end_to_end=[m for m in manifest["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in manifest["per_layer"] if _reports(m, name)])


def _load_module(path: str, label: str):
    spec = importlib.util.spec_from_file_location(label, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def metric_reader(name: str) -> Callable[[dict], object]:
    """`read(record)` of perfbench/metrics/<name>.py."""
    return _load_module(os.path.join(BENCH_DIR, "metrics", name + ".py"),
                        "perfbench_metric_" + name.replace(".", "_")).read


@functools.lru_cache(maxsize=None)
def roofline(kernel: str):
    """The module perfbench/rooflines/<kernel>.py: `cost(launch)` ->
    (operations, bytes) of one recorded launch."""
    return _load_module(os.path.join(BENCH_DIR, "rooflines", kernel + ".py"),
                        "perfbench_roofline_" + kernel)


def peaks() -> dict:
    """The card's published peaks (perfbench/rooflines/peaks.json)."""
    return load_json(os.path.join(BENCH_DIR, "rooflines", "peaks.json"))
