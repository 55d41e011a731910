"""BENCHMARK.json and the files it names, found by name.

A cell (an entry of `workloads`) names a configuration and a traffic mix.
The configuration's file is the one its `configs` entry gives; the mix is
`traffic/<traffic>.json` beside this package, and names the driver
(`drivers/<driver>.py`) that runs it. A per-layer metric is read by
`metrics/<name>.py`. So a later cell, configuration or metric is new
files and new entries, never an edit.
"""

from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH_DIR = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH_DIR)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_spec(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def cell(spec: dict, name: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload named {name!r} in BENCHMARK.json")


def config_entry(spec: dict, name: str) -> dict:
    for c in spec["configs"]:
        if c["name"] == name:
            return c
    raise KeyError(f"no configuration named {name!r} in BENCHMARK.json")


def load_config(spec: dict, name: str, root: str = ROOT) -> dict:
    return load_json(os.path.join(root, config_entry(spec, name)["file"]))


def load_traffic(name: str, bench_dir: str = BENCH_DIR) -> dict:
    return load_json(os.path.join(bench_dir, "traffic", f"{name}.json"))


def _applies(metric: dict, cell_name: str) -> bool:
    return "workloads" not in metric or cell_name in metric["workloads"]


def end_to_end(spec: dict, cell_name: str) -> list:
    """The end-to-end metrics this cell reports."""
    return [m for m in spec["end_to_end"] if _applies(m, cell_name)]


def per_layer(spec: dict, cell_name: str) -> list:
    """The per-layer metrics of this cell: those that list it, and those
    without a list whose `moves` metric the cell reports."""
    reported = {m["name"] for m in end_to_end(spec, cell_name)}
    out = []
    for m in spec["per_layer"]:
        if "workloads" in m:
            if cell_name in m["workloads"]:
                out.append(m)
        elif m["moves"] in reported:
            out.append(m)
    return out


def _load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def metric_reader(name: str, bench_dir: str = BENCH_DIR):
    """`read(ctx) -> float | None` of metrics/<name>.py."""
    path = os.path.join(bench_dir, "metrics", f"{name}.py")
    return _load_module(path, "bench_metric_" + name.replace(".", "_").replace("-", "_")).read


def driver(name: str, bench_dir: str = BENCH_DIR):
    """The module drivers/<name>.py, whose `run(job)` runs a cell."""
    path = os.path.join(bench_dir, "drivers", f"{name}.py")
    return _load_module(path, "bench_driver_" + name)
