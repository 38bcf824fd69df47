"""`BENCHMARK.json` and the files it names, found by name.

A cell names a configuration and a traffic mix; the configuration's file is
`configs/<config>.json` (the path `BENCHMARK.json` gives), the traffic's
`workloads/<traffic>.json`, the runner of the traffic's `kind`
`kinds/<kind>.py`, a module with a class `Cell` that takes a
`cells.Context`, and a per-layer metric's reader `metrics/<metric>.py`, a
module with `read(rec) -> float | None`. Adding a cell, a configuration, a
traffic kind or a metric adds files and entries; no file changes.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH_DIR)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def load_spec(path: str | None = None) -> dict:
    with open(path or os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)


def cell(spec: dict, name: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no cell named {name!r} in BENCHMARK.json")


def config_entry(spec: dict, name: str) -> dict:
    for c in spec["configs"]:
        if c["name"] == name:
            return c
    raise KeyError(f"no configuration named {name!r} in BENCHMARK.json")


def read_json(rel: str, root: str = REPO) -> dict:
    with open(os.path.join(root, rel)) as f:
        return json.load(f)


def traffic_file(traffic: str, bench_dir: str = BENCH_DIR) -> str:
    return os.path.join(bench_dir, "workloads", f"{traffic}.json")


def metric_file(metric: str, bench_dir: str = BENCH_DIR) -> str:
    return os.path.join(bench_dir, "metrics", f"{metric}.py")


def kind_file(kind: str, bench_dir: str = BENCH_DIR) -> str:
    return os.path.join(bench_dir, "kinds", f"{kind}.py")


def _module(path: str, prefix: str, name: str):
    sp = importlib.util.spec_from_file_location(
        prefix + re.sub(r"\W", "_", name), path)
    mod = importlib.util.module_from_spec(sp)
    sp.loader.exec_module(mod)
    return mod


def reader(metric: str, bench_dir: str = BENCH_DIR):
    """The `read` function of a per-layer metric's own file."""
    return _module(metric_file(metric, bench_dir), "benchmark_metric_",
                   metric).read


def runner(kind: str, bench_dir: str = BENCH_DIR):
    """The `Cell` class of a traffic kind's own file."""
    return _module(kind_file(kind, bench_dir), "benchmark_kind_", kind).Cell


def metrics_of(spec: dict, cell_name: str) -> list:
    """The end-to-end metrics that the cell reports: those that list it or
    list no cells."""
    return [m for m in spec["end_to_end"]
            if "workloads" not in m or cell_name in m["workloads"]]


def layer_metrics_of(spec: dict, cell_name: str) -> list:
    """The per-layer metrics that the cell reports: those that list it, and
    those that list no cells and move an end-to-end metric it reports."""
    e2e = {m["name"] for m in metrics_of(spec, cell_name)}
    return [m for m in spec["per_layer"]
            if (cell_name in m["workloads"] if "workloads" in m
                else m["moves"] in e2e)]
