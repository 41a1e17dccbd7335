"""Finds what a cell needs by the names in `BENCHMARK.json`: its
configuration file, its traffic mix (`traffic/<name>.json`), its limits
(`limits/<workload>.json`) and its metrics' readers
(`metrics/<name>.py`). Adding a cell, a mix or a metric adds files and
entries; no file here changes."""

from __future__ import annotations

import importlib.util
import json
import os
import sys
from typing import NamedTuple

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH_DIR)


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict           # the configuration file's content
    config_name: str
    traffic: dict          # the traffic mix's parameters
    end_to_end: list       # BENCHMARK.json entries this cell reports
    per_layer: list


def load_benchmark(repo: str = REPO) -> dict:
    with open(os.path.join(repo, "BENCHMARK.json")) as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(bench: dict, name: str, repo: str = REPO,
         bench_dir: str = BENCH_DIR) -> Cell:
    """The cell `name` of `bench`, its files read."""
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    with open(os.path.join(repo, conf["file"])) as f:
        config = json.load(f)
    with open(os.path.join(bench_dir, "traffic", f"{w['traffic']}.json")) as f:
        traffic = json.load(f)
    e2e = [m for m in bench["end_to_end"] if _applies(m, name)]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if _applies(m, name) and m["moves"] in reported]
    return Cell(name, w["chips"], config, w["config"], traffic, e2e,
                per_layer)


def metric_reader(name: str, bench_dir: str = BENCH_DIR):
    """The module `metrics/<name>.py`, whose `read(ctx)` gives the metric's
    value or None where the run has nothing to read."""
    metrics_dir = os.path.join(bench_dir, "metrics")
    if metrics_dir not in sys.path:
        sys.path.insert(0, metrics_dir)
    path = os.path.join(metrics_dir, f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
