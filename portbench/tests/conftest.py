"""Tests of the port's benchmark harness. They run on the CPU, at tiny
sizes, with the program's plain kernel versions; the tests marked `card`
run the real cells' checks on a CUDA card and skip without one:

    python3 -m pytest portbench/tests -q
"""

import copy
import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
sys.path.insert(0, BENCH)
sys.path.insert(1, os.path.dirname(BENCH))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this check runs the cell at its size")


def tiny(cell):
    """`cell` cut to a size the CPU runs in seconds: 600 gaussians, a few
    small frames, a short warm-up and profile."""
    cfg = copy.deepcopy(cell.config)
    cfg["config"]["num_pts"] = 600
    ds = cfg["dataset"]
    if ds["kind"] == "dnerf":
        ds.update(image_size=[96, 96], train_views=8)
    else:
        ds.update(image_size=[128, 96], cameras=4, frames=3, png_pool=3,
                  focal=70.0)
        cfg["config"]["PipelineParams"]["env_map_res"] = 16
    return cell._replace(config=cfg, traffic=dict(
        cell.traffic, warmup_steps=2, profile_steps=2, marks_min_steps=2))


# Configurations under configs/ whose cells are not in BENCHMARK.json
# yet (PERF.md §7): their tests run at the tiny size only.
LATER = {"flame_salmon": "flame_salmon.train"}


@pytest.fixture(scope="session")
def cells():
    """Every cell of BENCHMARK.json, and the cells of LATER on the same
    traffic."""
    from harness import registry

    bench = registry.load_benchmark()
    for conf, cell in LATER.items():
        bench["configs"].append(dict(
            name=conf, file=f"portbench/configs/{conf}.json"))
        bench["workloads"].append(dict(
            name=cell, config=conf, traffic="train_late", chips=1))
    return {w["name"]: registry.cell(bench, w["name"])
            for w in bench["workloads"]}


@pytest.fixture(scope="session", autouse=True)
def few_threads():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
