"""BENCHMARK.json against the contract's shape, and discovery by name: a
configuration, a traffic mix and a metric added as files of their own."""

import json
import os
import re
import shutil

import pytest

from harness import registry

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_keys_and_names():
    bench = registry.load_benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["portbench"]
    assert 1 <= bench["run_seconds"] <= 51
    names = [c["name"] for c in bench["configs"]]
    names += [w["name"] for w in bench["workloads"]]
    names += [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert "setup_s" in {m["name"] for m in bench["end_to_end"]}
    e2e = {m["name"] for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
    assert os.path.getsize(os.path.join(registry.REPO, "BENCHMARK.json")) \
        < 64 * 1024


def test_every_cell_resolves(cells):
    listed = {w["name"] for w in registry.load_benchmark()["workloads"]}
    for cell in cells.values():
        assert cell.chips == 1
        assert cell.traffic["kind"] == "train"
        assert {m["name"] for m in cell.end_to_end} == {
            "train_step_ms", "peak_mem_gib", "setup_s"}
        assert bool(cell.per_layer) == (cell.name in listed), cell.name
        assert os.path.exists(os.path.join(registry.BENCH_DIR, "limits",
                                           f"{cell.name}.json"))
        for m in cell.per_layer:
            assert callable(registry.metric_reader(m["name"]).read)


def test_configs_hold_their_source_yaml():
    """Each configuration's file holds its source's YAML unchanged."""
    import yaml

    yamls = {"lego": "configs/dnerf/lego.yaml",
             "flame_salmon": "configs/dynerf/flame_salmon.yaml"}
    for name, source in yamls.items():
        with open(os.path.join(registry.BENCH_DIR, "configs",
                               f"{name}.json")) as f:
            held = json.load(f)
        with open(os.path.join(registry.REPO, source)) as f:
            assert held["config"] == yaml.safe_load(f)
        assert held["reduced"] == []
    for c in registry.load_benchmark()["configs"]:
        assert c["reduced"] == [] and c["name"] in yamls


def test_added_files_are_found_by_name(tmp_path):
    """A copy of the benchmark with a new configuration, traffic mix and
    metric, each a new file and a new entry: found, nothing else edited."""
    repo = tmp_path / "repo"
    shutil.copytree(registry.BENCH_DIR, repo / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = registry.load_benchmark()
    before = {p: (repo / "portbench" / "metrics" / p).read_bytes()
              for p in os.listdir(repo / "portbench" / "metrics")
              if p.endswith(".py")}
    lego = json.loads((repo / "portbench/configs/lego.json").read_text())
    lego["config"]["num_pts"] = 1234
    (repo / "portbench/configs/lego_small.json").write_text(json.dumps(lego))
    (repo / "portbench/traffic/train_early.json").write_text(json.dumps(
        dict(kind="train", start_iteration=600, adam_count=600,
             check_steps=3, warmup_steps=4, profile_steps=3)))
    (repo / "portbench/metrics/train.steps_seen.py").write_text(
        "def read(ctx):\n    return float(len(ctx.result.step_s))\n")
    (repo / "portbench/limits/lego_small.train_early.json").write_text(
        json.dumps(dict(loss_gap=1, grad_gap=1, change_gap=1)))
    bench["configs"].append(dict(bench["configs"][0], name="lego_small",
                                 file="portbench/configs/lego_small.json"))
    bench["workloads"].append(dict(
        name="lego_small.train_early", config="lego_small",
        traffic="train_early", chips=1, why="a test's cell"))
    bench["per_layer"].append(dict(
        name="train.steps_seen", unit="steps", better="higher",
        source="program_counter", layer="Trainer loop",
        moves="train_step_ms", workloads=["lego_small.train_early"]))
    (repo / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = registry.cell(registry.load_benchmark(str(repo)),
                         "lego_small.train_early", repo=str(repo),
                         bench_dir=str(repo / "portbench"))
    assert cell.config["config"]["num_pts"] == 1234
    assert cell.traffic["start_iteration"] == 600
    assert "train.steps_seen" in [m["name"] for m in cell.per_layer]
    assert "train.knn_ms" not in [m["name"] for m in cell.per_layer]
    reader = registry.metric_reader("train.steps_seen",
                                    bench_dir=str(repo / "portbench"))

    class Ctx:
        class result:
            step_s = [0.1, 0.2]
    assert reader.read(Ctx) == 2.0
    for p, data in before.items():
        assert (repo / "portbench" / "metrics" / p).read_bytes() == data


def test_unknown_workload_is_refused():
    with pytest.raises(KeyError):
        registry.cell(registry.load_benchmark(), "lego.nothing")
