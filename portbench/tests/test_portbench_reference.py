"""The plain reference against the port at a tiny size on the CPU (where
the port runs its kernels' plain versions): the rendered image, and whole
runs of each cell whose check steps the reference follows."""

import time

import numpy as np
import pytest
import torch

from conftest import tiny
from harness import control, runner, training
from harness.scene import make_data
from reference import gs4d

SEED = 2**31 + 77


@pytest.mark.parametrize("name", ["lego.train", "flame_salmon.train"])
def test_runs_are_correct_and_close(cells, tmp_path, name):
    cell = tiny(cells[name])
    out = runner.run(cell, SEED, 1.0, False, "cpu", time.perf_counter(),
                     log=lambda line: None, root=str(tmp_path))
    assert out["correct"], out["check"]
    for k, v in out["check"].items():
        assert v["value"] < 1e-3, (k, v)
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert set(out["metrics"]) == {"train_step_ms", "peak_mem_gib",
                                   "setup_s"}
    assert list(out)[-1] == "check"


def test_traced_run_reads_its_metrics(cells, tmp_path):
    """The traced run's stage marks, profile and readers, on the CPU: the
    host-clock metrics read, the device's find nothing to read."""
    cell = tiny(cells["lego.train"])
    out = runner.run(cell, SEED, 0.5, True, "cpu", time.perf_counter(),
                     log=lambda line: None, root=str(tmp_path))
    assert out["correct"], out["check"]
    got = out["metrics"]
    assert {"train.render_ms", "train.backward_ms", "train.knn_ms"} <= set(got)
    assert "train.k1_roofline" not in got           # no device trace
    assert out["device"]["busy_s"] == 0 and out["device"]["window_s"] > 0
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("name", ["lego.train", "flame_salmon.train"])
def test_render_matches_the_port(cells, tmp_path, name):
    from fourdgs_tpu_torch.models.gaussians import GaussianParams, activate
    from fourdgs_tpu_torch.ops.preprocess import RenderOptions
    from fourdgs_tpu_torch.render import render

    cell = tiny(cells[name])
    data = make_data(cell.config, SEED, "cpu",
                     runner.work_dirs(cell, str(tmp_path))[1])
    cfg = cell.config["config"]
    t0, t1 = cfg["time_duration"]
    pose = data.frames[3].pose
    cam = gs4d.camera_tensors(pose, "cpu", torch.float32)
    act = gs4d.activate(data.params)
    color, alpha = gs4d.render(act, cam, torch.zeros(3), pose.height,
                               pose.width, float(t1 - t0))

    scene = training.program_scene(data, training.program_config(
        cell.config, SEED, str(tmp_path / "m")))
    pact = activate(GaussianParams(**data.params), len(data.params["xyz"]))
    opts = RenderOptions(height=pose.height, width=pose.width,
                         gaussian_dim=4, rot_4d=True,
                         time_duration=float(t1 - t0))
    out = render(**pact._asdict(), camera=scene.train_cameras[3].arrays(
        "cpu"), bg=torch.zeros(3), opts=opts)
    assert float(alpha.max()) > 0.1
    np.testing.assert_allclose(color.numpy(), out.color.numpy(), atol=1e-6)
    np.testing.assert_allclose(alpha.numpy(), out.alpha.numpy(), atol=1e-6)


def test_control_batches_are_the_trainers(cells, tmp_path):
    cell = tiny(cells["lego.train"])
    data = make_data(cell.config, SEED, "cpu",
                     runner.work_dirs(cell, str(tmp_path))[1])
    expected = control.program_batches(cell, data, SEED)
    _, res = training.run_cell(cell.config, cell.traffic, data, SEED,
                                   0.5, False, "cpu", str(tmp_path / "w"),
                                   time.perf_counter())
    assert res.check.batches == expected
