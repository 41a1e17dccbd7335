"""The port's render_cli on tests/fixtures/synth_gate, on the CPU: files
written, metrics equal to a direct Evaluator run (tolerance: none, the
same code on the same device), the packed path within 1.5e-2 of the exact
one, and the clean exits (code 2) of a missing checkpoint, a missing
device, and a missing reference .pth checkpoint with --export_pth."""

import json
import os

import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from fourdgs_tpu.engine import checkpoint as jax_ckpt
from fourdgs_tpu_torch import render_cli
from fourdgs_tpu_torch.config import load_config
from fourdgs_tpu_torch.engine.evaluator import Evaluator, fetch_gt
from fourdgs_tpu_torch.models.ply_io import import_gaussians_ply
from fourdgs_tpu_torch.utils import losses

from torch_helpers import SYNTH_GATE as FIXTURE
from torch_helpers import jax_synth_gate_state as _jax_state


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """A model directory with two JAX checkpoints and a YAML in the
    reference's layout pointing at the fixture."""
    root = tmp_path_factory.mktemp("cli")
    state, env = _jax_state()
    jax_ckpt.save_checkpoint(str(root / "model" / "chkpnt7.pkl"), state,
                             None, 7)
    jax_ckpt.save_checkpoint(str(root / "model" / "chkpnt40.pkl"), state,
                             env, 40)
    cfg = dict(gaussian_dim=4, time_duration=[0.0, 1.0], rot_4d=True,
               num_pts=300,
               ModelParams=dict(source_path=FIXTURE,
                                model_path=str(root / "model"),
                                resolution=1, eval=True),
               PipelineParams=dict(eval_shfs_4d=True, env_map_res=8))
    with open(root / "cfg.yaml", "w") as f:
        yaml.safe_dump(cfg, f)
    return root


def _run(workdir, *extra, out="renders"):
    argv = ["--config", str(workdir / "cfg.yaml"), "--device", "cpu",
            "--out", str(workdir / out), *extra]
    return render_cli.main(argv)


@pytest.mark.parametrize("fast", [False, True], ids=["exact", "fast"])
def test_cli_writes_files_and_metrics_equal_evaluator(workdir, fast, capsys):
    out = "fast" if fast else "exact"
    rc = _run(workdir, "--load_iteration", "-1", "--max_views", "2",
              *(["--fast"] if fast else []), out=out)
    assert rc == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert "chkpnt40.pkl" in lines[0]            # -1 resolves the latest
    summary_line = json.loads(lines[-1])
    assert set(summary_line) == {"psnr", "ssim", "msssim"}

    with open(workdir / out / "metrics.json") as f:
        summary = json.load(f)
    assert len(summary["views"]) == 2
    assert summary_line["psnr"] == summary["psnr"]

    ev = Evaluator(load_config(str(workdir / "cfg.yaml")), device="cpu",
                   verbose=False)
    ev.eval_infer = fast
    ev.load(str(workdir / "model" / "chkpnt40.pkl"))
    for i, (cam, view) in enumerate(zip(ev.scene.test_cameras,
                                        summary["views"])):
        color, depth, _ = ev.render_view(cam)
        gt = torch.as_tensor(fetch_gt(cam, False)[0])
        assert view["psnr"] == float(losses.psnr(color, gt))
        assert view["ssim"] == float(losses.ssim(color, gt))
        assert view["msssim"] == float(losses.msssim(color[None], gt[None]))
        assert view["view"] == cam.image_name
        assert view["timestamp"] == cam.timestamp
        assert view["instances_dropped"] == 0 and view["num_rendered"] > 0
        png = np.asarray(Image.open(workdir / out / f"{i:05d}.png"))
        assert png.shape == (96, 96, 3) and png.dtype == np.uint8
        np.testing.assert_array_equal(
            png, (np.clip(color.numpy(), 0, 1) * 255).astype(np.uint8))
        dpng = np.asarray(Image.open(workdir / out / f"{i:05d}_depth.png"))
        d = depth.numpy()
        np.testing.assert_array_equal(
            dpng, (np.clip(d / max(d.max(), 1e-6), 0, 1) * 255
                   ).astype(np.uint8))
    assert summary["psnr"] == np.mean([v["psnr"] for v in summary["views"]])


def test_cli_fast_is_close_to_exact(workdir):
    """Runs after the two above (same module-scoped directory)."""
    for name in ("exact", "fast"):
        if not (workdir / name / "00000.png").exists():
            _run(workdir, "--load_iteration", "40", "--max_views", "1",
                 *(["--fast"] if name == "fast" else []), out=name)
    a = np.asarray(Image.open(workdir / "exact" / "00000.png"), np.float32)
    b = np.asarray(Image.open(workdir / "fast" / "00000.png"), np.float32)
    assert np.abs(a - b).max() / 255.0 <= 1.5e-2 + 1.0 / 255.0
    assert np.abs(a - b).max() > 0       # the packed path did run


def test_cli_train_split_sweep_and_ply(workdir, capsys):
    ply = str(workdir / "cloud.ply")
    rc = _run(workdir, "--checkpoint", str(workdir / "model" / "chkpnt7.pkl"),
              "--split", "train", "--max_views", "1", "--video_frames", "3",
              "--export_ply", ply, out="train")
    assert rc == 0
    assert "exported cloud" in capsys.readouterr().out
    assert sorted(os.listdir(workdir / "train" / "time_sweep")) == [
        "t_0000.png", "t_0001.png", "t_0002.png"]
    sweep = [np.asarray(Image.open(workdir / "train" / "time_sweep" / f))
             for f in ("t_0000.png", "t_0002.png")]
    assert np.abs(sweep[0].astype(int) - sweep[1].astype(int)).max() > 0
    assert int(import_gaussians_ply(ply, device="cpu").n_active) == 300
    with open(workdir / "train" / "metrics.json") as f:
        assert json.load(f)["views"][0]["view"] == "r_000"


def test_cli_default_out_dir(workdir):
    argv = ["--config", str(workdir / "cfg.yaml"), "--device", "cpu",
            "--load_iteration", "7", "--max_views", "1"]
    assert render_cli.main(argv) == 0
    assert (workdir / "model" / "renders_test" / "metrics.json").exists()


@pytest.mark.parametrize("extra,message", [
    (["--checkpoint", "/nonexistent/chkpnt1.pkl"], "checkpoint not found"),
    (["--load_iteration", "12345"], "checkpoint not found"),
    ([], "--checkpoint or --load_iteration"),
    (["--checkpoint", "/nonexistent/chkpnt1.pth", "--export_pth", "x.pth"],
     "checkpoint not found"),
], ids=["missing_path", "missing_iteration", "no_checkpoint", "export_pth"])
def test_cli_clean_exit_2(workdir, capsys, extra, message):
    assert _run(workdir, *extra, out="never") == 2
    assert message in capsys.readouterr().err
    assert not (workdir / "never").exists()


def test_cli_does_not_fall_back_to_the_cpu(workdir, capsys):
    """The default device is the card; without one the tool exits 2
    instead of carrying on on the CPU."""
    assert render_cli.build_parser().parse_args(
        ["--config", "x"]).device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("needs a machine without a CUDA device")
    argv = ["--config", str(workdir / "cfg.yaml"), "--load_iteration", "-1",
            "--out", str(workdir / "never")]
    assert render_cli.main(argv) == 2
    assert "no CUDA device" in capsys.readouterr().err
    assert not (workdir / "never").exists()
