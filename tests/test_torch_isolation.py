"""The port stands alone: every module of fourdgs_tpu_torch, and
chip_smoke.py, import with JAX and the JAX package blocked, and reading a
checkpoint written by the JAX package (through GaussianRenderer, and
through a config file, a scene on disk, Evaluator and render_cli) and
training that scene through the CLI (`fourdgs_tpu_torch.train`) load
neither. PyYAML and Pillow are imported by the functions that need them,
not when a module is imported."""

import os
import subprocess
import sys

import numpy as np

from fourdgs_tpu.engine.checkpoint import save_checkpoint
from fourdgs_tpu.models import gaussians as jax_gaussians

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = r"""
import importlib, importlib.abc, importlib.util, os, pkgutil, sys

def banned(name):
    top = name.split(".")[0]
    return top in ("jax", "jaxlib") or top == "fourdgs_tpu"

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if banned(name):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
root = sys.argv[1]
sys.path.insert(0, root)
import fourdgs_tpu_torch
names = ["fourdgs_tpu_torch"] + [
    m.name for m in pkgutil.walk_packages(fourdgs_tpu_torch.__path__,
                                          "fourdgs_tpu_torch.")]
for name in names:
    importlib.import_module(name)
early = sorted(m for m in ("yaml", "PIL") if m in sys.modules)
spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(root, "chip_smoke.py"))
chip_smoke = importlib.util.module_from_spec(spec)
spec.loader.exec_module(chip_smoke)          # defines main, does not run it

from fourdgs_tpu_torch.render import GaussianRenderer
from fourdgs_tpu_torch.ops.preprocess import RenderOptions
from fourdgs_tpu_torch.data.cameras import Camera
import numpy as np
renderer = GaussianRenderer.from_checkpoint(
    sys.argv[2], RenderOptions(height=16, width=24), device="cpu")
cam = Camera(uid=0, rot=np.eye(3), trans=np.zeros(3), fovx=1.0, fovy=1.0,
             width=24, height=16, timestamp=0.5).arrays("cpu")
color = renderer(cam)[0]
assert tuple(color.shape) == (16, 24, 3)

# The evaluation path: YAML config, scene on disk, checkpoint, render_cli.
from fourdgs_tpu_torch import render_cli
out_dir = os.path.join(os.path.dirname(sys.argv[2]), "renders")
rc = render_cli.main(["--config", sys.argv[3], "--checkpoint", sys.argv[2],
                      "--device", "cpu", "--fast", "--max_views", "1",
                      "--out", out_dir])
assert rc == 0 and os.path.exists(os.path.join(out_dir, "metrics.json"))
assert "yaml" in sys.modules and "PIL" in sys.modules

# The training path: the CLI trains the same scene through a densify event.
from fourdgs_tpu_torch import train as train_cli
train_dir = os.path.join(os.path.dirname(sys.argv[2]), "train_out")
rc = train_cli.main(["--config", sys.argv[3], "--device", "cpu", "--quiet",
                     "--model_path", train_dir, "--override",
                     "optimization.iterations=3",
                     "optimization.densify_from_iter=1",
                     "optimization.densification_interval=2",
                     "test_iterations=[]", "save_iterations=[3]"])
assert rc == 0 and os.path.exists(os.path.join(train_dir, "chkpnt3.pkl"))

loaded = sorted(m for m in sys.modules if banned(m))
print("MODULES", len(names), "EARLY", early, "BANNED", loaded)
"""

REQUIRED = ("config", "render_cli", "viewer", "train", "data.scene",
            "data.colmap", "data.pointcloud", "engine.evaluator",
            "engine.trainer", "models.densify", "models.envmap",
            "models.ply_io", "utils.image", "utils.metrics_log")


def test_port_imports_no_jax(tmp_path, rng):
    p = 8
    params = jax_gaussians.GaussianParams(
        xyz=np.concatenate([rng.uniform(-0.5, 0.5, (p, 2)),
                            rng.uniform(2, 4, (p, 1))], 1).astype(np.float32),
        t=np.full((p, 1), 0.5, np.float32),
        scaling=np.full((p, 3), -2.0, np.float32),
        scaling_t=np.zeros((p, 1), np.float32),
        rotation=np.tile(np.float32([1, 0, 0, 0]), (p, 1)),
        rotation_r=np.tile(np.float32([1, 0, 0, 0]), (p, 1)),
        f_dc=rng.normal(size=(p, 1, 3)).astype(np.float32),
        f_rest=np.zeros((p, 47, 3), np.float32),
        opacity=np.zeros((p, 1), np.float32))
    zeros = jax_gaussians.GaussianParams(*(np.zeros_like(x) for x in params))
    state = jax_gaussians.GaussianState(
        params=params,
        adam=jax_gaussians.AdamState(mu=zeros, nu=zeros, count=np.int32(0)),
        n_active=np.int32(p), xyz_grad_accum=np.zeros(p, np.float32),
        t_grad_accum=np.zeros(p, np.float32), denom=np.zeros(p, np.float32),
        max_radii2d=np.zeros(p, np.float32))
    path = str(tmp_path / "chkpnt.pkl")
    save_checkpoint(path, state, None, step=1)
    fixture = os.path.join(ROOT, "tests", "fixtures", "synth_gate")
    cfg_path = str(tmp_path / "cfg.yaml")
    with open(cfg_path, "w") as f:
        f.write("gaussian_dim: 4\nrot_4d: true\ntime_duration: [0.0, 1.0]\n"
                "num_pts: 50\nModelParams:\n  resolution: 2\n"
                f"  source_path: {fixture}\n  eval: true\n")
    for name in REQUIRED:
        assert os.path.exists(os.path.join(
            ROOT, "fourdgs_tpu_torch", *name.split(".")) + ".py"), name

    out = subprocess.run([sys.executable, "-c", CHILD, ROOT, path, cfg_path],
                         capture_output=True, text=True, timeout=240,
                         cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr[-4000:]
    line = [ln for ln in out.stdout.splitlines()
            if ln.startswith("MODULES")][-1]
    assert line.endswith("BANNED []"), line
    assert "EARLY []" in line, line
    assert int(line.split()[1]) >= 14 + len(REQUIRED)
