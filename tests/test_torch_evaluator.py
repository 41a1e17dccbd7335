"""The port's Evaluator against the JAX package's eval renderer.

A checkpoint with an environment map, written by the JAX package's
`save_checkpoint`, goes through `Evaluator.load` and `render_view`; the
reference is the JAX trainer's own `eval_fn` (`Trainer._make_eval_render`,
built on a Trainer whose constructor is not run, so nothing trains or
probes) on the same checkpoint and camera, with each oracle flag on and
off. Tolerances of tests/test_pallas_blend.py: colour and alpha rtol 1e-4 /
atol 1e-5, depth rtol 1e-3 / atol 1e-4; the packed path atol 1.5e-2."""

import os
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fourdgs_tpu import config as jax_config
from fourdgs_tpu.data import scene as jax_scene
from fourdgs_tpu.engine import checkpoint as jax_ckpt
from fourdgs_tpu.engine import trainer as jax_trainer
from fourdgs_tpu.models import ply_io as jax_ply
from fourdgs_tpu.ops.preprocess import RenderOptions as JaxOptions
from fourdgs_tpu.utils import losses as jax_losses
from fourdgs_tpu_torch import config as port_config
from fourdgs_tpu_torch.engine import checkpoint as port_ckpt
from fourdgs_tpu_torch.engine import evaluator as port_eval
from fourdgs_tpu_torch.models import envmap as port_env
from fourdgs_tpu_torch.models import gaussians as port_gaussians
from fourdgs_tpu_torch.models import ply_io as port_ply

from torch_helpers import SYNTH_GATE as FIXTURE
from torch_helpers import SYNTH_GATE_OVERRIDES as OVERRIDES
from torch_helpers import jax_eval_fn
from torch_helpers import jax_synth_gate_state as _jax_state


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ckpt") / "chkpnt40.pkl")
    state, env = _jax_state()
    jax_ckpt.save_checkpoint(path, state, env, 40,
                             extra={"best_psnr": 21.5})
    return path


def _both(checkpoint, cov=False, shs=False, rot_4d=True, infer=False):
    overrides = dict(OVERRIDES, rot_4d=rot_4d)
    overrides["pipeline"] = dict(OVERRIDES["pipeline"],
                                 compute_cov3D_python=cov,
                                 convert_SHs_python=shs)
    ev = port_eval.Evaluator(port_config.load_config(None, overrides),
                             device="cpu", verbose=False)
    ev.eval_infer = infer
    ev.load(checkpoint)
    cam = ev.scene.test_cameras[1]
    color, depth, alpha = ev.render_view(cam)

    jcfg = jax_config.load_config(None, overrides)
    jscene = jax_scene.load_scene(FIXTURE, num_pts=300, resolution=2,
                                  time_duration=(0.0, 1.0), seed=jcfg.seed)
    jcam = jscene.test_cameras[1]
    gauss, env, _, _ = jax_ckpt.load_checkpoint(checkpoint)
    ref = jax_eval_fn(jcfg, JaxOptions(
        height=jcam.height, width=jcam.width, gaussian_dim=4, rot_4d=rot_4d,
        time_duration=1.0), env, infer)(
            gauss, env.texture,
            type(jcam.arrays())(*map(jnp.asarray, jcam.arrays())),
            jnp.asarray(jax_trainer.camera_intrinsics(jcam)))
    return ev, (color.numpy(), depth.numpy(), alpha.numpy()), ref


@pytest.mark.parametrize("cov,shs", [(False, False), (True, False),
                                     (False, True), (True, True)])
@pytest.mark.parametrize("rot_4d", [True, False])
def test_render_view_matches_jax_eval_fn(checkpoint, cov, shs, rot_4d):
    ev, (color, depth, alpha), ref = _both(checkpoint, cov, shs, rot_4d)
    np.testing.assert_allclose(color, np.asarray(ref[0]), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(depth, np.asarray(ref[1]), rtol=1e-3,
                               atol=1e-4)
    np.testing.assert_allclose(alpha, np.asarray(ref[2]), rtol=1e-4,
                               atol=1e-5)
    assert ev.last_counts["num_rendered"] == int(ref[3]) > 0
    assert ev.last_counts["max_per_tile"] == int(ref[4])
    assert ev.last_counts["instances_dropped"] == 0 == int(ref[5])
    assert 0.0 <= color.min() and color.max() <= 1.0
    assert alpha.min() < 0.5 < alpha.max()      # the sky shows through


@pytest.mark.parametrize("cov", [False, True])
def test_eval_infer_matches_jax_and_oracle_switches_it_off(checkpoint, cov):
    """`eval_infer` takes the packed path (atol 1.5e-2 against the JAX
    package's), and an oracle flag switches it off exactly as
    trainer.py:497-498 does: the render then equals the exact one."""
    ev, (color, depth, alpha), ref = _both(checkpoint, cov=cov, infer=True)
    tol = 1e-4 if cov else 1.5e-2
    np.testing.assert_allclose(color, np.asarray(ref[0]), atol=tol)
    np.testing.assert_allclose(alpha, np.asarray(ref[2]), atol=tol)
    d = np.asarray(ref[1])
    np.testing.assert_allclose(depth, d, atol=tol * max(1.0, np.abs(d).max()))
    ev.eval_infer = False
    exact = ev.render_view(ev.scene.test_cameras[1])[0].numpy()
    assert (np.abs(exact - color).max() == 0.0) == cov


def test_load_reads_jax_checkpoint_with_envmap(checkpoint):
    ev = port_eval.Evaluator(port_config.load_config(None, OVERRIDES),
                             device="cpu", verbose=False)
    with pytest.raises(RuntimeError, match="no checkpoint loaded"):
        ev.render_view(ev.scene.test_cameras[0])
    ev.load(checkpoint)
    assert isinstance(ev.env, port_env.EnvMapState)
    assert tuple(ev.env.texture.shape) == (8, 8, 3) and int(ev.env.count) == 9
    assert (ev.step, ev.best_psnr, ev.n_active) == (40, 21.5, 300)
    assert ev.opts.height == ev.opts.width == 48
    # A reference .pth goes to models/torch_import.py (read there; a
    # missing one is not found).
    with pytest.raises(FileNotFoundError):
        ev.load("somewhere/chkpnt7.pth")
    # A config with strips is accepted where the frame's height divides
    # (48 = 3 x 16; tests/test_torch_strips.py holds its views to the full
    # frame), and a height that does not divide raises.
    with pytest.raises(ValueError, match="not divisible by 5"):
        port_eval.Evaluator(port_config.load_config(
            None, dict(OVERRIDES, strips=5)), device="cpu", verbose=False)
    cfg = port_config.load_config(None, dict(OVERRIDES, strips=3))
    strips = port_eval.Evaluator(cfg, device="cpu", verbose=False)
    strips.load(checkpoint)
    assert strips.render_view(strips.scene.test_cameras[0])[0].shape == (
        48, 48, 3)


def test_evaluate_metrics_match_jax_losses(checkpoint, tmp_path):
    """PSNR, SSIM and MS-SSIM of `evaluate` against the JAX losses on the
    port's own renders and the JAX package's ground truth: rtol 1e-4."""
    cfg = port_config.load_config(None, OVERRIDES)
    cfg.model.resolution = 1          # 96 px: MS-SSIM needs 5 scales
    cfg.model.model_path = str(tmp_path)
    ev = port_eval.Evaluator(cfg, device="cpu", verbose=False)
    ev.load(checkpoint)
    mean_psnr = ev.evaluate(max_cameras=2, with_msssim=True, train_views=1,
                            save_panels=True)
    assert set(ev.last_eval) == {"test", "train"}
    assert mean_psnr == ev.last_eval["test"]["psnr"]

    jscene = jax_scene.load_scene(FIXTURE, num_pts=300, resolution=1,
                                  time_duration=(0.0, 1.0), seed=cfg.seed)
    want = dict(psnr=[], ssim=[], msssim=[])
    for cam, jcam in zip(ev.scene.test_cameras[:2], jscene.test_cameras):
        color = jnp.asarray(ev.render_view(cam)[0].numpy())
        gt, alpha = jax_trainer.fetch_gt(jcam, False)
        got_gt, got_alpha = port_eval.fetch_gt(cam, False)
        np.testing.assert_array_equal(got_gt, gt)
        np.testing.assert_array_equal(got_alpha, alpha)
        want["psnr"].append(float(jax_losses.psnr(color, jnp.asarray(gt))))
        want["ssim"].append(float(jax_losses.ssim(color, jnp.asarray(gt))))
        want["msssim"].append(float(jax_losses.msssim(
            color[None], jnp.asarray(gt)[None])))
    for key, vals in want.items():
        np.testing.assert_allclose(ev.last_eval["test"][key], np.mean(vals),
                                   rtol=1e-4)
    assert 0.0 < ev.last_eval["test"]["msssim"] <= 1.0
    panels = sorted(os.listdir(tmp_path / "eval"))
    assert len(panels) == 3 and panels[0].startswith("it000040_test_")
    np.testing.assert_array_equal(
        port_eval.camera_intrinsics(ev.scene.test_cameras[0]),
        jax_trainer.camera_intrinsics(jscene.test_cameras[0]))


def test_port_checkpoint_round_trip(checkpoint, tmp_path):
    """The port's `save_checkpoint` → `load_checkpoint`: every array
    equal, the env map included; the file holds no class of the JAX
    package; an `io_pool` write lands the same bytes."""
    from concurrent.futures import ThreadPoolExecutor

    gauss, env, step, extra = port_ckpt.load_checkpoint(checkpoint,
                                                        device="cpu")
    path = str(tmp_path / "out" / "chkpnt41.pkl")
    assert port_ckpt.save_checkpoint(path, gauss, env, step + 1,
                                     extra={"best_psnr": 3.0}) is None
    gauss2, env2, step2, extra2 = port_ckpt.load_checkpoint(path,
                                                            device="cpu")
    assert (step2, extra2) == (41, {"best_psnr": 3.0})
    assert isinstance(gauss2, port_gaussians.GaussianState)
    assert isinstance(env2, port_env.EnvMapState)

    def leaves(tree):
        if isinstance(tree, tuple):
            return [x for t in tree for x in leaves(t)]
        return [tree]

    for a, b in zip(leaves(gauss) + leaves(env),
                    leaves(gauss2) + leaves(env2)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    with open(path, "rb") as f:
        raw = f.read()
    assert b"fourdgs_tpu." not in raw and b"fourdgs_tpu_torch" in raw
    assert not os.path.exists(path + ".tmp")

    with ThreadPoolExecutor(max_workers=1) as pool:
        future = port_ckpt.save_checkpoint(
            str(tmp_path / "bg.pkl"), gauss, None, 41,
            extra={"best_psnr": 3.0}, io_pool=pool)
        future.result()
    with open(tmp_path / "bg.pkl", "rb") as f:
        assert pickle.load(f)["env"] is None

    # The JAX package's own params equal what the port loaded.
    jgauss, jenv, _, _ = jax_ckpt.load_checkpoint(checkpoint)
    for name in jgauss.params._fields:
        np.testing.assert_array_equal(getattr(gauss.params, name).numpy(),
                                      np.asarray(getattr(jgauss.params,
                                                         name)))
    np.testing.assert_array_equal(env.texture.numpy(),
                                  np.asarray(jenv.texture))


@pytest.mark.parametrize("dim,rot_4d", [(4, True), (4, False), (3, False)])
def test_ply_io_round_trip_across_packages(checkpoint, tmp_path, dim, rot_4d):
    """A gaussian PLY exported by either package is byte-identical, and
    imports to the same parameters in the other."""
    gauss, _, _, _ = port_ckpt.load_checkpoint(checkpoint, device="cpu")
    jgauss, _, _, _ = jax_ckpt.load_checkpoint(checkpoint)
    a, b = str(tmp_path / "port.ply"), str(tmp_path / "jax.ply")
    port_ply.export_gaussians_ply(a, gauss, gaussian_dim=dim, rot_4d=rot_4d)
    jax_ply.export_gaussians_ply(b, jgauss, gaussian_dim=dim, rot_4d=rot_4d)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    state = port_ply.import_gaussians_ply(b, device="cpu")
    ref = jax_ply.import_gaussians_ply(a)
    n = int(ref.n_active)
    assert int(state.n_active) == n == state.params.xyz.shape[0] == 300
    for name in ref.params._fields:
        np.testing.assert_array_equal(
            getattr(state.params, name).numpy(),
            np.asarray(getattr(ref.params, name))[:n], name)
    assert float(state.adam.mu.xyz.abs().sum()) == 0.0
