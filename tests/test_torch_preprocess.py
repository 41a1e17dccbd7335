"""The port's preprocess, SH and camera math against the JAX package's,
fed the same numpy inputs on the CPU. Floats agree within rtol 1e-5 /
atol 1e-6 (same f32 operations, differently vectorised); integer fields
and masks agree exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fourdgs_tpu.data.cameras import Camera as JaxCamera
from fourdgs_tpu.data.cameras import (
    camera_from_matrices as jax_camera_from_matrices)
from fourdgs_tpu.ops import preprocess as jax_pre
from fourdgs_tpu.ops import sh as jax_sh
from fourdgs_tpu_torch.data.cameras import camera_from_matrices
from fourdgs_tpu_torch.ops import preprocess as port_pre
from fourdgs_tpu_torch.ops import sh as port_sh

from torch_helpers import port_camera, to_numpy, to_torch
from utils import look_at_camera, random_scene

RTOL, ATOL = 1e-5, 1e-6

MODES = {
    "4d_rot4d": dict(gaussian_dim=4, rot_4d=True),
    "4d_separable": dict(gaussian_dim=4, rot_4d=False),
    "3d": dict(gaussian_dim=3, rot_4d=False),
}


def _both(scene, cam, mode, sh_mask=None, **opt_kw):
    kw = dict(height=cam.height, width=cam.width, time_duration=1.0,
              **MODES[mode], **opt_kw)
    jax_out = jax_pre.preprocess(
        **{k: jnp.asarray(v) for k, v in scene.items()},
        camera=cam.arrays(), opts=jax_pre.RenderOptions(**kw),
        sh_mask=None if sh_mask is None else jnp.asarray(sh_mask))
    port_out = port_pre.preprocess(
        **to_torch(scene), camera=port_camera(cam),
        opts=port_pre.RenderOptions(**kw),
        sh_mask=None if sh_mask is None else torch.tensor(sh_mask))
    return to_numpy(jax_out), to_numpy(port_out)


def _assert_fields_equal(j, p):
    for name in jax_pre.ProcessedGaussians._fields:
        a, b = getattr(p, name), getattr(j, name)
        assert a.shape == b.shape, name
        if np.issubdtype(b.dtype, np.floating):
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(a, b.astype(a.dtype), err_msg=name)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_preprocess_fields_match_jax(rng, mode):
    scene = random_scene(rng, p=96)
    if mode == "3d":
        scene["sh"] = np.ascontiguousarray(scene["sh"][:, :16])
    # Some gaussians behind the near plane, some transparent or inactive.
    scene["means3d"][:6, 2] = 0.1
    scene["opacity"][6:10] = 1e-3
    scene["active"][10:14] = False
    cam = look_at_camera(width=40, height=48, timestamp=0.3)
    j, p = _both(scene, cam, mode)
    assert p.visible.any() and not p.visible.all()
    _assert_fields_equal(j, p)


def test_preprocess_scale_modifier_prefilter_sh_mask(rng):
    scene = random_scene(rng, p=64)
    cam = look_at_camera(width=48, height=32, timestamp=0.7)
    mask = np.asarray(jax_sh.sh_degree_mask_4d(1, 1))
    np.testing.assert_array_equal(port_sh.sh_degree_mask_4d(1, 1).numpy(),
                                  mask)
    j, p = _both(scene, cam, "4d_rot4d", sh_mask=mask, scale_modifier=0.8,
                 prefilter_var=0.05)
    _assert_fields_equal(j, p)


def test_rect_tightening_zeroes_transparent(rng):
    """tiles_touched is 0 where the final opacity is below 1/255, though
    the gaussian stays visible and keeps its radius."""
    scene = random_scene(rng, p=32)
    scene["opacity"][:8] = 2e-3
    cam = look_at_camera(width=64, height=64)
    j, p = _both(scene, cam, "4d_rot4d")
    faint = p.opacity < 1.0 / 255.0
    assert (faint & p.visible).any()
    assert (p.tiles_touched[faint] == 0).all()
    np.testing.assert_array_equal(p.tiles_touched, j.tiles_touched)


def test_sh_eval_matches_jax(rng):
    dirs = rng.normal(size=(50, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    dir_t = rng.uniform(-1, 1, 50).astype(np.float32)
    sh48 = rng.normal(0, 0.3, (50, 48, 3)).astype(np.float32)
    sh25 = rng.normal(0, 0.3, (50, 25, 3)).astype(np.float32)
    td = torch.as_tensor
    cases = [
        (port_sh.eval_sh4d(td(sh48), td(dirs), td(dir_t), 2.0,
                           port_sh.sh_degree_mask_4d(2, 1)),
         jax_sh.eval_sh4d(sh48, dirs, dir_t, 2.0,
                          jax_sh.sh_degree_mask_4d(2, 1))),
        (port_sh.eval_sh3d(td(sh25), td(dirs),
                           port_sh.sh_degree_mask_3d(3, 25)),
         jax_sh.eval_sh3d(sh25, dirs, jax_sh.sh_degree_mask_3d(3, 25))),
        (port_sh.sh_to_rgb(td(sh25[:, 0])), jax_sh.sh_to_rgb(sh25[:, 0])),
    ]
    for a, b in cases:
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                   atol=ATOL)
    for args in [(3, 2, 4, False), (2, 0, 4, False), (3, 1, 3, False),
                 (1, 2, 4, True)]:
        assert port_sh.num_sh_channels(*args) == jax_sh.num_sh_channels(*args)


@pytest.mark.parametrize("intrinsics", [False, True])
def test_camera_arrays_match_jax(rng, intrinsics):
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    w, x, y, z = q
    rot = np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])
    extra = (dict(cx=30.0, cy=20.0, fl_x=55.0, fl_y=52.0) if intrinsics
             else {})
    cam = JaxCamera(uid=3, rot=rot, trans=rng.normal(size=3), fovx=0.9,
                    fovy=0.7, width=64, height=48, timestamp=0.25, **extra)
    pairs = [(cam.arrays(), port_camera(cam))]
    if not intrinsics:
        args = (cam.width, cam.height, cam.fovx, cam.fovy, cam.viewmatrix,
                cam.full_proj, cam.timestamp)
        pairs.append((jax_camera_from_matrices(*args),
                      camera_from_matrices(*args, device="cpu")))
    for j, p in pairs:
        for name in jax_pre.CameraArrays._fields:
            np.testing.assert_allclose(getattr(p, name).numpy(),
                                       np.asarray(getattr(j, name)),
                                       rtol=1e-6, atol=1e-7, err_msg=name)


@pytest.mark.parametrize("which", ["colors", "cov3d", "both"])
def test_precomputed_colour_and_covariance_match_jax(rng, which):
    """`colors_precomp` and `cov3d_precomp` (the reference's oracle paths)
    against the JAX preprocess on the same arrays: floats rtol 1e-5 / atol
    1e-6, integer and boolean fields exact."""
    scene = random_scene(rng, p=48)
    cam = look_at_camera(width=40, height=48)
    extra = {}
    if which in ("colors", "both"):
        extra["colors_precomp"] = rng.random((48, 3)).astype(np.float32)
    if which in ("cov3d", "both"):
        a = rng.normal(0, 0.2, (48, 3, 3))
        cov = a @ a.transpose(0, 2, 1) + 0.01 * np.eye(3)
        extra["cov3d_precomp"] = np.stack(
            [cov[:, 0, 0], cov[:, 0, 1], cov[:, 0, 2], cov[:, 1, 1],
             cov[:, 1, 2], cov[:, 2, 2]], axis=1).astype(np.float32)
    opts = dict(height=48, width=40, gaussian_dim=4, rot_4d=True,
                time_duration=1.0)
    got = port_pre.preprocess(
        **to_torch(scene), **to_torch(extra), camera=port_camera(cam),
        opts=port_pre.RenderOptions(**opts))
    want = jax_pre.preprocess(
        **{k: jnp.asarray(v) for k, v in {**scene, **extra}.items()},
        camera=cam.arrays(), opts=jax_pre.RenderOptions(**opts))
    for name in want._fields:
        a, b = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        if b.dtype.kind in "ib":
            np.testing.assert_array_equal(a, b, name)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6,
                                       err_msg=name)
    if "colors_precomp" in extra:
        np.testing.assert_array_equal(got.rgb.numpy(),
                                      extra["colors_precomp"])
    if "cov3d_precomp" in extra:
        np.testing.assert_array_equal(got.cov3d.numpy(),
                                      extra["cov3d_precomp"])
        np.testing.assert_array_equal(got.means3d.numpy(), scene["means3d"])
    assert int(got.visible.sum()) > 0
