"""The port's serving slice end to end against the JAX package, on the
CPU: render (preprocess → binning → plain blend), the serving module on a
checkpoint written by the JAX package, activation, and the oracle.
Tolerances of tests/test_pallas_blend.py: color and alpha rtol 1e-4 /
atol 1e-5, depth rtol 1e-3 / atol 1e-4."""

import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fourdgs_tpu.engine.checkpoint import save_checkpoint
from fourdgs_tpu.models import gaussians as jax_gaussians
from fourdgs_tpu.models.envmap import init_envmap
from fourdgs_tpu.ops.preprocess import RenderOptions as JaxOptions
from fourdgs_tpu.ops.reference_renderer import (
    render_reference as jax_reference)
from fourdgs_tpu.render import mark_visible as jax_mark_visible
from fourdgs_tpu.render import render as jax_render
from fourdgs_tpu_torch.engine.checkpoint import load_checkpoint
from fourdgs_tpu_torch.models.gaussians import from_jax_params
from fourdgs_tpu_torch.ops.preprocess import RenderOptions
from fourdgs_tpu_torch.ops.reference_renderer import render_reference
from fourdgs_tpu_torch.render import GaussianRenderer, mark_visible, render

from torch_helpers import port_camera, saturated_scene, to_torch
from utils import look_at_camera, random_scene

OPTS = dict(height=48, width=40, gaussian_dim=4, rot_4d=True,
            time_duration=1.0)
XLA_KW = dict(capacity=16384, max_per_tile=1024, chunk=32)
BG = np.array([0.2, 0.4, 0.6], np.float32)


def _assert_images(color, depth, alpha, ref_color, ref_depth, ref_alpha):
    np.testing.assert_allclose(color, np.asarray(ref_color), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(depth, np.asarray(ref_depth), rtol=1e-3,
                               atol=1e-4)
    np.testing.assert_allclose(alpha, np.asarray(ref_alpha), rtol=1e-4,
                               atol=1e-5)


SCENES = {
    "partial_tiles": lambda rng: random_scene(rng, p=56),
    "saturated": saturated_scene,
}


@pytest.mark.parametrize("scene_name", sorted(SCENES))
def test_render_matches_jax(rng, scene_name):
    scene = SCENES[scene_name](rng)
    cam = look_at_camera(width=OPTS["width"], height=OPTS["height"])
    out = render(**to_torch(scene), camera=port_camera(cam),
                 bg=torch.as_tensor(BG), opts=RenderOptions(**OPTS))
    ref = jax_render(**{k: jnp.asarray(v) for k, v in scene.items()},
                     camera=cam.arrays(), bg=jnp.asarray(BG),
                     opts=JaxOptions(**OPTS), backend="xla", **XLA_KW)
    _assert_images(out.color.numpy(), out.depth.numpy(), out.alpha.numpy(),
                   ref.color, ref.depth, ref.alpha)
    assert out.color.shape == (OPTS["height"], OPTS["width"], 3)
    assert np.all(out.flow.numpy() == 0.0)
    np.testing.assert_array_equal(out.radii.numpy(), np.asarray(ref.radii))
    np.testing.assert_array_equal(out.visible.numpy(),
                                  np.asarray(ref.visible))
    np.testing.assert_allclose(out.cov3d_com.numpy(),
                               np.asarray(ref.cov3d_com), rtol=1e-5,
                               atol=1e-6)
    assert out.num_rendered == int(ref.num_rendered) > 0
    assert int(out.max_per_tile) == int(ref.max_per_tile)
    assert out.instances_dropped == 0 == int(ref.instances_dropped)
    if scene_name == "saturated":
        assert out.num_rendered > 256 and int(out.max_per_tile) > 256


def test_reference_renderer_matches_jax(rng):
    scene = random_scene(rng, p=56)
    cam = look_at_camera(width=OPTS["width"], height=OPTS["height"])
    port = render_reference(**to_torch(scene), camera=port_camera(cam),
                            bg=torch.as_tensor(BG),
                            opts=RenderOptions(**OPTS))
    ref = jax_reference(**{k: jnp.asarray(v) for k, v in scene.items()},
                        camera=cam.arrays(), bg=jnp.asarray(BG),
                        opts=JaxOptions(**OPTS))
    _assert_images(port[0].numpy(), port[1].numpy(), port[3].numpy(),
                   ref[0], ref[1], ref[3])


def _raw_params(scene, capacity):
    """JAX GaussianParams (numpy, pre-activation) holding `scene` in its
    first rows and the JAX package's padding rows after them."""
    p = scene["means3d"].shape[0]
    pad = jax_gaussians.empty_params(capacity, scene["sh"].shape[1])
    raw = dict(
        xyz=scene["means3d"], t=scene["t"][:, None],
        scaling=np.log(scene["scales"]),
        scaling_t=np.log(scene["scales_t"])[:, None],
        rotation=scene["rotations"] * 1.7, rotation_r=scene["rotations_r"],
        f_dc=scene["sh"][:, :1], f_rest=scene["sh"][:, 1:],
        opacity=np.log(scene["opacity"] / (1 - scene["opacity"]))[:, None])
    return jax_gaussians.GaussianParams(**{
        k: np.asarray(getattr(pad, k)).copy() for k in raw})._replace(**{
            k: np.concatenate([v.astype(np.float32),
                               np.asarray(getattr(pad, k))[p:]])
            for k, v in raw.items()})


def test_from_jax_params_activation_matches_jax(rng):
    scene = random_scene(rng, p=30)
    params = _raw_params(scene, capacity=40)
    model = from_jax_params(params._asdict(), 30, device="cpu")
    port = model.activate()
    ref = jax_gaussians.activate(
        jax_gaussians.GaussianParams(*map(jnp.asarray, params)),
        jnp.asarray(30))
    for name in jax_gaussians.Activated._fields:
        np.testing.assert_allclose(getattr(port, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=1e-6, atol=1e-7, err_msg=name)
    assert int(port.active.sum()) == 30


def test_renderer_serves_jax_checkpoint(rng, tmp_path):
    """A checkpoint written by the JAX package's save_checkpoint, read by
    the port's load_checkpoint, served by GaussianRenderer: equal to the
    JAX eval path (activate → render → clip)."""
    scene = random_scene(rng, p=56)
    params = _raw_params(scene, capacity=64)
    zeros = jax_gaussians.GaussianParams(*(np.zeros_like(x) for x in params))
    state = jax_gaussians.GaussianState(
        params=params,
        adam=jax_gaussians.AdamState(mu=zeros, nu=zeros,
                                     count=np.int32(3)),
        n_active=np.int32(56), xyz_grad_accum=np.zeros(64, np.float32),
        t_grad_accum=np.zeros(64, np.float32),
        denom=np.zeros(64, np.float32), max_radii2d=np.zeros(64, np.float32))
    path = str(tmp_path / "chkpnt7.pkl")
    save_checkpoint(path, state, init_envmap(4), step=7,
                    extra={"note": "x"})

    gauss, env, step, extra = load_checkpoint(path, device="cpu")
    assert (step, extra) == (7, {"note": "x"})
    assert env.texture.shape == (4, 4, 3) and int(gauss.n_active) == 56
    assert gauss.adam.count.item() == 3

    renderer = GaussianRenderer.from_checkpoint(
        path, RenderOptions(**OPTS), bg=BG.tolist(), device="cpu")
    cam = look_at_camera(width=OPTS["width"], height=OPTS["height"],
                         timestamp=0.4)
    color, depth, alpha, nr, mpt, dropped = renderer(port_camera(cam))

    act = jax_gaussians.activate(
        jax_gaussians.GaussianParams(*map(jnp.asarray, params)),
        jnp.asarray(56))
    ref = jax_render(**act._asdict(), camera=cam.arrays(),
                     bg=jnp.asarray(BG), opts=JaxOptions(**OPTS),
                     backend="xla", **XLA_KW)
    _assert_images(color.numpy(), depth.numpy(), alpha.numpy(),
                   jnp.clip(ref.color, 0.0, 1.0), ref.depth, ref.alpha)
    assert nr == int(ref.num_rendered) and int(mpt) == int(ref.max_per_tile)
    assert dropped == 0
    assert 0.0 <= float(color.min()) and float(color.max()) <= 1.0


def test_checkpoint_refuses_other_jax_classes(tmp_path):
    path = tmp_path / "bad.pkl"
    with open(path, "wb") as f:
        pickle.dump({"gauss": JaxOptions(height=4, width=4), "env": None,
                     "step": 0}, f)
    with pytest.raises(pickle.UnpicklingError, match="no counterpart"):
        load_checkpoint(str(path), device="cpu")


def test_mark_visible_and_infer(rng):
    scene = random_scene(rng, p=20)
    scene["means3d"][:5, 2] = 0.1
    cam = look_at_camera()
    port_cam = port_camera(cam)
    np.testing.assert_array_equal(
        mark_visible(torch.as_tensor(scene["means3d"]),
                     port_cam.viewmatrix).numpy(),
        np.asarray(jax_mark_visible(jnp.asarray(scene["means3d"]),
                                    cam.arrays().viewmatrix)))
    with pytest.raises(NotImplementedError, match="K3"):
        render(**to_torch(scene), camera=port_cam, bg=torch.zeros(3),
               opts=RenderOptions(height=64, width=64), infer=True)
