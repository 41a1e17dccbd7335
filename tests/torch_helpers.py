"""Helpers shared by the tests of the PyTorch port (tests/test_torch_*.py):
the same numpy inputs handed to the JAX package and to the port, on the
CPU."""

import os

import numpy as np
import torch

from fourdgs_tpu_torch.data import cameras as port_cameras

CPU = "cpu"


def to_torch(tree):
    """numpy arrays (dict or NamedTuple) → CPU tensors of the same dtype."""
    if isinstance(tree, dict):
        return {k: torch.as_tensor(np.array(v)) for k, v in tree.items()}
    return type(tree)(*(torch.as_tensor(np.array(v)) for v in tree))


def to_numpy(tree):
    """A NamedTuple of tensors or jax arrays → the same of numpy arrays."""
    return type(tree)(*(v.numpy() if isinstance(v, torch.Tensor)
                        else np.asarray(v) for v in tree))


def port_camera(cam):
    """The port's CameraArrays for a JAX-package `Camera` record."""
    return port_cameras.Camera(
        uid=cam.uid, rot=cam.rot, trans=cam.trans, fovx=cam.fovx,
        fovy=cam.fovy, width=cam.width, height=cam.height,
        timestamp=cam.timestamp, cx=cam.cx, cy=cam.cy, fl_x=cam.fl_x,
        fl_y=cam.fl_y).arrays(CPU)


def assert_scaled_close(a, b, name, atol=2e-4):
    """The scale-normalised gradient check of
    tests/test_pallas_blend.py:67-71: |a - b| / max(|b|.max(), 1e-3) <=
    atol."""
    a, b = np.asarray(a), np.asarray(b)
    scale = max(np.abs(b).max(), 1e-3)
    np.testing.assert_allclose(a / scale, b / scale, atol=atol,
                               err_msg=f"grad mismatch for {name}")


def saturated_scene(rng, p=420):
    """Many overlapping gaussians over the image centre with a near-opaque
    front third (tests/test_pallas_blend.py:test_multichunk_saturation):
    central tiles are more than 256 instances deep and saturate."""
    from utils import random_scene

    scene = random_scene(rng, p=p)
    scene["means3d"][:, 0] = rng.uniform(-0.25, 0.25, p)
    scene["means3d"][:, 1] = rng.uniform(-0.25, 0.25, p)
    scene["means3d"][:, 2] = rng.uniform(2.0, 6.0, p)
    scene["opacity"][:] = rng.uniform(0.3, 0.95, p)
    scene["opacity"][scene["means3d"][:, 2] < 3.0] = 0.99
    return scene


def corner_scene(rng, p=48):
    """Everything in the lower-right corner: leading tiles stay empty
    (tests/test_pallas_blend.py:test_empty_tiles_interleaved)."""
    from utils import random_scene

    scene = random_scene(rng, p=p)
    scene["means3d"][:, 0] = rng.uniform(0.9, 1.6, p)
    scene["means3d"][:, 1] = rng.uniform(0.9, 1.6, p)
    scene["means3d"][:, 2] = rng.uniform(2.0, 3.0, p)
    scene["scales"] = (scene["scales"] * 0.2).astype(np.float32)
    return scene


SYNTH_GATE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "fixtures", "synth_gate")
# Config overrides (both packages' `load_config`) for the fixture at 48 px.
SYNTH_GATE_OVERRIDES = dict(
    gaussian_dim=4, rot_4d=True, time_duration=[0.0, 1.0], num_pts=300,
    model=dict(source_path=SYNTH_GATE, resolution=2, eval=True),
    pipeline=dict(eval_shfs_4d=True, env_map_res=8))


def jax_synth_gate_state(seed=0, p=300):
    """(JAX GaussianState, JAX EnvMapState) on the fixture's point cloud,
    with visible sizes and some transparency, and a random 8x8 environment
    map: what a test saves with the JAX package's `save_checkpoint`."""
    import jax.numpy as jnp

    from fourdgs_tpu.data import scene as jax_scene
    from fourdgs_tpu.models import envmap as jax_env
    from fourdgs_tpu.models import gaussians as jax_gaussians

    rng = np.random.default_rng(seed)
    pcd = jax_scene.load_scene(SYNTH_GATE, num_pts=p, resolution=2,
                               seed=seed).point_cloud
    n = len(pcd.points)
    state = jax_gaussians.init_from_pcd(
        pcd.points, pcd.colors, sh_channels=48, time_duration=(0.0, 1.0),
        times=pcd.times, capacity=n + 20, seed=seed)
    params = state.params
    params = params._replace(
        scaling=params.scaling.at[:n].set(
            jnp.asarray(rng.normal(-2.6, 0.3, (n, 3)), jnp.float32)),
        rotation_r=params.rotation_r.at[:n].set(
            jnp.asarray(rng.normal(size=(n, 4)), jnp.float32)),
        f_rest=params.f_rest.at[:n].set(
            jnp.asarray(rng.normal(0, 0.1, (n, 47, 3)), jnp.float32)),
        opacity=params.opacity.at[:n].set(
            jnp.asarray(rng.normal(0.5, 1.0, (n, 1)), jnp.float32)))
    env = jax_env.init_envmap(8)._replace(
        texture=jnp.asarray(rng.random((8, 8, 3)), jnp.float32),
        count=jnp.asarray(9, jnp.int32))
    return state._replace(params=params), env
