"""Helpers shared by the tests of the PyTorch port (tests/test_torch_*.py):
the same numpy inputs handed to the JAX package and to the port, on the
CPU."""

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
