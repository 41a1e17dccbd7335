"""Gradients of the port's `render` (preprocess → binning → Blend, with the
plain K1/K2 on the CPU) against `jax.grad` of the JAX package's render
(XLA backend): a colour, depth and alpha loss, differentiated with respect
to the 8 differentiable post-activation inputs and `mean2d_tap`, under an
SH annealing mask. Tolerance: the scale-normalised atol 2e-4 of
tests/test_pallas_blend.py:67-71. A NaN in any gradient fails."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fourdgs_tpu.ops import sh as jax_sh
from fourdgs_tpu.ops.preprocess import RenderOptions as JaxOptions
from fourdgs_tpu.render import render as jax_render
from fourdgs_tpu_torch.ops import sh as port_sh
from fourdgs_tpu_torch.ops.preprocess import RenderOptions
from fourdgs_tpu_torch.render import render

from torch_helpers import assert_scaled_close, port_camera, saturated_scene
from utils import look_at_camera, random_scene

DIFF = ("means3d", "t", "scales", "scales_t", "rotations", "rotations_r",
        "opacity", "sh")
BG = np.array([0.05, 0.1, 0.15], np.float32)

SCENES = {
    "random": (lambda rng: random_scene(rng, p=48), 48, 40),
    "saturated": (saturated_scene, 48, 40),
}


def _loss_terms(rng, h, w):
    return (rng.random((h, w, 3)).astype(np.float32),
            rng.random((h, w)).astype(np.float32))


@pytest.mark.parametrize("scene_name", sorted(SCENES))
def test_render_grads_match_jax(rng, scene_name):
    make, h, w = SCENES[scene_name]
    scene = make(rng)
    tgt, wd = _loss_terms(rng, h, w)
    opts = dict(height=h, width=w, gaussian_dim=4, rot_4d=True,
                time_duration=1.0)
    cam = look_at_camera(width=w, height=h, timestamp=0.4)
    p = scene["means3d"].shape[0]

    def jax_loss(d, tap):
        out = jax_render(**d, active=jnp.asarray(scene["active"]),
                         camera=cam.arrays(), bg=jnp.asarray(BG),
                         opts=JaxOptions(**opts), capacity=16384,
                         max_per_tile=1024, chunk=32,
                         sh_mask=jax_sh.sh_degree_mask_4d(2, 1),
                         mean2d_tap=tap, backend="xla")
        return (jnp.sum((out.color - tgt) ** 2) + jnp.sum(out.depth * wd)
                + 0.7 * jnp.sum(out.alpha * wd))

    jd = {k: jnp.asarray(scene[k]) for k in DIFF}
    jval, (jg, jg_tap) = jax.value_and_grad(jax_loss, argnums=(0, 1))(
        jd, jnp.zeros((p, 2), jnp.float32))

    td = {k: torch.as_tensor(scene[k]).requires_grad_() for k in DIFF}
    tap = torch.zeros((p, 2), requires_grad=True)
    out = render(**td, active=torch.as_tensor(scene["active"]),
                 camera=port_camera(cam), bg=torch.as_tensor(BG),
                 opts=RenderOptions(**opts),
                 sh_mask=port_sh.sh_degree_mask_4d(2, 1), mean2d_tap=tap)
    loss = (torch.sum((out.color - torch.as_tensor(tgt)) ** 2)
            + torch.sum(out.depth * torch.as_tensor(wd))
            + 0.7 * torch.sum(out.alpha * torch.as_tensor(wd)))
    loss.backward()

    np.testing.assert_allclose(float(loss.detach()), float(jval), rtol=1e-5)
    for k in DIFF:
        g = td[k].grad.numpy()
        assert np.isfinite(g).all(), f"NaN or inf in the {k} gradient"
        assert_scaled_close(g, jg[k], k)
    assert np.isfinite(tap.grad.numpy()).all()
    assert_scaled_close(tap.grad.numpy(), jg_tap, "mean2d_tap")
    assert np.abs(tap.grad.numpy()).max() > 0.0
    # The annealing mask zeroes the gradient of the masked SH channels.
    masked = port_sh.sh_degree_mask_4d(2, 1).numpy() == 0.0
    assert masked.any() and np.all(td["sh"].grad.numpy()[:, masked] == 0.0)


def test_render_grads_finite_with_culled_gaussians(rng):
    """Gaussians behind the near plane, with a tiny marginal, or outside
    the image are culled; their gradients are zero and every gradient is
    finite, as the JAX package's masked formulas keep them."""
    scene = random_scene(rng, p=24)
    scene["means3d"][:4, 2] = 0.1            # behind the near plane
    scene["t"][4:8] = 40.0                   # marginal ≈ 0 at t = 0.5
    scene["means3d"][8:12, 0] = 50.0         # far off screen
    h, w = 32, 32
    td = {k: torch.as_tensor(scene[k]).requires_grad_() for k in DIFF}
    cam = look_at_camera(width=w, height=h)
    out = render(**td, active=torch.as_tensor(scene["active"]),
                 camera=port_camera(cam), bg=torch.as_tensor(BG),
                 opts=RenderOptions(height=h, width=w))
    (out.color.sum() + out.depth.sum() + out.alpha.sum()).backward()
    assert not out.visible[:12].any() and out.visible[12:].any()
    for k in DIFF:
        g = td[k].grad.numpy()
        assert np.isfinite(g).all(), f"NaN or inf in the {k} gradient"
        assert np.all(g[:12] == 0.0), k
