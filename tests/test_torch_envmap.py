"""The port's environment map against the JAX package on the same numpy
inputs: camera rays, the bilinear sampler (taps at the texture's seams and
outside it), the sky colour, the composite, and `from_jax_envmap`.
Tolerance rtol 1e-5 / atol 1e-6 (f32 trigonometry and sums in another
order); the sampler's taps are compared at atol 1e-6."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fourdgs_tpu.models import envmap as jax_env
from fourdgs_tpu_torch.models import envmap as port_env

from utils import look_at_camera

TOL = dict(rtol=1e-5, atol=1e-6)


def _pose(rng):
    """A rotated, translated camera inside the sky sphere."""
    q = rng.normal(size=4)
    w, x, y, z = q / np.linalg.norm(q)
    rot = np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])
    view = np.eye(4, dtype=np.float32)
    view[:3, :3] = rot
    view[:3, 3] = rng.uniform(-3, 3, 3)
    return view


@pytest.mark.parametrize("intr", [(30.0, 28.0, 12.0, 9.5),
                                  (55.5, 55.5, 10.2, 8.1)])
def test_camera_rays_match_jax(rng, intr):
    view, intr = _pose(rng), np.float32(intr)
    o, d = port_env.camera_rays(torch.as_tensor(view), torch.as_tensor(intr),
                                18, 24)
    ro, rd = jax_env.camera_rays(jnp.asarray(view), jnp.asarray(intr), 18, 24)
    np.testing.assert_allclose(o.numpy(), np.asarray(ro), **TOL)
    np.testing.assert_allclose(d.numpy(), np.asarray(rd), **TOL)
    assert tuple(d.shape) == (18, 24, 3)


def test_bilinear_sample_matches_jax_at_seams(rng):
    """uv on a grid that covers the texel centres, the edges (-1 and 1,
    where two taps fall outside and read zero) and points beyond them."""
    tex = rng.random((7, 5, 3)).astype(np.float32)
    edge = np.float32([-1.2, -1.0, -0.999, -0.8, -1e-4, 0.0, 0.31, 0.8,
                       0.999, 1.0, 1.3])
    uv = np.stack(np.meshgrid(edge, edge), axis=-1).astype(np.float32)
    uv = np.concatenate([uv.reshape(-1, 2),
                         rng.uniform(-1, 1, (200, 2)).astype(np.float32)])
    got = port_env._bilinear_sample(torch.as_tensor(tex), torch.as_tensor(uv))
    want = jax_env._bilinear_sample(jnp.asarray(tex), jnp.asarray(uv))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    # Matches torch's own grid_sample (align_corners=False, zeros padding).
    ref = torch.nn.functional.grid_sample(
        torch.as_tensor(tex).permute(2, 0, 1)[None],
        torch.as_tensor(uv)[None, None], mode="bilinear",
        padding_mode="zeros", align_corners=False)[0, :, 0].T
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-6)


def test_sample_sky_and_composite_match_jax(rng):
    h, w = 20, 28
    view = _pose(rng)
    intr = np.float32([25.0, 25.0, w / 2, h / 2])
    tex = rng.random((16, 16, 3)).astype(np.float32)
    color = rng.random((h, w, 3)).astype(np.float32)
    alpha = rng.random((h, w)).astype(np.float32)

    o, d = port_env.camera_rays(torch.as_tensor(view), torch.as_tensor(intr),
                                h, w)
    sky = port_env.sample_sky(torch.as_tensor(tex), o, d)
    ro, rd = jax_env.camera_rays(jnp.asarray(view), jnp.asarray(intr), h, w)
    # The texel a ray lands in can differ at a texel edge when the ray
    # differs by an ulp, so hold the sky on the JAX rays.
    sky_on_jax_rays = port_env.sample_sky(
        torch.as_tensor(tex), torch.as_tensor(np.array(ro)),
        torch.as_tensor(np.array(rd)))
    want = np.asarray(jax_env.sample_sky(jnp.asarray(tex), ro, rd))
    np.testing.assert_allclose(sky_on_jax_rays.numpy(), want, rtol=1e-4,
                               atol=1e-4)
    assert sky.shape == (h, w, 3) and float(sky.max()) > 0.5

    got = port_env.composite_sky(
        torch.as_tensor(color), torch.as_tensor(alpha), torch.as_tensor(tex),
        torch.as_tensor(view), torch.as_tensor(intr))
    ref = jax_env.composite_sky(jnp.asarray(color), jnp.asarray(alpha),
                                jnp.asarray(tex), jnp.asarray(view),
                                jnp.asarray(intr))
    # atol 1e-3: a bilinear weight moves by ~res · 1e-6 per ulp of the ray.
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-3)
    np.testing.assert_allclose(
        got.numpy(), color + (1 - alpha)[..., None] * sky.numpy(), atol=1e-6)


def test_identity_camera_sees_the_sky_seam():
    """The identity camera looks down +z, the pole of the equirect map;
    the composite stays finite there and equals the JAX package's."""
    cam = look_at_camera(width=16, height=16)
    intr = np.float32([14.6, 14.6, 8.0, 8.0])
    tex = np.random.default_rng(3).random((8, 8, 3)).astype(np.float32)
    zeros = np.zeros((16, 16), np.float32)
    got = port_env.composite_sky(
        torch.zeros(16, 16, 3), torch.as_tensor(zeros), torch.as_tensor(tex),
        torch.as_tensor(cam.viewmatrix), torch.as_tensor(intr))
    ref = jax_env.composite_sky(jnp.zeros((16, 16, 3)), jnp.asarray(zeros),
                                jnp.asarray(tex),
                                jnp.asarray(cam.viewmatrix),
                                jnp.asarray(intr))
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-3)


def test_init_and_from_jax_envmap(rng):
    env = port_env.init_envmap(6, device="cpu")
    ref = jax_env.init_envmap(6)
    for a, b in zip(env, ref):
        assert tuple(a.shape) == tuple(b.shape)
        assert float(a.sum()) == 0.0
    filled = jax_env.EnvMapState(
        texture=rng.random((6, 6, 3)).astype(np.float32),
        mu=rng.normal(size=(6, 6, 3)).astype(np.float32),
        nu=rng.random((6, 6, 3)).astype(np.float32), count=np.int32(17))
    port = port_env.from_jax_envmap(filled, device="cpu")
    assert isinstance(port, port_env.EnvMapState)
    for name in ("texture", "mu", "nu"):
        assert getattr(port, name).dtype == torch.float32
        np.testing.assert_array_equal(getattr(port, name).numpy(),
                                      getattr(filled, name))
    assert port.count.dtype == torch.int64 and int(port.count) == 17
