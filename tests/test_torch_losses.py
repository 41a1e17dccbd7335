"""The port's image losses against the JAX package's f32 path
(`fast=False`): values and gradients of l1, ssim, psnr, the photometric
loss and the sky-opacity loss, on the same numpy images, at rtol 1e-5
(gradients also atol 1e-8, for entries that are 0 up to rounding)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fourdgs_tpu.utils import losses as jax_losses
from fourdgs_tpu_torch.utils import losses as port_losses

RTOL = 1e-5


def _images(rng, shape):
    a = rng.random(shape).astype(np.float32)
    b = np.clip(a + rng.normal(0.0, 0.1, shape), 0.0, 1.0).astype(np.float32)
    return a, b


def _value_and_grad_port(fn, a, b):
    ta = torch.as_tensor(a).requires_grad_()
    out = fn(ta, torch.as_tensor(b))
    out.backward()
    return out.detach().numpy(), ta.grad.numpy()


def _check(port, ref):
    np.testing.assert_allclose(port[0], np.asarray(ref[0]), rtol=RTOL)
    np.testing.assert_allclose(port[1], np.asarray(ref[1]), rtol=RTOL,
                               atol=1e-8)


LOSSES = {
    "l1": (port_losses.l1_loss, jax_losses.l1_loss),
    "ssim": (port_losses.ssim, jax_losses.ssim),
    "psnr": (port_losses.psnr, jax_losses.psnr),
    "photometric": (lambda a, b: port_losses.photometric_loss(a, b, 0.2)[0],
                    lambda a, b: jax_losses.photometric_loss(a, b, 0.2)[0]),
    "opacity_mask": (port_losses.opacity_mask_loss,
                     jax_losses.opacity_mask_loss),
}


@pytest.mark.parametrize("name", sorted(LOSSES))
@pytest.mark.parametrize("shape", [(37, 29, 3), (2, 24, 40, 3)])
def test_loss_matches_jax(rng, name, shape):
    port_fn, jax_fn = LOSSES[name]
    if name == "opacity_mask":
        shape = shape[:-1]
    a, b = _images(rng, shape)
    _check(_value_and_grad_port(port_fn, a, b),
           jax.value_and_grad(jax_fn)(jnp.asarray(a), jnp.asarray(b)))


def test_photometric_parts_and_ssim_per_image(rng):
    a, b = _images(rng, (2, 24, 20, 3))
    loss, l1, lssim = port_losses.photometric_loss(
        torch.as_tensor(a), torch.as_tensor(b), 0.3)
    ref = jax_losses.photometric_loss(jnp.asarray(a), jnp.asarray(b), 0.3)
    for x, y in zip((loss, l1), ref):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=RTOL)
    # 1 − SSIM cancels: hold SSIM itself to rtol.
    np.testing.assert_allclose(1.0 - lssim.numpy(), 1.0 - np.asarray(ref[2]),
                               rtol=RTOL)
    np.testing.assert_allclose(
        port_losses.ssim(torch.as_tensor(a), torch.as_tensor(b),
                         size_average=False).numpy(),
        np.asarray(jax_losses.ssim(jnp.asarray(a), jnp.asarray(b),
                                   size_average=False)), rtol=RTOL)
    # Identical images: SSIM 1, up to f32 rounding.
    assert abs(float(port_losses.ssim(torch.as_tensor(a),
                                      torch.as_tensor(a))) - 1.0) < 1e-5
