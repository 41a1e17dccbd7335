"""The port's image losses against the JAX package's f32 path
(`fast=False`): values and gradients of l1, l2, ssim, psnr, the
photometric loss and the sky-opacity loss, on the same numpy images, at
rtol 1e-5 (gradients also atol 1e-8, for entries that are 0 up to
rounding); multi-scale SSIM at rtol 1e-5."""

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
    "l2": (port_losses.l2_loss, jax_losses.l2_loss),
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


@pytest.mark.parametrize("shape", [(96, 80, 3), (2, 81, 99, 3)])
def test_msssim_matches_jax(rng, shape):
    """5 scales: the smallest is 6x5 (and 5x6 after odd floors). rtol 1e-5
    on the value; the pooling alone is compared exactly."""
    a, b = _images(rng, shape)
    got = port_losses.msssim(torch.as_tensor(a), torch.as_tensor(b))
    want = jax_losses.msssim(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL)
    assert 0.0 < float(got) < 1.0
    batched = a if a.ndim == 4 else a[None]
    np.testing.assert_allclose(
        port_losses._avg_pool2(torch.as_tensor(batched)).numpy(),
        np.asarray(jax_losses._avg_pool2(jnp.asarray(batched))), rtol=1e-6)
    same = port_losses.msssim(torch.as_tensor(a), torch.as_tensor(a))
    assert abs(float(same) - 1.0) < 1e-5


def test_image_utils_match_jax(rng, tmp_path):
    from fourdgs_tpu.utils import image as jax_image
    from fourdgs_tpu_torch.utils import image as port_image

    a, b = _images(rng, (2, 12, 10, 3))
    np.testing.assert_allclose(
        port_image.mse(torch.as_tensor(a), torch.as_tensor(b)).numpy(),
        np.asarray(jax_image.mse(jnp.asarray(a), jnp.asarray(b))), rtol=RTOL)
    d = rng.normal(3.0, 1.0, (9, 7)).astype(np.float32)
    np.testing.assert_allclose(
        port_image.easy_cmap(torch.as_tensor(d)).numpy(),
        np.asarray(jax_image.easy_cmap(jnp.asarray(d))), rtol=RTOL)
    port_image.mkdir_p(str(tmp_path / "a" / "b"))
    for name in ("chkpnt7.pkl", "chkpnt30000.pkl", "chkpnt_best.pkl",
                 "events.out.99999"):
        (tmp_path / "a" / name).write_text("")
    for prefix in ("chkpnt", ""):
        assert (port_image.search_for_max_iteration(str(tmp_path / "a"),
                                                    prefix)
                == jax_image.search_for_max_iteration(str(tmp_path / "a"),
                                                      prefix))
    with pytest.raises(ValueError):
        port_image.search_for_max_iteration(str(tmp_path / "a" / "b"))
