"""The port's training step and its parts against the JAX package, on the
CPU: learning-rate schedule, Adam, densification statistics, SH
annealing, and one whole `train_step` (batch 2, rigid loss on, 64x64)
against `build_step_fn(backend="xla", fast_grad_reduce=False)`.

Tolerances: learning rates rtol 1e-6 (f32 in JAX, f64 on the host here);
Adam those of tests/test_adam_oracle.py (parameters rtol 1e-4 / atol
5e-6, moments rtol 2e-6); the step's gradients (read from the Adam first
moments, 0.1·g after a step from zero moments) and densification
statistics at the scale-normalised atol 2e-4 of
tests/test_pallas_blend.py:67-71; loss values rtol 1e-5. Parameters after
the step are compared only where the JAX gradient is above 1e-3 of its
leaf's largest: Adam's first step moves every nonzero gradient by ±lr, so
noise-sized gradients are no test of it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fourdgs_tpu.data.cameras import Camera, stack_cameras
from fourdgs_tpu.engine import step as jax_step
from fourdgs_tpu.models import densify as jax_densify
from fourdgs_tpu.models import gaussians as jax_gaussians
from fourdgs_tpu.ops.preprocess import RenderOptions as JaxOptions
from fourdgs_tpu_torch.engine import step as port_step
from fourdgs_tpu_torch.models import densify as port_densify
from fourdgs_tpu_torch.models import gaussians as port_gaussians
from fourdgs_tpu_torch.ops.preprocess import RenderOptions

from torch_helpers import assert_scaled_close, port_camera
from utils import random_scene

LEGO = dict(lambda_dssim=0.2, lambda_rigid=1.0, sh_degree=3, sh_degree_t=2,
            spatial_lr_scale=2.5, position_lr_init=0.00016,
            position_lr_final=1.6e-06, position_lr_delay_mult=0.01,
            position_lr_max_steps=30000, feature_lr=0.0025,
            opacity_lr=0.05, scaling_lr=0.005, rotation_lr=0.001)
FIELDS = jax_gaussians.GaussianParams._fields


@pytest.mark.parametrize("step", [0, 1, 999, 7000, 29999, 30000, 45000])
def test_group_lrs_match_jax(step):
    for extra in ({}, {"position_t_lr_init": 3e-4}):
        cfg = port_step.StepConfig(**LEGO, **extra)
        jcfg = jax_step.StepConfig(**LEGO, **extra)
        port = port_gaussians.group_lrs(cfg, cfg.spatial_lr_scale, step)
        ref = jax_gaussians.group_lrs(jcfg, jcfg.spatial_lr_scale, step)
        for f in FIELDS:
            np.testing.assert_allclose(getattr(port, f),
                                       float(getattr(ref, f)), rtol=1e-6,
                                       err_msg=f)
    np.testing.assert_allclose(
        port_gaussians.expon_lr(step, 1e-2, 1e-4, lr_delay_steps=500,
                                lr_delay_mult=0.1, max_steps=30000),
        float(jax_gaussians.expon_lr(step, 1e-2, 1e-4, lr_delay_steps=500,
                                     lr_delay_mult=0.1, max_steps=30000)),
        rtol=1e-6)


def _params(rng, shapes):
    return {k: rng.normal(0, 0.5, s).astype(np.float32)
            for k, s in shapes.items()}


SHAPES = {"xyz": (12, 3), "t": (12, 1), "scaling": (12, 3),
          "scaling_t": (12, 1), "rotation": (12, 4), "rotation_r": (12, 4),
          "f_dc": (12, 1, 3), "f_rest": (12, 15, 3), "opacity": (12, 1)}


def test_adam_update_matches_jax(rng):
    p0 = _params(rng, SHAPES)
    cfg = port_step.StepConfig(**LEGO)
    mask = np.arange(12) < 10
    jp = jax_gaussians.GaussianParams(**{k: jnp.asarray(v)
                                         for k, v in p0.items()})
    jz = jax_gaussians.GaussianParams(*(jnp.zeros_like(x) for x in jp))
    jstate = jax_gaussians.AdamState(jz, jz, jnp.zeros((), jnp.int32))
    tp = port_gaussians.GaussianParams(**{k: torch.as_tensor(v)
                                          for k, v in p0.items()})
    tz = port_gaussians.GaussianParams(*(torch.zeros_like(x) for x in tp))
    tstate = port_gaussians.AdamState(tz, tz, torch.zeros((),
                                                          dtype=torch.int64))
    for i in range(5):
        g = _params(rng, SHAPES)
        lrs = port_gaussians.group_lrs(cfg, 1.0, 100 * i)
        jlrs = jax_gaussians.group_lrs(jax_step.StepConfig(**LEGO), 1.0,
                                       100 * i)
        jp, jstate = jax_gaussians.adam_update(
            jp, jax_gaussians.GaussianParams(**{k: jnp.asarray(v)
                                                for k, v in g.items()}),
            jstate, jlrs, update_mask=jnp.asarray(mask))
        tp, tstate = port_gaussians.adam_update(
            tp, port_gaussians.GaussianParams(**{k: torch.as_tensor(v)
                                                 for k, v in g.items()}),
            tstate, lrs, update_mask=torch.as_tensor(mask))
    assert int(tstate.count) == int(jstate.count) == 5
    for k in FIELDS:
        np.testing.assert_allclose(getattr(tp, k).numpy(),
                                   np.asarray(getattr(jp, k)), rtol=1e-4,
                                   atol=5e-6, err_msg=k)
        np.testing.assert_allclose(getattr(tstate.mu, k).numpy(),
                                   np.asarray(getattr(jstate.mu, k)),
                                   rtol=2e-6, atol=1e-8, err_msg=k)
        np.testing.assert_allclose(getattr(tstate.nu, k).numpy(),
                                   np.asarray(getattr(jstate.nu, k)),
                                   rtol=2e-6, atol=1e-9, err_msg=k)
        # Masked rows keep their parameters.
        np.testing.assert_array_equal(getattr(tp, k).numpy()[10:],
                                      p0[k][10:])


def _jax_state(rng, scene, capacity, moments=False):
    """JAX GaussianState (numpy leaves) holding `scene` in its first rows
    and the JAX package's padding rows after them."""
    n = scene["means3d"].shape[0]
    pad = jax_gaussians.empty_params(capacity, scene["sh"].shape[1])
    op = scene["opacity"].astype(np.float64)
    raw = dict(
        xyz=scene["means3d"], t=scene["t"][:, None],
        scaling=np.log(scene["scales"]),
        scaling_t=np.log(scene["scales_t"])[:, None],
        rotation=scene["rotations"] * 1.3, rotation_r=scene["rotations_r"],
        f_dc=scene["sh"][:, :1], f_rest=scene["sh"][:, 1:],
        opacity=np.log(op / (1.0 - op))[:, None])
    params = jax_gaussians.GaussianParams(**{
        k: np.concatenate([v.astype(np.float32),
                           np.asarray(getattr(pad, k))[n:]])
        for k, v in raw.items()})

    def moment():
        return jax_gaussians.GaussianParams(*(
            (np.abs(rng.normal(0, 1e-3, x.shape)) if moments
             else np.zeros(x.shape)).astype(np.float32) for x in params))

    acc = lambda: rng.random(capacity).astype(np.float32)  # noqa: E731
    return jax_gaussians.GaussianState(
        params=params,
        adam=jax_gaussians.AdamState(moment(), moment(),
                                     np.int32(3 if moments else 0)),
        n_active=np.int32(n), xyz_grad_accum=acc(), t_grad_accum=acc(),
        denom=np.floor(acc() * 5), max_radii2d=np.floor(acc() * 9))


def test_from_jax_state_and_densification_stats(rng):
    state = _jax_state(rng, random_scene(rng, p=20), 24, moments=True)
    port = port_gaussians.from_jax_state(state, device="cpu")
    assert int(port.adam.count) == 3 and int(port.n_active) == 20
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(port.params, f).numpy(),
                                      getattr(state.params, f))
        np.testing.assert_array_equal(getattr(port.adam.nu, f).numpy(),
                                      getattr(state.adam.nu, f))
    grad = rng.random(24).astype(np.float32)
    tgrad = rng.normal(size=24).astype(np.float32)
    vis = rng.random(24) > 0.4
    radii = rng.integers(0, 12, 24).astype(np.int32)
    got = port_densify.add_densification_stats(
        port, torch.as_tensor(grad), torch.as_tensor(tgrad),
        torch.as_tensor(vis), torch.as_tensor(radii))
    ref = jax_densify.add_densification_stats(
        jax.tree.map(jnp.asarray, state), jnp.asarray(grad),
        jnp.asarray(tgrad), jnp.asarray(vis), jnp.asarray(radii))
    for f in ("xyz_grad_accum", "t_grad_accum", "denom", "max_radii2d"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(ref, f)), rtol=1e-6,
                                   err_msg=f)


@pytest.mark.parametrize("gaussian_dim,force_3d", [(4, False), (3, False),
                                                   (4, True)])
def test_sh_annealing_mask_matches_jax(gaussian_dim, force_3d):
    cfg = port_step.StepConfig(**LEGO)
    opts = dict(height=8, width=8, gaussian_dim=gaussian_dim,
                force_sh_3d=force_3d)
    channels = 48 if gaussian_dim == 4 and not force_3d else 16
    for step in (0, 999, 1000, 2500, 3000, 4000, 5000, 9000):
        port = port_step.sh_annealing_mask(step, cfg, RenderOptions(**opts),
                                           channels)
        ref = jax_step.sh_annealing_mask(
            jnp.int32(step), jax_step.StepConfig(**LEGO), JaxOptions(**opts),
            channels)
        np.testing.assert_array_equal(port.numpy(), np.asarray(ref),
                                      err_msg=f"step {step}")


# Modes of the step (StepConfig and RenderOptions fields over the lego
# defaults, the SH channels, the background and a random opacity mask).
MODES = {
    "lego": {},
    # Pure 3DGS: t, scaling_t and rotation_r never reach the loss (their
    # gradients are zeros in both packages).
    "gaussian_dim_3": dict(gaussian_dim=3, rot_4d=False, channels=16,
                           sh_degree_t=0, lambda_rigid=0.0),
    "rot_4d_off": dict(rot_4d=False),
    "force_sh_3d": dict(force_sh_3d=True, channels=16),
    "opa_mask_white": dict(lambda_opa_mask=0.1, white=True, mask=True),
    "motion": dict(lambda_motion=0.5),
}
OPT_KEYS = ("gaussian_dim", "rot_4d", "force_sh_3d")


def _mode_inputs(rng, mode, b, hw, n, capacity):
    """(JAX state, cameras, gt, mask, bg, StepConfig kwargs, options) of
    one mode of the step."""
    m = MODES[mode]
    scene = random_scene(rng, p=n)
    scene["sh"] = scene["sh"][:, :m.get("channels", 48)]
    state = _jax_state(rng, scene, capacity)
    # Cameras half a unit behind the origin: the padding rows sit at the
    # origin, and at a camera centre their SH direction is 0/0, which
    # both packages turn into NaN gradients of those (inactive) rows.
    cams = [Camera(uid=i, rot=np.eye(3), trans=np.array([0.0, 0.0, 0.5]),
                   fovx=1.0, fovy=1.0, width=hw, height=hw, timestamp=ts)
            for i, ts in enumerate((0.3, 0.6))]
    gt = rng.random((b, hw, hw, 3)).astype(np.float32)
    mask = (rng.random((b, hw, hw)) > 0.5 if m.get("mask")
            else np.ones((b, hw, hw))).astype(np.float32)
    bg = np.full(3, 1.0 if m.get("white") else 0.0, np.float32)
    step_kw = {**LEGO, **{k: v for k, v in m.items() if k in
                          ("sh_degree_t", "lambda_rigid", "lambda_opa_mask",
                           "lambda_motion")}}
    opts = dict(dict(height=hw, width=hw, gaussian_dim=4, rot_4d=True,
                     time_duration=1.0),
                **{k: m[k] for k in OPT_KEYS if k in m})
    return state, cams, gt, mask, bg, step_kw, opts


@pytest.mark.parametrize("mode", list(MODES))
def test_train_step_matches_jax(rng, mode):
    b, hw, n, capacity, step = 2, 64, 300, 320, 2500
    state, cams, gt, mask, bg, step_kw, opts = _mode_inputs(
        rng, mode, b, hw, n, capacity)

    step_fn = jax.jit(jax_step.build_step_fn(
        JaxOptions(**opts), jax_step.StepConfig(**step_kw), capacity=16384,
        max_per_tile=1024, chunk=32, batch_size=b, backend="xla",
        fast_grad_reduce=False))
    jnew, _, jm = step_fn(jax.tree.map(jnp.asarray, state), None,
                          jnp.int32(step),
                          jax.tree.map(jnp.asarray, stack_cameras(cams)),
                          jnp.asarray(gt), jnp.asarray(mask),
                          jnp.zeros((b, 4), jnp.float32), jnp.asarray(bg))

    new, env, m = port_step.train_step(
        port_gaussians.from_jax_state(state, device="cpu"), step,
        [port_camera(c) for c in cams], torch.as_tensor(gt),
        torch.as_tensor(mask), torch.as_tensor(bg),
        port_step.StepConfig(**step_kw), RenderOptions(**opts))
    assert env is None

    for f in ("loss", "l1", "ssim_loss", "psnr", "rigid", "motion"):
        np.testing.assert_allclose(float(getattr(m, f)),
                                   float(getattr(jm, f)), rtol=1e-5,
                                   err_msg=f)
    assert (float(m.rigid) > 0.0) == (step_kw["lambda_rigid"] > 0)
    assert (float(m.motion) > 0.0) == (step_kw.get("lambda_motion", 0) > 0)
    assert m.num_rendered == int(jm.num_rendered)
    assert int(m.max_per_tile) == int(jm.max_per_tile)
    assert m.instances_dropped == 0 == int(jm.instances_dropped)
    assert int(new.adam.count) == 1

    np.testing.assert_array_equal(new.denom.numpy(), np.asarray(jnew.denom))
    np.testing.assert_array_equal(new.max_radii2d.numpy(),
                                  np.asarray(jnew.max_radii2d))
    for f in ("xyz_grad_accum", "t_grad_accum"):
        assert_scaled_close(getattr(new, f).numpy(),
                            np.asarray(getattr(jnew, f)), f)

    for f in FIELDS:
        jg = np.asarray(getattr(jnew.adam.mu, f)) / 0.1   # the gradient
        g = getattr(new.adam.mu, f).numpy() / 0.1
        assert np.isfinite(g).all(), f"NaN or inf in the {f} gradient"
        # Padding rows neither learn nor move.
        np.testing.assert_array_equal(getattr(new.params, f).numpy()[n:],
                                      getattr(state.params, f)[n:])
        if not jg.any():        # a leaf no loss term reaches
            np.testing.assert_array_equal(g, 0.0, err_msg=f)
            np.testing.assert_array_equal(getattr(new.params, f).numpy(),
                                          getattr(state.params, f))
            continue
        assert_scaled_close(g, jg, f)
        big = np.abs(jg) > 1e-3 * np.abs(jg).max()
        np.testing.assert_allclose(
            getattr(new.params, f).numpy()[big],
            np.asarray(getattr(jnew.params, f))[big], rtol=1e-5, atol=1e-7,
            err_msg=f)
    if mode == "gaussian_dim_3":
        assert not np.asarray(jnew.adam.mu.t).any()


@pytest.mark.parametrize("window", ["inside", "outside"])
def test_train_step_env_map_matches_jax(rng, window):
    """The sky of a 16x16 environment map composited into each camera's
    colour and the map's own Adam step, inside the env_optimize window and
    before it (the map then keeps its texture, moments and count)."""
    from fourdgs_tpu.engine.trainer import camera_intrinsics
    from fourdgs_tpu.models import envmap as jax_env
    from fourdgs_tpu_torch.models import envmap as port_env

    b, hw, n, capacity, step = 2, 48, 200, 220, 2500
    state, cams, gt, mask, bg, step_kw, opts = _mode_inputs(
        rng, "lego", b, hw, n, capacity)
    step_kw = dict(step_kw, env_map_res=16,
                   env_optimize_from=0 if window == "inside" else step + 1)
    f32 = lambda *s: rng.random(s).astype(np.float32)  # noqa: E731
    env = jax_env.EnvMapState(texture=f32(16, 16, 3),
                              mu=(f32(16, 16, 3) - 0.5) * 1e-3,
                              nu=f32(16, 16, 3) * 1e-6, count=np.int32(9))
    intr = np.stack([camera_intrinsics(c) for c in cams])

    step_fn = jax.jit(jax_step.build_step_fn(
        JaxOptions(**opts), jax_step.StepConfig(**step_kw), capacity=16384,
        max_per_tile=1024, chunk=32, batch_size=b, backend="xla",
        fast_grad_reduce=False))
    jnew, jenv, jm = step_fn(
        jax.tree.map(jnp.asarray, state), jax.tree.map(jnp.asarray, env),
        jnp.int32(step), jax.tree.map(jnp.asarray, stack_cameras(cams)),
        jnp.asarray(gt), jnp.asarray(mask), jnp.asarray(intr),
        jnp.asarray(bg))

    new, penv, m = port_step.train_step(
        port_gaussians.from_jax_state(state, device="cpu"), step,
        [port_camera(c) for c in cams], torch.as_tensor(gt),
        torch.as_tensor(mask), torch.as_tensor(bg),
        port_step.StepConfig(**step_kw), RenderOptions(**opts),
        env=port_env.from_jax_envmap(env, device="cpu"),
        intrinsics=torch.as_tensor(intr))

    for f in ("loss", "l1", "ssim_loss", "psnr"):
        np.testing.assert_allclose(float(getattr(m, f)),
                                   float(getattr(jm, f)), rtol=1e-5,
                                   err_msg=f)
    assert int(penv.count) == int(jenv.count) == (10 if window == "inside"
                                                  else 9)
    if window == "outside":
        for f in ("texture", "mu", "nu"):
            np.testing.assert_array_equal(getattr(penv, f).numpy(),
                                          getattr(env, f), err_msg=f)
    else:
        # The map's gradient, read from its first moment: (mu − 0.9·mu0)/0.1.
        jg = (np.asarray(jenv.mu) - 0.9 * env.mu) / 0.1
        g = (penv.mu.numpy() - 0.9 * env.mu) / 0.1
        assert np.abs(jg).max() > 1e-3
        assert_scaled_close(g, jg, "env texture")
        np.testing.assert_allclose(penv.nu.numpy(), np.asarray(jenv.nu),
                                   rtol=1e-4, atol=1e-12)
        np.testing.assert_allclose(penv.texture.numpy(),
                                   np.asarray(jenv.texture), rtol=1e-5,
                                   atol=1e-6)
    # The gaussians' step sees the sky too.
    jg = np.asarray(jnew.adam.mu.f_dc) / 0.1
    assert_scaled_close(new.adam.mu.f_dc.numpy() / 0.1, jg, "f_dc")
