"""The port's strips (`parallel/strips.py`) against the JAX package's, on
the CPU: strip cameras, arrays and options; a frame rendered as strips
and joined; `train_step(strips=n)`; `Evaluator.render_view` with
cfg.strips; render_cli on a `strips: 2` config.

The port renders a strip as its window of the frame (the frame's camera,
rows from the tile row at or above the strip's first row), which equals
the full frame. Where H/n is a multiple of 16 the JAX package's strip
cameras render the same pixels, and the port is held to the JAX strips
path. Where it is not (48/2 = 24, 48/4 = 12 rows), a JAX strip bins on a
tile grid shifted from the frame's and differs from the full frame at
the edges of footprints (the rect of a gaussian reaches pixels beyond
its radius in the tiles it touches); there the port is held to
the JAX package's FULL-FRAME path, which the JAX strips design intends to
reproduce (fourdgs_tpu/engine/step.py:119-127).

Tolerances: renders atol 2e-5 (tests/test_strips.py:42-45); the step's
loss rtol 1e-5, PSNR rtol 1e-4, xyz atol 1e-5, xyz_grad_accum atol 1e-5
rtol 1e-4, max_radii2d atol 1e-4 (tests/test_parallel.py:117-127), the
gradients (Adam's first moments) at the scale-normalised atol 2e-4 of
tests/test_pallas_blend.py:67-71; the evaluator's renders those of
tests/test_torch_evaluator.py (colour and alpha rtol 1e-4 / atol 1e-5,
depth rtol 1e-3 / atol 1e-4; the packed path atol 1.5e-2)."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from fourdgs_tpu import config as jax_config
from fourdgs_tpu.data import scene as jax_scene
from fourdgs_tpu.data.cameras import Camera, stack_cameras
from fourdgs_tpu.engine import checkpoint as jax_ckpt
from fourdgs_tpu.engine import step as jax_step
from fourdgs_tpu.engine.trainer import camera_intrinsics
from fourdgs_tpu.models import envmap as jax_env
from fourdgs_tpu.models import gaussians as jax_gaussians
from fourdgs_tpu.ops.preprocess import RenderOptions as JaxOptions
from fourdgs_tpu.parallel import strips as jax_strips
from fourdgs_tpu.render import render as jax_render
from fourdgs_tpu_torch import config as port_config
from fourdgs_tpu_torch import render_cli
from fourdgs_tpu_torch.data import cameras as port_cameras
from fourdgs_tpu_torch.engine import evaluator as port_eval
from fourdgs_tpu_torch.engine import step as port_step
from fourdgs_tpu_torch.models import envmap as port_env
from fourdgs_tpu_torch.models import gaussians as port_gaussians
from fourdgs_tpu_torch.ops.preprocess import RenderOptions
from fourdgs_tpu_torch.parallel import make_mesh, multihost
from fourdgs_tpu_torch.parallel import strips as port_strips
from fourdgs_tpu_torch.render import render

from torch_helpers import (SYNTH_GATE, SYNTH_GATE_OVERRIDES,
                           assert_scaled_close, free_port, jax_eval_fn,
                           jax_synth_gate_state,
                           one_torch_thread)  # noqa: F401
from utils import random_scene


def port_cam(cam):
    """The port's Camera for a JAX-package Camera."""
    return port_cameras.Camera(**{f.name: getattr(cam, f.name) for f in
                                  dataclasses.fields(port_cameras.Camera)})


CAMS = {
    "fov": Camera(uid=0, rot=np.eye(3), trans=np.zeros(3), fovx=1.0,
                  fovy=1.2, width=40, height=48, timestamp=0.5),
    "intrinsics": Camera(uid=1, rot=np.eye(3), trans=np.array([0, 0, 0.5]),
                         fovx=1.0, fovy=1.2, width=40, height=48,
                         timestamp=0.2, cx=21.0, cy=23.5, fl_x=40.0,
                         fl_y=41.0),
}


@pytest.mark.parametrize("kind", list(CAMS))
def test_strip_cameras_arrays_options_match_jax(kind):
    cam = CAMS[kind]
    for n in (2, 3, 4):
        want = jax_strips.strip_cameras(cam, n)
        got = port_strips.strip_cameras(port_cam(cam), n)
        assert len(got) == n
        for g, w in zip(got, want):
            for f in ("height", "width", "fl_x", "fl_y", "cx", "cy",
                      "timestamp"):
                assert getattr(g, f) == getattr(w, f), f
        arrays = port_strips.strip_batch_arrays(port_cam(cam), n, "cpu")
        for f, w in zip(arrays._fields,
                        jax_strips.strip_batch_arrays(cam, n)):
            np.testing.assert_array_equal(getattr(arrays, f).numpy(), w,
                                          err_msg=f)
        opts = RenderOptions(height=48, width=40)
        want_opts = jax_strips.strip_options(JaxOptions(height=48, width=40),
                                             n)
        assert port_strips.strip_options(opts, n)._asdict() == dict(
            want_opts._asdict(), frame_height=0, row0=0)
        # The windows: each strip grown up to the tile row at or above it.
        rows = port_strips.window_rows(48, n)
        assert rows == [(s * (48 // n)) % 16 for s in range(n)]
        for s, (win, o) in enumerate(zip(
                port_strips.strip_windows(opts, n), rows)):
            assert win.row0 % 16 == 0 and win.row0 == s * (48 // n) - o
            assert win.row0 + win.height == (s + 1) * (48 // n)
            assert (win.width, win.frame_height) == (40, 48)
    with pytest.raises(ValueError, match="not divisible by 5"):
        port_strips.strip_cameras(port_cam(cam), 5)
    with pytest.raises(ValueError, match="not divisible by 5"):
        port_strips.strip_options(RenderOptions(height=48, width=40), 5)
    img = torch.arange(48 * 40 * 3, dtype=torch.float32).reshape(48, 40, 3)
    parts = port_strips.split_image(img, 4)
    np.testing.assert_array_equal(
        parts.numpy(), jax_strips.split_image(img.numpy(), 4))
    assert torch.equal(port_strips.join_strips(parts), img)


@pytest.mark.parametrize("height,n", [(64, 4), (48, 4)])
def test_strip_render_matches_jax_and_full_frame(rng, height, n):
    """The frame as n strips, joined: equal to the port's full frame and
    the JAX package's, and, where the heights align (64/4 = 16 rows), to
    the JAX package's strips."""
    scene = random_scene(rng, p=48)
    cam = Camera(uid=0, rot=np.eye(3), trans=np.zeros(3), fovx=1.0,
                 fovy=1.0, width=40, height=height, timestamp=0.5)
    bg = np.array([0.2, 0.1, 0.3], np.float32)
    jopts = JaxOptions(height=height, width=40, gaussian_dim=4,
                       rot_4d=True, time_duration=1.0)
    jscene = {k: jnp.asarray(v) for k, v in scene.items()}

    def jax_one(c, opts):
        out = jax_render(**jscene, camera=jax.tree.map(jnp.asarray,
                                                       c.arrays()),
                         bg=jnp.asarray(bg), opts=opts, capacity=4096,
                         max_per_tile=256, chunk=16)
        return np.asarray(out.color), np.asarray(out.alpha)

    opts = RenderOptions(height=height, width=40)
    tscene = {k: torch.as_tensor(v) for k, v in scene.items()}
    with torch.no_grad():
        full = render(**tscene, camera=port_cam(cam).arrays("cpu"),
                      bg=torch.as_tensor(bg), opts=opts)
        crops = port_strips.window_rows(height, n)
        parts = [render(**tscene, camera=port_cam(cam).arrays("cpu"),
                        bg=torch.as_tensor(bg), opts=wo)
                 for wo in port_strips.strip_windows(opts, n)]
    color = torch.cat([p.color[o:] for p, o in zip(parts, crops)]).numpy()
    alpha = torch.cat([p.alpha[o:] for p, o in zip(parts, crops)]).numpy()
    # The windows' rows are the full frame's bit for bit.
    np.testing.assert_array_equal(color, full.color.numpy())
    np.testing.assert_array_equal(alpha, full.alpha.numpy())
    jcolor, jalpha = jax_one(cam, jopts)
    np.testing.assert_allclose(color, jcolor, atol=2e-5)
    np.testing.assert_allclose(alpha, jalpha, atol=2e-5)
    if (height // n) % 16 == 0:
        js = [jax_one(c, jax_strips.strip_options(jopts, n))
              for c in jax_strips.strip_cameras(cam, n)]
        np.testing.assert_allclose(color, np.concatenate([c for c, _ in js]),
                                   atol=2e-5)


# (height, width, the port's strip counts, batch, env map, opacity-mask
# loss, the JAX step's strips: n where its strips are the port's windows,
# 1 where they are not and the JAX full-frame step is the reference).
STEP_CASES = {
    "strips2_env_opa": (64, 48, (2,), 2, True, True, 2),
    "strips4": (64, 32, (4,), 1, False, False, 4),
    "unaligned_strips2_4": (48, 40, (2, 4), 1, True, False, 1),
}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_train_step_strips_match_jax(rng, case):
    h, w, port_ns, b, env_on, opa, jax_n = STEP_CASES[case]
    pts = rng.uniform(-1, 1, (200, 3)).astype(np.float32)
    pts[:, 2] += 4.0
    state = jax_gaussians.init_from_pcd(
        pts, rng.random((200, 3)).astype(np.float32), sh_channels=48,
        capacity=200)
    cams = [Camera(uid=i, rot=np.eye(3), trans=np.zeros(3), fovx=1.0,
                   fovy=1.1, width=w, height=h, timestamp=0.3 + 0.4 * i)
            for i in range(b)]
    gt = rng.random((b, h, w, 3)).astype(np.float32)
    mask = (rng.random((b, h, w)) > 0.3).astype(np.float32)
    bg = np.full(3, 1.0 if opa else 0.0, np.float32)
    kw = dict(sh_degree=3, sh_degree_t=2, lambda_rigid=1.0,
              lambda_opa_mask=0.1 if opa else 0.0,
              env_map_res=8 if env_on else 0)
    env = None
    if env_on:
        env = jax_env.init_envmap(8)._replace(
            texture=jnp.asarray(rng.random((8, 8, 3)), jnp.float32))

    jcams = [s for c in cams for s in jax_strips.strip_cameras(c, jax_n)] \
        if jax_n > 1 else cams
    jintr = np.stack([camera_intrinsics(c) for c in jcams])
    step_fn = jax.jit(jax_step.build_step_fn(
        JaxOptions(height=h, width=w, gaussian_dim=4, rot_4d=True,
                   time_duration=1.0), jax_step.StepConfig(**kw),
        capacity=16384, max_per_tile=1024, chunk=32, batch_size=b,
        backend="xla", fast_grad_reduce=False, strips=jax_n))
    jnew, jenv, jm = step_fn(
        jax.tree.map(jnp.asarray, state), env, jnp.int32(1),
        jax.tree.map(jnp.asarray, stack_cameras(jcams)), jnp.asarray(gt),
        jnp.asarray(mask), jnp.asarray(jintr), jnp.asarray(bg))

    intr = np.stack([camera_intrinsics(c) for c in cams])
    for n in port_ns:
        new, penv, m = port_step.train_step(
            port_gaussians.from_jax_state(state, device="cpu"), 1,
            [port_cam(c).arrays("cpu") for c in cams], torch.as_tensor(gt),
            torch.as_tensor(mask), torch.as_tensor(bg),
            port_step.StepConfig(**kw), RenderOptions(height=h, width=w),
            env=port_env.from_jax_envmap(env, device="cpu") if env_on
            else None, intrinsics=torch.as_tensor(intr), strips=n)
        np.testing.assert_allclose(float(m.loss), float(jm.loss), rtol=1e-5)
        np.testing.assert_allclose(float(m.psnr), float(jm.psnr), rtol=1e-4)
        np.testing.assert_allclose(new.params.xyz.numpy(),
                                   np.asarray(jnew.params.xyz), atol=1e-5)
        np.testing.assert_allclose(new.xyz_grad_accum.numpy(),
                                   np.asarray(jnew.xyz_grad_accum),
                                   atol=1e-5, rtol=1e-4)
        np.testing.assert_allclose(new.max_radii2d.numpy(),
                                   np.asarray(jnew.max_radii2d), atol=1e-4)
        np.testing.assert_array_equal(new.denom.numpy(),
                                      np.asarray(jnew.denom))
        assert m.instances_dropped == 0
        for f in jax_gaussians.GaussianParams._fields:
            assert_scaled_close(getattr(new.adam.mu, f).numpy(),
                                np.asarray(getattr(jnew.adam.mu, f)), f)
        if env_on:
            assert_scaled_close(penv.mu.numpy(), np.asarray(jenv.mu), "env")


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ckpt") / "chkpnt40.pkl")
    state, env = jax_synth_gate_state()
    jax_ckpt.save_checkpoint(path, state, env, 40)
    return path


@pytest.fixture(scope="module")
def one_rank_mesh():
    """The data axis over a gloo group of this process alone."""
    multihost.initialize(f"127.0.0.1:{free_port()}", 1, 0, device="cpu")
    try:
        yield make_mesh()
    finally:
        torch.distributed.destroy_process_group()


@pytest.mark.parametrize("infer", [False, True], ids=["exact", "eval_infer"])
@pytest.mark.parametrize("n", [3, 4])
def test_evaluator_strips_match_jax_and_full_frame(checkpoint, one_rank_mesh,
                                                   n, infer):
    """cfg.strips = n on the fixture at 48 px, its strips on a mesh of one
    rank: the port's view equals its full frame, and the JAX eval
    renderer's strips where they are the port's windows (3 strips of 16
    rows), else its full frame (4 strips of 12 rows, where the JAX strips'
    shifted tile grids move pixels)."""
    ev = port_eval.Evaluator(port_config.load_config(
        None, dict(SYNTH_GATE_OVERRIDES, strips=n)), device="cpu",
        verbose=False)
    ev.eval_infer = infer
    ev.load(checkpoint)
    ev.mesh = one_rank_mesh
    cam = ev.scene.test_cameras[1]
    strips = [x.numpy() for x in ev.render_view(cam)]
    counts = dict(ev.last_counts)
    ev.cfg.strips = 1
    full = [x.numpy() for x in ev.render_view(cam)]
    for s, f in zip(strips, full):
        np.testing.assert_array_equal(s, f)
    assert counts["instances_dropped"] == 0 < counts["num_rendered"]

    jcfg = jax_config.load_config(None, SYNTH_GATE_OVERRIDES)
    jcam = jax_scene.load_scene(SYNTH_GATE, num_pts=300, resolution=2,
                                time_duration=(0.0, 1.0),
                                seed=jcfg.seed).test_cameras[1]
    gauss, env, _, _ = jax_ckpt.load_checkpoint(checkpoint)
    jopts = JaxOptions(height=48, width=48, gaussian_dim=4, rot_4d=True,
                       time_duration=1.0)

    def jax_view(c, opts):
        out = jax_eval_fn(jcfg, opts, env, infer)(
            gauss, env.texture, jax.tree.map(jnp.asarray, c.arrays()),
            jnp.asarray(camera_intrinsics(c)))
        return [np.asarray(x) for x in out[:3]]

    if n == 3:                   # the JAX strips path (trainer.py:536-591)
        parts = [jax_view(c, jax_strips.strip_options(jopts, n))
                 for c in jax_strips.strip_cameras(jcam, n)]
        ref = [np.concatenate([p[k] for p in parts]) for k in range(3)]
    else:
        ref = jax_view(jcam, jopts)
    if infer:
        for s, r in zip(strips, ref):
            np.testing.assert_allclose(
                s, r, atol=1.5e-2 * max(1.0, np.abs(r).max()))
    else:
        for s, r, (rtol, atol) in zip(strips, ref, ((1e-4, 1e-5),
                                                    (1e-3, 1e-4),
                                                    (1e-4, 1e-5))):
            np.testing.assert_allclose(s, r, rtol=rtol, atol=atol)


def test_render_cli_strips_config(checkpoint, tmp_path):
    """render_cli on a YAML with `strips: 2`: in one process its views
    are the full frames, and so are their metrics."""
    cfg = dict(gaussian_dim=4, time_duration=[0.0, 1.0], rot_4d=True,
               num_pts=300, strips=2,
               ModelParams=dict(source_path=SYNTH_GATE, resolution=2,
                                eval=True),
               PipelineParams=dict(eval_shfs_4d=True, env_map_res=8))
    metrics = {}
    for strips in (2, 1):
        cfg["strips"] = strips
        path = tmp_path / f"cfg{strips}.yaml"
        with open(path, "w") as f:
            yaml.safe_dump(cfg, f)
        out = tmp_path / f"out{strips}"
        assert render_cli.main(["--config", str(path), "--checkpoint",
                                checkpoint, "--device", "cpu", "--out",
                                str(out), "--max_views", "2"]) == 0
        with open(out / "metrics.json") as f:
            metrics[strips] = json.load(f)
    for key in ("psnr", "ssim"):
        np.testing.assert_allclose(metrics[2][key], metrics[1][key],
                                   rtol=1e-5)
