"""The port's forward tile blend (the plain PyTorch version of kernel K1,
which the wrapper runs for CPU tensors) against the JAX package: its XLA
blend, its brute-force oracle and, on a tiny scene, the Pallas forward
kernel in interpret mode. Tolerances of tests/test_pallas_blend.py:
color and alpha rtol 1e-4 / atol 1e-5, depth rtol 1e-3 / atol 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fourdgs_tpu.ops import pallas_blend
from fourdgs_tpu.ops import preprocess as jax_pre
from fourdgs_tpu.ops.reference_renderer import render_reference
from fourdgs_tpu.render import render as jax_render
from fourdgs_tpu_torch.ops import binning as port_binning
from fourdgs_tpu_torch.ops import blend as port_blend
from fourdgs_tpu_torch.ops import preprocess as port_pre

from torch_helpers import corner_scene, saturated_scene, to_torch
from utils import look_at_camera, random_scene

OPTS = dict(height=48, width=40, gaussian_dim=4, rot_4d=True,
            time_duration=1.0)
XLA_KW = dict(capacity=16384, max_per_tile=1024, chunk=32)
BG = np.array([0.1, 0.2, 0.3], np.float32)


def _jax_proc(scene):
    cam = look_at_camera(width=OPTS["width"], height=OPTS["height"])
    return cam, jax_pre.preprocess(
        **{k: jnp.asarray(v) for k, v in scene.items()}, camera=cam.arrays(),
        opts=jax_pre.RenderOptions(**OPTS))


def _port_blend(jproc):
    """Port binning + blend on the JAX preprocess outputs (the blend
    alone is under test)."""
    opts = port_pre.RenderOptions(**OPTS)
    proc = port_pre.ProcessedGaussians(*to_torch(jproc))
    bins = port_binning.bin_gaussians(proc, opts)
    accum, t_final, _ = port_blend.blend_forward(
        port_blend.build_records(proc), bins.gauss_id, bins.tile_start,
        bins.tile_count, opts.tiles_x)
    return port_blend.assemble_outputs(accum, t_final, torch.as_tensor(BG),
                                       opts)


SCENES = {
    "random": lambda rng: random_scene(rng, p=56),
    "saturated": saturated_scene,
    "corner": corner_scene,
}


@pytest.mark.parametrize("scene_name", sorted(SCENES))
def test_plain_blend_matches_xla_and_oracle(rng, scene_name):
    scene = SCENES[scene_name](rng)
    cam, jproc = _jax_proc(scene)
    color, depth, flow, alpha = (x.numpy() for x in _port_blend(jproc))

    jscene = {k: jnp.asarray(v) for k, v in scene.items()}
    jopts = jax_pre.RenderOptions(**OPTS)
    ref_x = jax_render(**jscene, camera=cam.arrays(), bg=jnp.asarray(BG),
                       opts=jopts, backend="xla", **XLA_KW)
    ref_o = render_reference(**jscene, camera=cam.arrays(),
                             bg=jnp.asarray(BG), opts=jopts)
    for ref_color, ref_depth, ref_alpha in [
            (ref_x.color, ref_x.depth, ref_x.alpha),
            (ref_o[0], ref_o[1], ref_o[3])]:
        np.testing.assert_allclose(color, np.asarray(ref_color),
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(depth, np.asarray(ref_depth),
                                   rtol=1e-3, atol=1e-4)
        np.testing.assert_allclose(alpha, np.asarray(ref_alpha),
                                   rtol=1e-4, atol=1e-5)
    assert np.all(flow == 0.0)
    if scene_name == "saturated":
        assert int(ref_x.max_per_tile) > 256          # several 256-batches
        assert alpha[20:28, 16:24].min() > 0.999      # saturated centre
    if scene_name == "corner":
        assert alpha[:16, :16].max() == 0.0 and alpha.max() > 0.05


def test_plain_blend_matches_pallas_interpret(rng):
    """Tiny scene (one 128-instance chunk per tile) through the Pallas
    forward kernel in interpret mode, fed the port's sorted instance
    lists in the kernel's aligned field-major layout, with the full-f32
    log-cumsum (fwd_terms=3): T_final within atol 1e-6 (log-space vs
    sequential products), n_contrib exactly, accum within atol 1e-5."""
    scene = random_scene(rng, p=56)
    _, jproc = _jax_proc(scene)
    opts = port_pre.RenderOptions(**OPTS)
    proc = port_pre.ProcessedGaussians(*to_torch(jproc))
    bins = port_binning.bin_gaussians(proc, opts)
    rec = port_blend.build_records(proc)
    acc, tf, ncon = port_blend.blend_forward(
        rec, bins.gauss_id, bins.tile_start, bins.tile_count, opts.tiles_x)

    # Tile t's instances at [128 t, 128 t + count); zero padding rows
    # have opacity 0 and are neutral.
    k = pallas_blend.CHUNK
    count = bins.tile_count.numpy()
    assert count.max() <= k
    ids = bins.gauss_id.numpy()
    inst = np.zeros((pallas_blend.ROW, (opts.num_tiles + 1) * k), np.float32)
    for t, s in enumerate(bins.tile_start.numpy()):
        inst[:12, t * k:t * k + count[t]] = rec.numpy()[ids[s:s + count[t]]].T
    cfg = pallas_blend.PallasBlendConfig(
        height=opts.height, width=opts.width, tiles_x=opts.tiles_x,
        tiles_y=opts.tiles_y, interpret=True, fwd_terms=3)
    acc_j, tf_j, ncon_j, _ = jax.block_until_ready(
        pallas_blend.blend_forward_pallas(
            cfg, jnp.asarray(inst),
            jnp.arange(opts.num_tiles, dtype=jnp.int32) * k,
            jnp.asarray(count)))

    assert (ncon.numpy() > 0).any()
    np.testing.assert_array_equal(ncon.numpy(), np.asarray(ncon_j))
    np.testing.assert_allclose(tf.numpy(), np.asarray(tf_j), atol=1e-6)
    np.testing.assert_allclose(acc.numpy(), np.asarray(acc_j), atol=1e-5)


@pytest.mark.parametrize("scene_name", ["random", "saturated"])
def test_plain_blend_pair_counts(rng, scene_name):
    """The plain version's count of the (pixel, instance) pairs these
    inputs need, by class, against a pixel-by-pixel walk in numpy."""
    _, jproc = _jax_proc(SCENES[scene_name](rng))
    opts = port_pre.RenderOptions(**OPTS)
    proc = port_pre.ProcessedGaussians(*to_torch(jproc))
    bins = port_binning.bin_gaussians(proc, opts)
    rec = port_blend.build_records(proc)
    counts = {}
    port_blend.blend_forward_plain(rec, bins.gauss_id, bins.tile_start,
                                   bins.tile_count, opts.tiles_x,
                                   pair_counts=counts)

    r = rec.numpy()
    ids = bins.gauss_id.numpy()
    want = dict(evaluated=0, power_ok=0, alpha_ok=0, used=0)
    for tile, (s, c) in enumerate(zip(bins.tile_start.numpy(),
                                      bins.tile_count.numpy())):
        ty, tx = divmod(tile, opts.tiles_x)
        for py in range(ty * 16, ty * 16 + 16):
            for px in range(tx * 16, tx * 16 + 16):
                t = np.float32(1.0)
                for g in ids[s:s + c]:
                    want["evaluated"] += 1
                    dx, dy = r[g, 0] - px, r[g, 1] - py
                    power = (-0.5 * (r[g, 2] * dx * dx + r[g, 4] * dy * dy)
                             - r[g, 3] * dx * dy)
                    if power > 0.0:
                        continue
                    want["power_ok"] += 1
                    alpha = min(r[g, 5] * np.exp(power), np.float32(0.99))
                    if alpha < 1.0 / 255.0:
                        continue
                    want["alpha_ok"] += 1
                    if t * (1.0 - alpha) < 1e-4:
                        break
                    want["used"] += 1
                    t = t * (1.0 - alpha)
    assert counts == want
    assert want["used"] > 0


def test_wrapper_never_runs_plain_off_cpu(rng):
    """Only CPU tensors reach the plain version: any other device goes to
    the kernel path, which raises here (no CUDA), and counts nothing."""
    before = port_blend.blend_forward.launches
    meta = lambda *s, dtype=torch.float32: torch.empty(  # noqa: E731
        s, dtype=dtype, device="meta")
    with pytest.raises((ValueError, RuntimeError)):
        port_blend.blend_forward(meta(4, 12), meta(3, dtype=torch.int32),
                                 meta(6, dtype=torch.int32),
                                 meta(6, dtype=torch.int32), 3)
    assert port_blend.blend_forward.launches == before


def test_plain_blend_counts_no_launch(rng):
    scene = random_scene(rng, p=56)
    _, jproc = _jax_proc(scene)
    before = port_blend.blend_forward.launches
    _port_blend(jproc)
    assert port_blend.blend_forward.launches == before


def test_ctiles_to_image_matches_jax(rng):
    opts = port_pre.RenderOptions(**OPTS)
    x = rng.normal(size=(opts.num_tiles, 3, 256)).astype(np.float32)
    bc = pallas_blend.PallasBlendConfig(
        height=opts.height, width=opts.width, tiles_x=opts.tiles_x,
        tiles_y=opts.tiles_y)
    np.testing.assert_array_equal(
        port_blend.ctiles_to_image(torch.as_tensor(x), opts).numpy(),
        np.asarray(pallas_blend._ctiles_to_image(jnp.asarray(x), bc)))
