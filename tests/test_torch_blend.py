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
from fourdgs_tpu_torch.utils import tracing
from fourdgs_tpu_torch.ops import preprocess as port_pre

from torch_helpers import (WARP_OF, check_cull_against_exact_test,
                           corner_scene, cull_records, saturated_scene,
                           to_torch, walk_pair_counts)
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

    want = walk_pair_counts(rec, bins, opts)
    assert counts == want
    assert want["used"] > 0
    assert want["warp_active"] <= want["warp_kept"] < want["warp_live"]


def test_wrapper_never_runs_plain_off_cpu(rng):
    """Only CPU tensors reach the plain version: any other device goes to
    the kernel path, which raises here (no CUDA), and counts nothing."""
    before = tracing.totals().get("launches.k1", 0)
    meta = lambda *s, dtype=torch.float32: torch.empty(  # noqa: E731
        s, dtype=dtype, device="meta")
    with pytest.raises((ValueError, RuntimeError)):
        port_blend.blend_forward(meta(4, 12), meta(3, dtype=torch.int32),
                                 meta(6, dtype=torch.int32),
                                 meta(6, dtype=torch.int32), 3)
    assert tracing.totals().get("launches.k1", 0) == before


def test_plain_blend_counts_no_launch(rng):
    scene = random_scene(rng, p=56)
    _, jproc = _jax_proc(scene)
    before = tracing.totals().get("launches.k1", 0)
    _port_blend(jproc)
    assert tracing.totals().get("launches.k1", 0) == before


def test_forward_observer_sees_each_call(rng):
    """`blend_forward.observer` receives the arguments and the result of
    every call, through `Blend`'s forward."""
    _, jproc = _jax_proc(random_scene(rng, p=56))
    opts = port_pre.RenderOptions(**OPTS)
    proc = port_pre.ProcessedGaussians(*to_torch(jproc))
    bins = port_binning.bin_gaussians(proc, opts)
    rec = port_blend.build_records(proc)
    seen = []
    port_blend.blend_forward.observer = lambda a, out: seen.append((a, out))
    try:
        port_blend.Blend.apply(rec, torch.as_tensor(BG), bins, opts)
    finally:
        port_blend.blend_forward.observer = None
    assert len(seen) == 1
    args, out = seen[0]
    assert args[1] is bins.gauss_id and args[-1] == opts.tiles_x
    for got, want in zip(out, port_blend.blend_forward_plain(*args)):
        np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_ctiles_to_image_matches_jax(rng):
    opts = port_pre.RenderOptions(**OPTS)
    x = rng.normal(size=(opts.num_tiles, 3, 256)).astype(np.float32)
    bc = pallas_blend.PallasBlendConfig(
        height=opts.height, width=opts.width, tiles_x=opts.tiles_x,
        tiles_y=opts.tiles_y)
    np.testing.assert_array_equal(
        port_blend.ctiles_to_image(torch.as_tensor(x), opts).numpy(),
        np.asarray(pallas_blend._ctiles_to_image(jnp.asarray(x), bc)))


@pytest.mark.parametrize("rows", [1, 2])
def test_by_warp_is_the_kernels_thread_mapping(rows):
    """`by_warp` and `warp_rects` against the index arithmetic of the
    kernels: thread tid (warp tid // 32, lane tid % 32) owns the pixels
    (x0 + lane % 8, y0 + lane // 8 + 4·o), o < rows, of its warp's block
    at (x0, y0) = ((warp % 2)·8, (warp // 2)·4·rows): one pixel in K2, two
    in K1."""
    planes = torch.arange(2 * 256).reshape(2, 256)
    got = port_blend.by_warp(planes, rows).numpy()
    x0, x1, y0, y1 = (b.numpy() for b in
                      port_blend.warp_rects(6, 3, "cpu", rows))
    assert got.shape == (2, 8 // rows, 32 * rows)
    seen = set()
    for tid in range(256 // rows):
        warp, lane = divmod(tid, 32)
        for o in range(rows):
            x = (warp % 2) * 8 + lane % 8
            y = (warp // 2) * 4 * rows + lane // 8 + 4 * o
            p = y * 16 + x
            seen.add(p)
            assert 256 + p in got[1, warp]
            # Tile 4 of a 3-wide grid is at (16, 16).
            assert x0[4, warp] <= 16 + x <= x1[4, warp]
            assert y0[4, warp] <= 16 + y <= y1[4, warp]
            if rows == port_blend.FORWARD_ROWS:
                assert WARP_OF[p] == warp
    assert len(seen) == 256
    assert (x1 - x0 == 7).all() and (y1 - y0 == 4 * rows - 1).all()


@pytest.mark.parametrize("kind", ["random", "near_threshold", "correlated",
                                  "degenerate"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_warp_cull_never_rejects_a_used_pair(kind, seed):
    """The conservative warp cull and the expf pre-test against the exact
    test of the plain versions on f32 records, on every 8x4 (K2) and 8x8
    (K1) block of a 48x40 image with partial tiles: wherever the exact test
    accepts a pixel, the pair's power is not under `skip_threshold` and
    its warp keeps the instance (`check_cull_against_exact_test`); on the
    random kind the cull is not vacuous."""
    rec = torch.as_tensor(cull_records(np.random.default_rng(seed), kind,
                                       600))
    check_cull_against_exact_test(rec, (1, 2), nonvacuous=kind == "random")


def test_warp_cull_bound_is_the_largest_power(rng):
    """The closed form behind the cull (0 if the centre is inside, else
    the largest power on an edge that faces it) against a dense sampling
    of the rectangle."""
    rec = cull_records(rng, "random", 200)
    rec[:30, 0] = rng.uniform(8.0, 15.0, 30)         # centres in the block
    rec[:30, 1] = rng.uniform(4.0, 7.0, 30)
    rec = torch.as_tensor(rec)
    x0, x1, y0, y1 = (torch.tensor(v) for v in (8.0, 15.0, 4.0, 7.0))
    xs = torch.linspace(8.0, 15.0, 141)
    ys = torch.linspace(4.0, 7.0, 61)
    dense = port_blend.shared_power(rec, xs, ys).reshape(200, -1).amax(1)
    bound, mag = port_blend.rect_power_bound(rec, x0, x1, y0, y1)
    x, y = rec[:, 0], rec[:, 1]
    inside = (x >= x0) & (x <= x1) & (y >= y0) & (y <= y1)
    assert bool((bound[inside] == 0).all())
    assert bool((mag >= dense.abs()).all())
    assert int(inside.sum()) > 0 and int((~inside).sum()) > 100
    # The bound is never below a sampled power, and tight to the sampling.
    assert float((dense - bound).max()) <= 1e-4 * float(bound.abs().max())
    np.testing.assert_allclose(bound.numpy(), dense.numpy(), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.parametrize("kind", ["random", "correlated"])
def test_shared_power_equals_the_plain_power_bit_for_bit(rng, kind):
    """The power from the terms shared down a column and along a row of a
    thread's pixels (`shared_power`; `col_terms`, `row_terms`, `power_of`
    in csrc/alpha_terms.cuh) against the plain versions' expression."""
    rec = torch.as_tensor(cull_records(rng, kind, 300))
    xs = torch.arange(16, 32, dtype=torch.float32)
    ys = torch.arange(32, 48, dtype=torch.float32)
    got = port_blend.shared_power(rec, xs, ys)                   # (N, H, W)
    r = rec[:, :, None]
    px = xs.repeat(16)[None, :]          # tile order: p = y·16 + x
    py = ys.repeat_interleave(16)[None, :]
    dx, dy = r[:, 0] - px, r[:, 1] - py
    want = (-0.5 * (r[:, 2] * dx * dx + r[:, 4] * dy * dy)
            - r[:, 3] * dx * dy)
    assert torch.equal(got.reshape(300, 256), want)
