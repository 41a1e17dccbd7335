"""The port's differentiable blend (`Blend`: K1 forward, K2 backward, both
as their plain PyTorch versions on the CPU) against the JAX package's
VJPs: the XLA `blend` and `blend_pallas` with its Pallas kernels in
interpret mode (fast_grad_reduce off). Both sides blend
the same preprocessed gaussians (the JAX preprocess outputs) and take the
same random image cotangents. Tolerance: the scale-normalised atol 2e-4
of tests/test_pallas_blend.py:67-71 (|a - b| / max(|b|.max(), 1e-3))."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fourdgs_tpu.ops import binning as jax_binning
from fourdgs_tpu.ops import blend as jax_blend
from fourdgs_tpu.ops import pallas_blend
from fourdgs_tpu.ops import preprocess as jax_pre
from fourdgs_tpu_torch.ops import binning as port_binning
from fourdgs_tpu_torch.ops import blend as port_blend
from fourdgs_tpu_torch.utils import tracing
from fourdgs_tpu_torch.ops import gaussmath as port_gm
from fourdgs_tpu_torch.ops import preprocess as port_pre

from torch_helpers import (assert_scaled_close, corner_scene,
                           saturated_scene, to_torch)
from utils import look_at_camera, random_scene

BG = np.array([0.1, 0.2, 0.3], np.float32)
CAPACITY = 16384

# name → (scene maker, height, width): 64x64 has whole tiles only, 48x40
# a partial column of tiles.
SCENES = {
    "random": (lambda rng: random_scene(rng, p=56), 64, 64),
    "partial_tiles": (lambda rng: random_scene(rng, p=40), 48, 40),
    "saturated": (saturated_scene, 48, 40),
    "empty_tiles": (corner_scene, 48, 40),
}


def _setup(rng, scene_name):
    make, h, w = SCENES[scene_name]
    scene = make(rng)
    opts = dict(height=h, width=w, gaussian_dim=4, rot_4d=True,
                time_duration=1.0)
    cam = look_at_camera(width=w, height=h)
    jopts = jax_pre.RenderOptions(**opts)
    proc = jax_pre.preprocess(**{k: jnp.asarray(v) for k, v in scene.items()},
                              camera=cam.arrays(), opts=jopts)
    cots = (rng.normal(size=(h, w, 3)).astype(np.float32),
            rng.normal(size=(h, w)).astype(np.float32),
            rng.normal(size=(h, w, 2)).astype(np.float32),
            rng.normal(size=(h, w)).astype(np.float32))
    return port_pre.RenderOptions(**opts), jopts, proc, cots


def _jax_grads(jopts, proc, cots, backend):
    """(outputs, (d_xy, d_conic, d_opa, d_feat, d_bg)) of the JAX blend."""
    feat = jnp.concatenate([proc.rgb, proc.depth[:, None], proc.flow], -1)
    if backend == "xla":
        bins = jax_binning.bin_gaussians(proc, jopts, CAPACITY,
                                         max_per_tile=1024)
        cfg = jax_blend.make_blend_config(jopts, chunk=32, max_per_tile=1024)

        def f(*args):
            return jax_blend.blend(cfg, *args, bins)
    else:
        abins = jax_binning.bin_gaussians_aligned(proc, jopts, CAPACITY,
                                                  pallas_blend.CHUNK)
        cfg = pallas_blend.PallasBlendConfig(
            height=jopts.height, width=jopts.width, tiles_x=jopts.tiles_x,
            tiles_y=jopts.tiles_y, interpret=True, inst_capacity=CAPACITY)

        def f(*args):
            return pallas_blend.blend_pallas(cfg, *args, abins)
    out, vjp = jax.vjp(f, proc.xy, proc.conic, proc.opacity, feat,
                       jnp.asarray(BG))
    return out, vjp(tuple(jnp.asarray(c) for c in cots))


def _port_grads(opts, proc, cots):
    """(outputs, d_rec (P, 12), d_bg) of the port's Blend."""
    tproc = port_pre.ProcessedGaussians(*to_torch(proc))
    bins = port_binning.bin_gaussians(tproc, opts)
    rec = port_blend.build_records(tproc).requires_grad_()
    bg = torch.as_tensor(BG).requires_grad_()
    out = port_blend.Blend.apply(rec, bg, bins, opts)
    torch.autograd.backward(out, [torch.as_tensor(c) for c in cots])
    return out, rec.grad.numpy(), bg.grad.numpy(), bins


def _compare(port, jax_out):
    (out, d_rec, d_bg, _), (jout, (d_xy, d_conic, d_opa, d_feat, jd_bg)) = \
        port, jax_out
    for name, a, b in (("color", out[0], jout[0]), ("alpha", out[3], jout[3])):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=1e-4, atol=1e-5, err_msg=name)
    assert_scaled_close(d_rec[:, 0:2], d_xy, "xy")
    assert_scaled_close(d_rec[:, 2:5], d_conic, "conic")
    assert_scaled_close(d_rec[:, 5], d_opa, "opacity")
    assert_scaled_close(d_rec[:, 6:10], np.asarray(d_feat)[:, :4], "feat")
    assert_scaled_close(d_bg, jd_bg, "bg")
    assert np.all(d_rec[:, 10:] == 0.0)        # flow gets no gradient


@pytest.mark.parametrize("scene_name", sorted(SCENES))
def test_blend_grads_match_xla(rng, scene_name):
    opts, jopts, proc, cots = _setup(rng, scene_name)
    port = _port_grads(opts, proc, cots)
    _compare(port, _jax_grads(jopts, proc, cots, "xla"))
    bins = port[3]
    assert np.abs(port[1]).max() > 0.0
    if scene_name == "saturated":
        assert int(bins.max_per_tile) > 256
    if scene_name == "empty_tiles":
        assert int((bins.tile_count == 0).sum()) > 0


@pytest.mark.parametrize("scene_name", sorted(SCENES))
def test_blend_grads_match_pallas_interpret(rng, scene_name):
    opts, jopts, proc, cots = _setup(rng, scene_name)
    _compare(_port_grads(opts, proc, cots),
             _jax_grads(jopts, proc, cots, "pallas_interpret"))


def test_backward_pair_counts(rng):
    """The plain backward's count of the pairs these inputs need, by
    class, against a pixel-by-pixel walk in numpy over K1's n_contrib."""
    opts, _, proc, _ = _setup(rng, "partial_tiles")
    tproc = port_pre.ProcessedGaussians(*to_torch(proc))
    bins = port_binning.bin_gaussians(tproc, opts)
    rec = port_blend.build_records(tproc)
    _, t_final, ncon = port_blend.blend_forward_plain(
        rec, bins.gauss_id, bins.tile_start, bins.tile_count, opts.tiles_x)
    dcot = torch.zeros((opts.num_tiles, port_blend.COT, 256))
    counts = {}
    port_blend.blend_backward_plain(rec, bins.gauss_id, bins.tile_start,
                                    t_final, ncon, dcot, opts.tiles_x,
                                    pair_counts=counts)

    r, ids, nc = rec.numpy(), bins.gauss_id.numpy(), ncon.numpy()
    # The warp of pixel p = y·16 + x, as the kernels map threads: warp w
    # covers the 8x4 block at column (w % 2)·8 and row (w // 2)·4.
    warp_of = np.array([(p // 16 // 4) * 2 + (p % 16) // 8
                        for p in range(256)])
    rects = port_blend.warp_rects(opts.num_tiles, opts.tiles_x, "cpu")
    want = dict(evaluated=0, power_ok=0, used=0, warp_live=0, warp_kept=0,
                kept_evaluated=0, warp_active=0, tile_active=0)
    for tile, s in enumerate(bins.tile_start.numpy()):
        ty, tx = divmod(tile, opts.tiles_x)
        top = nc[tile].max()
        used = np.zeros((top, 256), bool)
        for p in range(256):
            px, py = tx * 16 + p % 16, ty * 16 + p // 16
            for j in range(nc[tile, p]):
                g = ids[s + j]
                want["evaluated"] += 1
                dx, dy = r[g, 0] - px, r[g, 1] - py
                power = (-0.5 * (r[g, 2] * dx * dx + r[g, 4] * dy * dy)
                         - r[g, 3] * dx * dy)
                if power > 0.0:
                    continue
                want["power_ok"] += 1
                if min(r[g, 5] * np.exp(power), np.float32(0.99)) >= 1 / 255:
                    used[j, p] = True
        want["used"] += int(used.sum())
        want["tile_active"] += int(used.any(-1).sum())
        keep = port_blend.warp_cull_keep(
            rec[bins.gauss_id[s:s + top].long()][:, None, :],
            *(b[tile][None, :] for b in rects)).numpy()          # (top, 8)
        for w in range(8):
            mine = warp_of == w
            # The warp walks the ranks below its own largest n_contrib.
            live = np.arange(top) < nc[tile, mine].max()
            below = np.arange(top)[:, None] < nc[tile, mine][None, :]
            want["warp_live"] += int(live.sum())
            want["warp_kept"] += int((live & keep[:, w]).sum())
            want["kept_evaluated"] += int(below[keep[:, w]].sum())
            want["warp_active"] += int(used[:, mine].any(-1).sum())
    assert counts == want
    assert want["used"] > 0
    assert (want["tile_active"] <= want["warp_active"] <= want["warp_kept"]
            < want["warp_live"])


def test_backward_wrapper_never_runs_plain_off_cpu():
    """Only CPU tensors reach the plain version: any other device goes to
    the kernel path, which raises here (no CUDA), and counts nothing."""
    before = tracing.totals().get("launches.k2", 0)
    meta = lambda *s, dtype=torch.float32: torch.empty(  # noqa: E731
        s, dtype=dtype, device="meta")
    with pytest.raises((ValueError, RuntimeError)):
        port_blend.blend_backward(
            meta(4, 12), meta(3, dtype=torch.int32), meta(6, dtype=torch.int32),
            meta(6, 256), meta(6, 256, dtype=torch.int32), meta(6, 7, 256), 3)
    assert tracing.totals().get("launches.k2", 0) == before


def test_backward_observer_sees_each_call(rng):
    """`blend_backward.observer` receives the arguments and the result of
    every call, through `Blend`'s backward."""
    opts, _, proc, _ = _setup(rng, "random")
    tproc = port_pre.ProcessedGaussians(*to_torch(proc))
    bins = port_binning.bin_gaussians(tproc, opts)
    rec = port_blend.build_records(tproc).requires_grad_()
    seen = []
    port_blend.blend_backward.observer = lambda a, out: seen.append((a, out))
    try:
        color, *_ = port_blend.Blend.apply(rec, torch.zeros(3), bins, opts)
        color.sum().backward()
    finally:
        port_blend.blend_backward.observer = None
    assert len(seen) == 1
    args, out = seen[0]
    assert args[1] is bins.gauss_id and args[-1] == opts.tiles_x
    np.testing.assert_array_equal(out.numpy(), rec.grad.numpy())


def _rank_by_rank_backward(rec, gauss_id, tile_start, t_final, n_contrib,
                           dcot, tiles_x):
    """`blend_backward_plain` as it was written first: every term of a
    chunk taken rank by rank inside the recursion (kept here to show that
    the chunk-wide terms change no bit)."""
    num_tiles = tile_start.shape[0]
    px, py = port_blend._tile_pixel_coords(num_tiles, tiles_x, rec.device)
    dc = [dcot[:, f] for f in range(port_blend.NUM_FEAT)]
    tf = dcot[:, port_blend.NUM_FEAT]
    t = t_final.clone()
    sigma = torch.zeros_like(t)
    d_rec = torch.zeros_like(rec)
    ncon = n_contrib.to(torch.int64)
    max_rank = ncon.max(dim=1).values
    chunk = port_blend.PLAIN_CHUNK
    ranks = torch.arange(chunk)
    start = tile_start.to(torch.int64)[:, None]
    for c0 in reversed(range(0, int(max_rank.max()), chunk)):
        rank = c0 + ranks
        in_range = rank[None, :] < max_rank[:, None]
        gid = gauss_id[torch.where(in_range, start + rank[None, :], 0)]
        gid = gid.to(torch.int64)
        r = rec[gid]
        dx = r[:, :, 0:1] - px[:, None, :]
        dy = r[:, :, 1:2] - py[:, None, :]
        power = (-0.5 * (r[:, :, 2:3] * dx * dx + r[:, :, 4:5] * dy * dy)
                 - r[:, :, 3:4] * dx * dy)
        g = torch.exp(power)
        raw = r[:, :, 5:6] * g
        alpha = torch.clamp(raw, max=port_gm.ALPHA_CLAMP)
        evaluated = rank[None, :, None] < ncon[:, None, :]
        used = evaluated & (power <= 0.0) & (alpha >= port_gm.ALPHA_MIN)
        grads = torch.zeros((num_tiles, chunk, port_blend.REC))
        for k in reversed(range(chunk)):
            u = used[:, k]
            a = alpha[:, k]
            f = r[:, k, 6:12, None]
            one_m = 1.0 - a
            t_before = torch.where(u, t / one_m, t)
            w = torch.where(u, a * t_before, 0.0)
            gdot = (dc[0] * f[:, 0] + dc[1] * f[:, 1] + dc[2] * f[:, 2]
                    + dc[3] * f[:, 3] + dc[4] * f[:, 4] + dc[5] * f[:, 5])
            d_alpha = torch.where(
                u, t_before * gdot - (sigma + tf) / one_m, 0.0)
            sigma = torch.where(u, sigma + w * gdot, sigma)
            t = t_before
            d_power = torch.where(u, raw[:, k] * d_alpha, 0.0)
            d_opa = torch.where(u, g[:, k] * d_alpha, 0.0)
            ddx, ddy = dx[:, k], dy[:, k]
            ca, cb, cc = r[:, k, 2:3], r[:, k, 3:4], r[:, k, 4:5]
            sx = ca * ddx + cb * ddy
            sy = cb * ddx + cc * ddy
            terms = torch.stack([
                -sx * d_power, -sy * d_power,
                -0.5 * ddx * ddx * d_power, -ddx * ddy * d_power,
                -0.5 * ddy * ddy * d_power, d_opa,
                w * dc[0], w * dc[1], w * dc[2], w * dc[3]], dim=1)
            grads[:, k, :port_blend.NUM_GRAD] = terms.sum(dim=-1)
        d_rec.index_add_(0, gid[in_range], grads[in_range])
    return d_rec


@pytest.mark.parametrize("scene_name", sorted(SCENES))
def test_plain_backward_equals_rank_by_rank_version(rng, scene_name):
    """The plain version, which takes every term but the two recursions
    for a whole chunk at once, equals the rank-by-rank version bit for bit
    on the inputs a real backward gives it."""
    opts, _, proc, cots = _setup(rng, scene_name)
    seen = []
    port_blend.blend_backward.observer = lambda a, out: seen.append(a)
    try:
        _port_grads(opts, proc, cots)
    finally:
        port_blend.blend_backward.observer = None
    args = tuple(a.detach() if torch.is_tensor(a) else a for a in seen[0])
    got = port_blend.blend_backward_plain(*args)
    assert bool((got != 0).any())
    np.testing.assert_array_equal(got.numpy(),
                                  _rank_by_rank_backward(*args).numpy())


def test_image_to_ctiles_inverts_ctiles_to_image(rng):
    opts = port_pre.RenderOptions(height=48, width=40)
    img = torch.as_tensor(rng.normal(size=(48, 40, 5)).astype(np.float32))
    tiles = port_blend.image_to_ctiles(img, opts)
    assert tuple(tiles.shape) == (opts.num_tiles, 5, 256)
    np.testing.assert_array_equal(
        port_blend.ctiles_to_image(tiles, opts).numpy(), img.numpy())
    # The partial column of tiles is zero past the image edge.
    assert float(tiles.reshape(3, 3, 5, 16, 16)[:, 2, :, :, 8:].abs().max()) == 0
