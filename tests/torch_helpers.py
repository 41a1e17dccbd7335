"""Helpers shared by the tests of the PyTorch port (tests/test_torch_*.py):
the same numpy inputs handed to the JAX package and to the port, on the
CPU."""

import os

import numpy as np
import torch

from fourdgs_tpu_torch.data import cameras as port_cameras
from fourdgs_tpu_torch.ops import blend as port_blend

CPU = "cpu"
# The warp of K1 and K3 that owns pixel p = y·16 + x of a tile: a thread
# owns two pixels 4 rows apart, so warp w covers the 8x8 block at column
# (w % 2)·8 and row (w // 2)·8.
WARP_OF = np.array([(p // 16 // 8) * 2 + (p % 16) // 8 for p in range(256)])


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


def cull_records(rng, kind, n):
    """(n, 6) f32 records [x, y, a, b, c, opacity] around a 48x40 image,
    for the tests of the warp cull: "random", "near_threshold" (opacities
    around the 1/255 floor), "correlated" (thin, strongly tilted) or
    "degenerate" (conics the preprocess never makes)."""
    xy = rng.uniform(-24.0, 72.0, (n, 2))
    sx = np.exp(rng.normal(np.log(3.0), 0.8, n))
    sy = np.exp(rng.normal(np.log(3.0), 0.8, n))
    rho = rng.uniform(-0.6, 0.6, n)
    opa = rng.uniform(0.01, 0.99, n)
    if kind == "near_threshold":
        # Opacities around the 1/255 floor: the threshold power is near 0.
        opa = (1.0 / 255.0) * np.exp(rng.normal(0.0, 0.05, n))
        opa[::3] = rng.uniform(1.0 / 255.0, 0.02, n)[::3]
    if kind == "correlated":
        # Thin, strongly tilted gaussians: the power's terms nearly cancel.
        rho = (np.sign(rng.normal(size=n))
               * (1.0 - 10.0 ** rng.uniform(-5, -1, n)))
        sx, sy = sx * 6.0, sy * 6.0
    det = (1.0 - rho ** 2) * sx ** 2 * sy ** 2
    conic = np.stack([sy ** 2 / det, -rho * sx * sy / det, sx ** 2 / det], 1)
    if kind == "degenerate":
        # Conics the preprocess never makes: the cull must keep or be right.
        conic[::4, 0] *= -1.0
        conic[1::4, 2] = 0.0
        conic[2::4, 1] *= 3.0                       # indefinite
        opa[3::4] = rng.choice([0.0, 1.0, 1.5], n)[3::4]
    return np.concatenate([xy, conic, opa[:, None]], 1).astype(np.float32)


def check_cull_against_exact_test(rec, rows_list, nonvacuous):
    """The conservative warp cull and the expf pre-test against the exact
    test of the plain versions, for the records `rec` (N, >= 6) on a 48x40
    image (partial tiles: a 3x3 grid of tiles, the last column and row
    past the edge): wherever the exact test (power <= 0 and alpha >=
    1/255, f32) accepts a pixel, the pair's power is not under
    `skip_threshold`, and on every warp rectangle of `rows` pixels per
    thread (1: K2's 8x4, 2: K1's and K3's 8x8) for `rows` in `rows_list`
    the warp keeps the instance. With `nonvacuous`, also that the cull
    drops most (warp, instance) pairs and that a good share of the kept
    ones has a pixel that passes."""
    from fourdgs_tpu_torch.ops.preprocess import RenderOptions

    opts = RenderOptions(height=48, width=40)
    px, py = port_blend._tile_pixel_coords(opts.num_tiles, opts.tiles_x,
                                           CPU)                   # (T, 256)
    r = rec[:, None, None, :]
    dx, dy = r[..., 0] - px[None], r[..., 1] - py[None]           # (N, T, 256)
    power = (-0.5 * (r[..., 2] * dx * dx + r[..., 4] * dy * dy)
             - r[..., 3] * dx * dy)
    alpha = torch.clamp(r[..., 5] * torch.exp(power), max=0.99)
    accept = (power <= 0.0) & (alpha >= 1.0 / 255.0)
    assert int(accept.sum()) > 0
    thr = port_blend.skip_threshold(rec[:, 5])[:, None, None]
    assert not bool((accept & (power < thr)).any())
    for rows in rows_list:
        rects = port_blend.warp_rects(opts.num_tiles, opts.tiles_x, CPU,
                                      rows)
        keep = port_blend.warp_cull_keep(
            rec[:, None, None, :], *(b[None] for b in rects))  # (N, T, warps)
        accept_w = port_blend.by_warp(accept, rows).any(dim=-1)
        assert not bool((accept_w & ~keep).any())
        if nonvacuous:
            assert float(keep.float().mean()) < 0.5
            assert int(accept_w.sum()) > 0.5 * int(keep.sum())


def walk_pair_counts(rec, bins, opts):
    """The pair counts of `blend_forward_plain` on the (P, >= 6) f32
    records `rec`, from a pixel-by-pixel walk in numpy: the (pixel,
    instance) pairs by how far each goes, then by the 8x8 warp rectangle
    of K1 and K3 (`WARP_OF`) with the port's `warp_cull_keep`."""
    r = rec.numpy()
    ids = bins.gauss_id.numpy()
    want = dict(evaluated=0, power_ok=0, alpha_ok=0, used=0, warp_live=0,
                warp_kept=0, kept_evaluated=0, warp_active=0)
    rects = port_blend.warp_rects(opts.num_tiles, opts.tiles_x, CPU,
                                  port_blend.FORWARD_ROWS)
    for tile, (s, c) in enumerate(zip(bins.tile_start.numpy(),
                                      bins.tile_count.numpy())):
        ty, tx = divmod(tile, opts.tiles_x)
        seen = np.zeros((c, 256), bool)
        used = np.zeros((c, 256), bool)
        for py in range(ty * 16, ty * 16 + 16):
            for px in range(tx * 16, tx * 16 + 16):
                p = (py % 16) * 16 + px % 16
                t = np.float32(1.0)
                for j, g in enumerate(ids[s:s + c]):
                    want["evaluated"] += 1
                    seen[j, p] = True
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
                    used[j, p] = True
                    t = t * (1.0 - alpha)
        keep = port_blend.warp_cull_keep(
            rec[bins.gauss_id[s:s + c].long()][:, None, :],
            *(b[tile][None, :] for b in rects)).numpy()          # (c, 4)
        for w in range(4):
            live = seen[:, WARP_OF == w]
            want["warp_live"] += int(live.any(-1).sum())
            want["warp_kept"] += int((live.any(-1) & keep[:, w]).sum())
            want["kept_evaluated"] += int(live[keep[:, w]].sum())
            want["warp_active"] += int(used[:, WARP_OF == w].any(-1).sum())
    return want


SYNTH_GATE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "fixtures", "synth_gate")
# Config overrides (both packages' `load_config`) for the fixture at 48 px.
SYNTH_GATE_OVERRIDES = dict(
    gaussian_dim=4, rot_4d=True, time_duration=[0.0, 1.0], num_pts=300,
    model=dict(source_path=SYNTH_GATE, resolution=2, eval=True),
    pipeline=dict(eval_shfs_4d=True, env_map_res=8))


def jax_synth_gate_state(seed=0, p=300):
    """(JAX GaussianState, JAX EnvMapState) on the fixture's point cloud,
    with visible sizes and some transparency, and a random 8x8 environment
    map: what a test saves with the JAX package's `save_checkpoint`."""
    import jax.numpy as jnp

    from fourdgs_tpu.data import scene as jax_scene
    from fourdgs_tpu.models import envmap as jax_env
    from fourdgs_tpu.models import gaussians as jax_gaussians

    rng = np.random.default_rng(seed)
    pcd = jax_scene.load_scene(SYNTH_GATE, num_pts=p, resolution=2,
                               seed=seed).point_cloud
    n = len(pcd.points)
    state = jax_gaussians.init_from_pcd(
        pcd.points, pcd.colors, sh_channels=48, time_duration=(0.0, 1.0),
        times=pcd.times, capacity=n + 20, seed=seed)
    params = state.params
    params = params._replace(
        scaling=params.scaling.at[:n].set(
            jnp.asarray(rng.normal(-2.6, 0.3, (n, 3)), jnp.float32)),
        rotation_r=params.rotation_r.at[:n].set(
            jnp.asarray(rng.normal(size=(n, 4)), jnp.float32)),
        f_rest=params.f_rest.at[:n].set(
            jnp.asarray(rng.normal(0, 0.1, (n, 47, 3)), jnp.float32)),
        opacity=params.opacity.at[:n].set(
            jnp.asarray(rng.normal(0.5, 1.0, (n, 1)), jnp.float32)))
    env = jax_env.init_envmap(8)._replace(
        texture=jnp.asarray(rng.random((8, 8, 3)), jnp.float32),
        count=jnp.asarray(9, jnp.int32))
    return state._replace(params=params), env
