"""Plain PyTorch reference of one 4D Gaussian Splatting training step.

The benchmark's yardstick for `correct`: the render of a camera batch
(temporal conditioning, EWA projection, spherindrical SH colour, tile
binning, front-to-back alpha blending with the reference's thresholds),
the sky of an environment map, the photometric loss (L1 and D-SSIM), the
rigid loss over the exact k nearest neighbours, the gradient and the Adam
update, as fudan-zvg/4d-gaussian-splatting defines them (`train.py`,
`gaussian_renderer/__init__.py`, `cuda_rasterizer/forward.cu` and
`backward.cu`, `utils/loss_utils.py`).

It imports nothing of the program under test: the per-gaussian math and
the plain tile walk are a frozen copy of the port's plain versions, SSIM is
the reference's windowed convolution, and the neighbours are exact. Every
floating tensor takes the dtype of the inputs it is given, so that the
same code run in bfloat16 is the benchmark's lower-precision control.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

TILE = 16
PIX = TILE * TILE
NUM_FEAT = 6            # rgb(3) + depth(1) + flow(2)
REC = 12                # xy(2) + conic(3) + opacity(1) + feat(6)
CHUNK = 32              # ranks per gather step of the tile walk

HOMOGENEOUS_EPS = 1e-7
NEAR_PLANE = 0.2
LOWPASS = 0.3
FOV_CLAMP = 1.3
MARGINAL_CULL = 0.05
ALPHA_CLAMP = 0.99
ALPHA_MIN = 1.0 / 255.0
T_EPS = 1e-4
ZNEAR, ZFAR = 0.01, 100.0
SKY_RADIUS = 60.0
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-15

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)

LEAVES = ("xyz", "t", "scaling", "scaling_t", "rotation", "rotation_r",
          "f_dc", "f_rest", "opacity")


# --------------------------------------------------------------------------
# Cameras (reference utils/graphics_utils.py, scene/cameras.py)
# --------------------------------------------------------------------------

class Pose(NamedTuple):
    """A camera as a dataset gives it: COLMAP rotation (cam → world) and
    translation (world → cam), image size, time, and either fields of view
    (fl_x < 0) or pixel intrinsics."""
    rot: np.ndarray
    trans: np.ndarray
    width: int
    height: int
    timestamp: float
    fovx: float
    fovy: float
    fl_x: float = -1.0
    fl_y: float = -1.0
    cx: float = -1.0
    cy: float = -1.0


def world_to_view(rot, trans) -> np.ndarray:
    rt = np.zeros((4, 4))
    rt[:3, :3] = np.asarray(rot).T
    rt[:3, 3] = trans
    rt[3, 3] = 1.0
    return np.linalg.inv(np.linalg.inv(rt)).astype(np.float32)


def projection(pose: Pose) -> np.ndarray:
    p = np.zeros((4, 4), np.float32)
    if pose.fl_x > 0:
        top = pose.cy / pose.fl_y * ZNEAR
        bottom = -(pose.height - pose.cy) / pose.fl_y * ZNEAR
        left = -(pose.width - pose.cx) / pose.fl_x * ZNEAR
        right = pose.cx / pose.fl_x * ZNEAR
        p[0, 0] = 2.0 * ZNEAR / (right - left)
        p[1, 1] = 2.0 * ZNEAR / (top - bottom)
        p[0, 2] = (right + left) / (right - left)
        p[1, 2] = (top + bottom) / (top - bottom)
    else:
        p[0, 0] = 1.0 / math.tan(pose.fovx / 2)
        p[1, 1] = 1.0 / math.tan(pose.fovy / 2)
    p[3, 2] = 1.0
    p[2, 2] = ZFAR / (ZFAR - ZNEAR)
    p[2, 3] = -(ZFAR * ZNEAR) / (ZFAR - ZNEAR)
    return p


def camera_tensors(pose: Pose, device, dtype) -> dict:
    """The renderer's per-camera tensors, and the pixel intrinsics
    [fl_x, fl_y, cx, cy] of the sky's rays."""
    view = world_to_view(pose.rot, pose.trans)
    full = (projection(pose) @ view).astype(np.float32)
    tanx, tany = math.tan(pose.fovx / 2), math.tan(pose.fovy / 2)
    if pose.fl_x > 0:
        focal = [pose.fl_x, pose.fl_y]
        intr = [pose.fl_x, pose.fl_y, pose.cx, pose.cy]
    else:
        focal = [pose.width / (2 * tanx), pose.height / (2 * tany)]
        intr = focal + [pose.width / 2, pose.height / 2]
    as_t = lambda a: torch.as_tensor(  # noqa: E731
        np.asarray(a, np.float32), device=device).to(dtype)
    return dict(viewmatrix=as_t(view), projmatrix=as_t(full),
                campos=as_t(np.linalg.inv(view)[:3, 3]), focal=as_t(focal),
                tanfov=as_t([tanx, tany]), timestamp=as_t(pose.timestamp),
                intrinsics=as_t(intr))


def scene_radius(poses) -> float:
    """nerf++ normalisation: 1.1 × the largest distance of a camera centre
    from their mean (`dataset_readers.py:56-77`)."""
    centres = np.stack([np.linalg.inv(world_to_view(p.rot, p.trans))[:3, 3]
                        for p in poses])
    return float(np.linalg.norm(centres - centres.mean(0), axis=1).max()
                 * 1.1)


# --------------------------------------------------------------------------
# Gaussians: activation, 4D conditioning, projection, colour
# --------------------------------------------------------------------------

def activate(params: dict) -> dict:
    def unit(q):
        return q / torch.clamp(torch.sqrt(torch.sum(q * q, -1, keepdim=True)),
                               min=1e-12)
    return dict(means3d=params["xyz"], t=params["t"][:, 0],
                scales=torch.exp(params["scaling"]),
                scales_t=torch.exp(params["scaling_t"][:, 0]),
                rotations=unit(params["rotation"]),
                rotations_r=unit(params["rotation_r"]),
                opacity=torch.sigmoid(params["opacity"][:, 0]),
                sh=torch.cat([params["f_dc"], params["f_rest"]], dim=1))


def rotor4d(q_l, q_r):
    """Entries of the SO(4) matrix of the isoclinic pair (q_l, q_r), both
    axes reversed (`general_utils.py:113-133`)."""
    a, b, c, d = q_l.unbind(-1)
    p, q, r, s = q_r.unbind(-1)
    m = [[a * p + b * q + c * r + d * s, a * q - b * p - c * s + d * r,
          a * r + b * s - c * p - d * q, a * s - b * r + c * q - d * p],
         [b * p - a * q + d * r - c * s, b * q + a * p - d * s - c * r,
          b * r - a * s - d * p + c * q, b * s + a * r + d * q + c * p],
         [c * p - d * q - a * r + b * s, c * q + d * p + a * s + b * r,
          c * r - d * s + a * p - b * q, c * s + d * r - a * q - b * p],
         [d * p + c * q - b * r - a * s, d * q - c * p + b * s - a * r,
          d * r + c * s + b * p + a * q, d * s - c * r - b * q + a * p]]
    return [[m[3 - i][3 - j] for j in range(4)] for i in range(4)]


def cov4d(scales_xyzt, q_l, q_r):
    """(cov11 packed, cov12, cov_t) of Σ = R S² Rᵀ."""
    rr = rotor4d(q_l, q_r)
    s2 = [scales_xyzt[..., k] ** 2 for k in range(4)]

    def entry(i, j):
        return sum(rr[i][k] * s2[k] * rr[j][k] for k in range(4))
    return ([entry(0, 0), entry(0, 1), entry(0, 2), entry(1, 1),
             entry(1, 2), entry(2, 2)],
            [entry(0, 3), entry(1, 3), entry(2, 3)], entry(3, 3))


def condition(scales_xyzt, q_l, q_r, t, timestamp):
    """Slice at `timestamp`: conditional covariance (P, 6), mean shift
    (P, 3) and temporal marginal (P,) (`forward.cu:332-351`)."""
    cov11, cov12, cov_t = cov4d(scales_xyzt, q_l, q_r)
    dt = timestamp - t
    safe = torch.clamp(cov_t, min=1e-12)
    inv = 1.0 / safe
    c0, c1, c2 = cov12
    cond = torch.stack([
        cov11[0] - c0 * c0 * inv, cov11[1] - c0 * c1 * inv,
        cov11[2] - c0 * c2 * inv, cov11[3] - c1 * c1 * inv,
        cov11[4] - c1 * c2 * inv, cov11[5] - c2 * c2 * inv], dim=-1)
    scale_dt = inv * dt
    delta = torch.stack([c0 * scale_dt, c1 * scale_dt, c2 * scale_dt], -1)
    return cond, delta, torch.exp(-0.5 * dt * dt / safe)


def ewa(mean3d, cov3, view, focal, tanfov):
    """Packed screen covariance [xx, xy, yy] with the 0.3 px low-pass."""
    w = view[:3, :3]
    x, y, z = mean3d.unbind(-1)
    tv = [w[i, 0] * x + w[i, 1] * y + w[i, 2] * z + view[i, 3]
          for i in range(3)]
    tz = tv[2]
    lim0, lim1 = FOV_CLAMP * tanfov[0], FOV_CLAMP * tanfov[1]
    txz = torch.clamp(tv[0] / tz, -lim0, lim0) * tz
    tyz = torch.clamp(tv[1] / tz, -lim1, lim1) * tz
    inv_z = 1.0 / tz
    inv_z2 = inv_z * inv_z
    j00, j02 = focal[0] * inv_z, -(focal[0] * txz) * inv_z2
    j11, j12 = focal[1] * inv_z, -(focal[1] * tyz) * inv_z2
    m0 = [j00 * w[0, k] + j02 * w[2, k] for k in range(3)]
    m1 = [j11 * w[1, k] + j12 * w[2, k] for k in range(3)]
    xx, xy, xz, yy, yz, zz = cov3.unbind(-1)
    sig = [[xx, xy, xz], [xy, yy, yz], [xz, yz, zz]]
    sm0 = [sum(sig[i][k] * m0[k] for k in range(3)) for i in range(3)]
    sm1 = [sum(sig[i][k] * m1[k] for k in range(3)) for i in range(3)]
    return torch.stack([sum(m0[k] * sm0[k] for k in range(3)) + LOWPASS,
                        sum(m0[k] * sm1[k] for k in range(3)),
                        sum(m1[k] * sm1[k] for k in range(3)) + LOWPASS], -1)


def sh4d(sh, dirs, dir_t, duration):
    """Spherindrical colour: 16 spatial SH × cos(2πk dt/T), k = 0, 1, 2
    (`sh_utils.py:115-223`), +0.5 and clamped at 0."""
    x, y, z = dirs.unbind(-1)
    xx, yy, zz, xy, yz, xz = x * x, y * y, z * z, x * y, y * z, x * z
    spatial = [SH_C0 * torch.ones_like(x), -SH_C1 * y, SH_C1 * z, -SH_C1 * x,
               SH_C2[0] * xy, SH_C2[1] * yz, SH_C2[2] * (2.0 * zz - xx - yy),
               SH_C2[3] * xz, SH_C2[4] * (xx - yy),
               SH_C3[0] * y * (3 * xx - yy), SH_C3[1] * xy * z,
               SH_C3[2] * y * (4 * zz - xx - yy),
               SH_C3[3] * z * (2 * zz - 3 * xx - 3 * yy),
               SH_C3[4] * x * (4 * zz - xx - yy), SH_C3[5] * z * (xx - yy),
               SH_C3[6] * x * (xx - 3 * yy)]
    spatial = torch.stack(spatial, -1)
    t1 = torch.cos(2.0 * math.pi * dir_t / duration)[..., None]
    t2 = torch.cos(4.0 * math.pi * dir_t / duration)[..., None]
    basis = torch.cat([spatial, t1 * spatial, t2 * spatial], -1)
    raw = torch.einsum("pm,pmc->pc", basis[:, :sh.shape[1]], sh)
    return torch.clamp(raw + 0.5, min=0.0)


class Processed(NamedTuple):
    xy: torch.Tensor
    depth: torch.Tensor
    conic: torch.Tensor
    opacity: torch.Tensor
    rgb: torch.Tensor
    rect: torch.Tensor
    tiles_touched: torch.Tensor


def preprocess(act: dict, cam: dict, height: int, width: int,
               duration: float) -> Processed:
    """Per-gaussian screen quantities for one camera (`forward.cu:355-496`,
    the 4D rotor path), culled gaussians at opacity 0 and no tiles."""
    means3d = act["means3d"]
    dev, dt = means3d.device, means3d.dtype
    sxyzt = torch.cat([act["scales"], act["scales_t"][:, None]], -1)
    cov3, delta, marginal = condition(sxyzt, act["rotations"],
                                      act["rotations_r"], act["t"],
                                      cam["timestamp"])
    shifted = means3d + delta
    op = act["opacity"] * marginal
    view = cam["viewmatrix"]
    depth = shifted @ view[2, :3] + view[2, 3]
    wh = torch.tensor([width, height], dtype=dt, device=dev)
    proj = cam["projmatrix"]
    x, y, z = shifted.unbind(-1)
    hom = [proj[i, 0] * x + proj[i, 1] * y + proj[i, 2] * z + proj[i, 3]
           for i in range(4)]
    inv_w = 1.0 / (hom[3] + HOMOGENEOUS_EPS)
    ndc = torch.stack([hom[0] * inv_w, hom[1] * inv_w], -1)
    xy = ((ndc + 1.0) * wh - 1.0) * 0.5
    cov2d = ewa(shifted, cov3, view, cam["focal"], cam["tanfov"])
    cxx, cxy, cyy = cov2d.unbind(-1)
    det = cxx * cyy - cxy * cxy
    det_ok = det != 0.0
    det_inv = torch.where(det_ok, 1.0 / torch.where(det_ok, det, 1.0), 0.0)
    conic = torch.stack([cyy * det_inv, -cxy * det_inv, cxx * det_inv], -1)
    mid = 0.5 * (cxx + cyy)
    radius = torch.ceil(3.0 * torch.sqrt(
        mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))))

    tx, ty = (width + TILE - 1) // TILE, (height + TILE - 1) // TILE
    i32 = lambda v: torch.full((), v, dtype=torch.int32, device=dev)  # noqa
    zero, tx_i, ty_i = i32(0), i32(tx), i32(ty)

    def clip(v, lo, hi):
        return torch.minimum(torch.maximum(v, lo), hi)
    xi, yi = xy[:, 0], xy[:, 1]
    x0r = clip(((xi - radius) / TILE).to(torch.int32), zero, tx_i)
    y0r = clip(((yi - radius) / TILE).to(torch.int32), zero, ty_i)
    x1r = clip(((xi + radius + TILE - 1) / TILE).to(torch.int32), zero, tx_i)
    y1r = clip(((yi + radius + TILE - 1) / TILE).to(torch.int32), zero, ty_i)
    visible = ((marginal > MARGINAL_CULL) & (depth > NEAR_PLANE) & det_ok
               & (radius.to(torch.int32) >= 1)
               & ((x1r - x0r) * (y1r - y0r) > 0))
    # The footprint where alpha can reach 1/255, inside the 3σ rect.
    tau = torch.clamp(2.0 * torch.log(torch.clamp(op, min=1e-12)
                                      * (1.0 / ALPHA_MIN)), min=0.0)
    ex = torch.minimum(torch.sqrt(tau * torch.clamp(cxx, min=0.0)) * 1.0001
                       + 0.01, radius)
    ey = torch.minimum(torch.sqrt(tau * torch.clamp(cyy, min=0.0)) * 1.0001
                       + 0.01, radius)
    x0 = clip(((xi - ex) / TILE).to(torch.int32), x0r, x1r)
    y0 = clip(((yi - ey) / TILE).to(torch.int32), y0r, y1r)
    x1 = clip(((xi + ex + TILE - 1) / TILE).to(torch.int32), x0r, x1r)
    y1 = clip(((yi + ey + TILE - 1) / TILE).to(torch.int32), y0r, y1r)
    ntiles = torch.where(op >= ALPHA_MIN, (x1 - x0) * (y1 - y0), zero)

    dirs = means3d - cam["campos"]
    dirs = dirs / torch.clamp(torch.sqrt(torch.sum(dirs * dirs, -1,
                                                   keepdim=True)), min=1e-12)
    rgb = sh4d(act["sh"], dirs, act["t"] - cam["timestamp"], duration)
    return Processed(xy=xy, depth=depth, conic=conic,
                     opacity=torch.where(visible, op, 0.0), rgb=rgb,
                     rect=torch.stack([x0, y0, x1, y1], -1),
                     tiles_touched=torch.where(visible, ntiles, zero))


class Bins(NamedTuple):
    gauss_id: torch.Tensor      # (R,) int32 sorted by (tile, depth)
    tile_start: torch.Tensor    # (T,) int32
    tile_count: torch.Tensor    # (T,) int32


def bin_tiles(proc: Processed, height: int, width: int) -> Bins:
    """Each gaussian once per tile of its rect, sorted stably by tile, then
    depth (`rasterizer_impl.cu:199-364`)."""
    tx = (width + TILE - 1) // TILE
    num_tiles = tx * ((height + TILE - 1) // TILE)
    counts_g = proc.tiles_touched.to(torch.int64)
    offsets = torch.cumsum(counts_g, 0)
    n = int(offsets[-1])
    gid = torch.repeat_interleave(torch.arange(counts_g.numel(),
                                               device=counts_g.device),
                                  counts_g, output_size=n)
    local = torch.arange(n, device=gid.device) - (offsets - counts_g)[gid]
    rect = proc.rect.to(torch.int64)[gid]
    rw = torch.clamp(rect[:, 2] - rect[:, 0], min=1)
    row = torch.div(local, rw, rounding_mode="floor")
    tile = (rect[:, 1] + row) * tx + rect[:, 0] + local - row * rw
    # Depth order within a tile by the depth's value; the stable sort keeps
    # expansion order among equal depths.
    order = torch.sort(proc.depth.detach().to(torch.float32)[gid],
                       stable=True).indices
    order = order[torch.sort(tile[order], stable=True).indices]
    counts = torch.bincount(tile, minlength=num_tiles)
    return Bins(gid[order].to(torch.int32),
                (torch.cumsum(counts, 0) - counts).to(torch.int32),
                counts.to(torch.int32))


# --------------------------------------------------------------------------
# The tile walk: forward, backward, and what it visits
# --------------------------------------------------------------------------

def tile_pixels(num_tiles: int, tiles_x: int, device, dtype):
    tids = torch.arange(num_tiles, device=device)[:, None]
    pp = torch.arange(PIX, device=device)[None, :]
    return (((tids % tiles_x) * TILE + pp % TILE).to(dtype),
            ((tids // tiles_x) * TILE + pp // TILE).to(dtype))


def blend_forward(rec, gauss_id, tile_start, tile_count, tiles_x: int):
    """Front to back over each tile's depth-sorted instances: alpha =
    min(0.99, o·exp(power)), skipped where power > 0 or alpha < 1/255, the
    pixel done before the instance that would take T under 1e-4.
    Returns (accum (T, 6, 256), t_final (T, 256), n_contrib (T, 256)).
    Each chunk of ranks visits only the tiles that still have instances
    and pixels not done."""
    dev, dt = rec.device, rec.dtype
    num_tiles = tile_start.shape[0]
    px_all, py_all = tile_pixels(num_tiles, tiles_x, dev, dt)
    t_all = torch.ones((num_tiles, PIX), dtype=dt, device=dev)
    acc_all = torch.zeros((num_tiles, rec.shape[1] - 6, PIX), dtype=dt,
                          device=dev)
    done_all = torch.zeros((num_tiles, PIX), dtype=torch.bool, device=dev)
    ncon_all = torch.zeros((num_tiles, PIX), dtype=torch.int32, device=dev)
    ranks = torch.arange(CHUNK, device=dev)
    count_all = tile_count.to(torch.int64)
    for c0 in range(0, int(tile_count.max()), CHUNK):
        sel = torch.nonzero((count_all > c0) & ~done_all.all(dim=1))[:, 0]
        if sel.numel() == 0:
            break
        px, py = px_all[sel], py_all[sel]
        t, acc = t_all[sel], acc_all[sel]
        done, ncon = done_all[sel], ncon_all[sel]
        count = count_all[sel, None]
        in_range = (c0 + ranks)[None, :] < count
        idx = torch.where(in_range, tile_start.to(torch.int64)[sel, None]
                          + c0 + ranks[None, :], 0)
        r = rec[gauss_id[idx].to(torch.int64)]
        dx = r[:, :, 0:1] - px[:, None, :]
        dy = r[:, :, 1:2] - py[:, None, :]
        power = (-0.5 * (r[:, :, 2:3] * dx * dx + r[:, :, 4:5] * dy * dy)
                 - r[:, :, 3:4] * dx * dy)
        alpha = torch.clamp(r[:, :, 5:6] * torch.exp(power), max=ALPHA_CLAMP)
        valid = in_range[:, :, None] & (power <= 0.0) & (alpha >= ALPHA_MIN)
        for k in range(CHUNK):
            a = alpha[:, k]
            live = valid[:, k] & ~done
            test_t = t * (1.0 - a)
            fail = live & (test_t < T_EPS)
            used = live & ~fail
            acc += r[:, k, 6:, None] * torch.where(used, a * t, 0.0)[:, None]
            t = torch.where(used, test_t, t)
            ncon = torch.where(used, c0 + k + 1, ncon).to(torch.int32)
            done = done | fail
        t_all[sel], acc_all[sel] = t, acc
        done_all[sel], ncon_all[sel] = done, ncon
    return acc_all, t_all, ncon_all


def blend_backward(rec, gauss_id, tile_start, t_final, n_contrib, dcot,
                   tiles_x: int):
    """The walk back to front from each pixel's n_contrib, with the
    transmittance recovered by division and the suffix sum of the colour
    terms (`backward.cu:renderCUDA`): d_rec (P, 12), flow columns zero.
    Each chunk of ranks visits only the tiles that reach it."""
    dev, dt = rec.device, rec.dtype
    num_tiles = tile_start.shape[0]
    px_all, py_all = tile_pixels(num_tiles, tiles_x, dev, dt)
    t_all = t_final.clone()
    sigma_all = torch.zeros_like(t_all)
    d_rec = torch.zeros_like(rec)
    ncon_all = n_contrib.to(torch.int64)
    max_rank_all = ncon_all.max(dim=1).values
    ranks = torch.arange(CHUNK, device=dev)
    for c0 in reversed(range(0, int(max_rank_all.max()), CHUNK)):
        sel = torch.nonzero(max_rank_all > c0)[:, 0]
        px, py = px_all[sel], py_all[sel]
        t, sigma, ncon = t_all[sel], sigma_all[sel], ncon_all[sel]
        dc = [dcot[sel, f] for f in range(NUM_FEAT)]
        tf = dcot[sel, NUM_FEAT]
        rank = c0 + ranks
        in_range = rank[None, :] < max_rank_all[sel, None]
        gid = gauss_id[torch.where(in_range, tile_start.to(torch.int64)[
            sel, None] + rank[None, :], 0)].to(torch.int64)
        r = rec[gid]
        dx = r[:, :, 0:1] - px[:, None, :]
        dy = r[:, :, 1:2] - py[:, None, :]
        power = (-0.5 * (r[:, :, 2:3] * dx * dx + r[:, :, 4:5] * dy * dy)
                 - r[:, :, 3:4] * dx * dy)
        g = torch.exp(power)
        raw = r[:, :, 5:6] * g
        alpha = torch.clamp(raw, max=ALPHA_CLAMP)
        evaluated = rank[None, :, None] < ncon[:, None, :]
        used = evaluated & (power <= 0.0) & (alpha >= ALPHA_MIN)
        one_m = 1.0 - alpha
        gdot = (dc[0][:, None] * r[:, :, 6, None]
                + dc[1][:, None] * r[:, :, 7, None]
                + dc[2][:, None] * r[:, :, 8, None]
                + dc[3][:, None] * r[:, :, 9, None]
                + dc[4][:, None] * r[:, :, 10, None]
                + dc[5][:, None] * r[:, :, 11, None])
        w = torch.empty_like(alpha)
        d_alpha = torch.empty_like(alpha)
        for k in reversed(range(CHUNK)):
            u = used[:, k]
            t_before = torch.where(u, t / one_m[:, k], t)
            w[:, k] = torch.where(u, alpha[:, k] * t_before, 0.0)
            d_alpha[:, k] = torch.where(
                u, t_before * gdot[:, k] - (sigma + tf) / one_m[:, k], 0.0)
            sigma = torch.where(u, sigma + w[:, k] * gdot[:, k], sigma)
            t = t_before
        t_all[sel], sigma_all[sel] = t, sigma
        d_power = torch.where(used, raw * d_alpha, 0.0)
        d_opa = torch.where(used, g * d_alpha, 0.0)
        ca, cb, cc = r[:, :, 2:3], r[:, :, 3:4], r[:, :, 4:5]
        sx = ca * dx + cb * dy
        sy = cb * dx + cc * dy
        terms = (-sx * d_power, -sy * d_power, -0.5 * dx * dx * d_power,
                 -dx * dy * d_power, -0.5 * dy * dy * d_power, d_opa,
                 w * dc[0][:, None], w * dc[1][:, None], w * dc[2][:, None],
                 w * dc[3][:, None])
        grads = torch.zeros((sel.numel(), CHUNK, REC), dtype=dt, device=dev)
        for i, term in enumerate(terms):
            grads[:, :, i] = term.sum(dim=-1)
        d_rec.index_add_(0, gid[in_range], grads[in_range])
    return d_rec


def to_image(x, height, width):
    """(T, C, 256) channel-major tiles → (H, W, C)."""
    ty, tx = (height + TILE - 1) // TILE, (width + TILE - 1) // TILE
    c = x.shape[1]
    img = x.reshape(ty, tx, c, TILE, TILE).permute(0, 3, 1, 4, 2)
    return img.reshape(ty * TILE, tx * TILE, c)[:height, :width]


def to_tiles(img, height, width):
    ty, tx = (height + TILE - 1) // TILE, (width + TILE - 1) // TILE
    c = img.shape[2]
    img = F.pad(img, (0, 0, 0, tx * TILE - width, 0, ty * TILE - height))
    return img.reshape(ty, TILE, tx, TILE, c).permute(0, 2, 4, 1, 3) \
        .reshape(ty * tx, c, PIX)


class TileBlend(torch.autograd.Function):
    """(rec (P, 12), bg (3,)) → (colour with bg, alpha), differentiable in
    both through the backward walk."""

    @staticmethod
    def forward(ctx, rec, bg, bins: Bins, height: int, width: int):
        tx = (width + TILE - 1) // TILE
        acc, t_final, ncon = blend_forward(rec, bins.gauss_id,
                                           bins.tile_start, bins.tile_count,
                                           tx)
        ctx.save_for_backward(rec, bg, bins.gauss_id, bins.tile_start,
                              t_final, ncon)
        ctx.size = (height, width)
        color = to_image(acc[:, 0:3] + t_final[:, None] * bg[None, :, None],
                         height, width)
        return color, to_image((1.0 - t_final)[:, None], height, width)[..., 0]

    @staticmethod
    def backward(ctx, d_color, d_alpha):
        rec, bg, gauss_id, tile_start, t_final, ncon = ctx.saved_tensors
        h, w = ctx.size
        zeros = torch.zeros((h, w, 3), dtype=d_color.dtype,
                            device=d_color.device)
        dc = to_tiles(torch.cat([d_color, zeros], -1), h, w)
        dt_total = (torch.einsum("tcp,c->tp", dc[:, 0:3], bg)
                    - to_tiles(d_alpha[..., None], h, w)[:, 0])
        dcot = torch.cat([dc, (dt_total * t_final)[:, None]], 1)
        d_bg = torch.einsum("tp,tcp->c", t_final, dc[:, 0:3])
        d_rec = blend_backward(rec, gauss_id, tile_start, t_final, ncon,
                               dcot, (w + TILE - 1) // TILE)
        return d_rec, d_bg, None, None, None


def render(act: dict, cam: dict, bg, height: int, width: int,
           duration: float):
    """(colour (H, W, 3), alpha (H, W)) of one camera."""
    proc = preprocess(act, cam, height, width, duration)
    bins = bin_tiles(Processed(*(x.detach() for x in proc)), height, width)
    rec = torch.cat([proc.xy, proc.conic, proc.opacity[:, None], proc.rgb,
                     proc.depth[:, None],
                     torch.zeros_like(proc.xy)], 1)
    return TileBlend.apply(rec, bg, bins, height, width)


# --------------------------------------------------------------------------
# Sky (`gaussian_renderer/__init__.py:165-178`)
# --------------------------------------------------------------------------

def sky(texture, cam: dict, height: int, width: int):
    """The environment map's colour along each pixel's ray, bilinear
    (grid_sample, align_corners=False, zero padding)."""
    view, intr = cam["viewmatrix"], cam["intrinsics"]
    kw = dict(dtype=view.dtype, device=view.device)
    i = torch.arange(width, **kw)[None, :] + 0.5
    j = torch.arange(height, **kw)[:, None] + 0.5
    pts = torch.stack([((i - intr[2]) / intr[0]).expand(height, width),
                       ((j - intr[3]) / intr[1]).expand(height, width),
                       torch.ones((height, width), **kw)], -1)
    r_c2w = view[:3, :3].T
    origin = -(r_c2w @ view[:3, 3])
    dirs = pts @ r_c2w.T
    dirs = dirs / torch.sqrt(torch.sum(dirs * dirs, -1, keepdim=True))
    od = torch.sum(origin * dirs, -1)
    delta = od * od - (torch.sum(origin * origin) - SKY_RADIUS ** 2)
    hit = origin + dirs * (-od + torch.sqrt(torch.clamp(delta, min=1e-12))
                           )[..., None]
    u = torch.atan2(hit[..., 1], hit[..., 0]) / (2.0 * math.pi) + 0.5
    v = torch.acos(torch.clamp(hit[..., 2] / SKY_RADIUS, -1.0, 1.0)) / math.pi
    grid = (torch.stack([u, v], -1) * 2.0 - 1.0)[None]
    tex = texture.permute(2, 0, 1)[None]
    return F.grid_sample(tex, grid, mode="bilinear", padding_mode="zeros",
                         align_corners=False)[0].permute(1, 2, 0)


# --------------------------------------------------------------------------
# Losses (`utils/loss_utils.py`, `train.py:115-158`)
# --------------------------------------------------------------------------

def ssim(img1, img2, window_size: int = 11, sigma: float = 1.5):
    """Mean SSIM of (H, W, 3) images: an 11×11 gaussian window, zero
    padding, C1 = 0.01², C2 = 0.03²."""
    x = torch.arange(window_size, dtype=torch.float64) - window_size // 2
    g = torch.exp(-x ** 2 / (2 * sigma ** 2))
    g = (g / g.sum()).to(img1.dtype).to(img1.device)
    win = (g[:, None] @ g[None, :]).expand(3, 1, window_size, window_size)
    a, b = img1.permute(2, 0, 1)[None], img2.permute(2, 0, 1)[None]

    def blur(z):
        return F.conv2d(z, win.contiguous(), padding=window_size // 2,
                        groups=3)
    mu1, mu2 = blur(a), blur(b)
    s11 = blur(a * a) - mu1 * mu1
    s22 = blur(b * b) - mu2 * mu2
    s12 = blur(a * b) - mu1 * mu2
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    m = ((2 * mu1 * mu2 + c1) * (2 * s12 + c2)
         / ((mu1 * mu1 + mu2 * mu2 + c1) * (s11 + s22 + c2)))
    return m.mean()


def knn_exact(points, k: int):
    """The k nearest other points of each point, exactly: (idx, dist²),
    in row blocks of about 2^28 distances."""
    n = points.shape[0]
    block = max(1, (1 << 28) // n)
    idx, d2 = [], []
    for r0 in range(0, n, block):
        q = points[r0:r0 + block]
        d = sum((q[:, None, a] - points[None, :, a]) ** 2 for a in range(3))
        own = torch.arange(q.shape[0], device=points.device)
        d[own, r0 + own] = float("inf")
        v, i = torch.topk(d, k, dim=1, largest=False)
        idx.append(i)
        d2.append(v)
    return torch.cat(idx), torch.cat(d2)


def rigid_loss(act: dict, k: int = 20):
    """Velocity differences to the k−1 nearest neighbours (the reference's
    pointops knn returns the point itself as the k-th, at weight
    exp(0)·0), weighted by exp(−100·dist), summed, / k / N."""
    sxyzt = torch.cat([act["scales"], act["scales_t"][:, None]], -1)
    rr = rotor4d(act["rotations"], act["rotations_r"])
    rot = torch.stack([torch.stack(row, -1) for row in rr], -2)
    m = rot * sxyzt[:, None, :]
    cov = m @ m.transpose(-1, -2)
    vel = cov[:, :3, 3] / torch.clamp(cov[:, 3, 3], min=1e-12)[:, None] * 0.1
    idx, d2 = knn_exact(act["means3d"].detach(), k - 1)
    w = torch.exp(-100.0 * torch.sqrt(torch.clamp(d2, min=0.0)))
    vd2 = sum((vel[:, c][idx] - vel[:, c][:, None]) ** 2 for c in range(3))
    dist = torch.sqrt(torch.clamp(vd2, min=1e-24))
    n = act["means3d"].shape[0]
    return torch.sum(w * dist) / k / n


# --------------------------------------------------------------------------
# Adam with the reference's learning rates (`gaussian_model.py:331-369`)
# --------------------------------------------------------------------------

def learning_rates(opt: dict, spatial_scale: float, step: int) -> dict:
    t = min(max(step / opt["position_lr_max_steps"], 0.0), 1.0)
    xyz_lr = math.exp(math.log(opt["position_lr_init"] * spatial_scale)
                      * (1 - t)
                      + math.log(opt["position_lr_final"] * spatial_scale)
                      * t)
    t_lr = (opt["position_t_lr_init"] if opt["position_t_lr_init"] >= 0
            else opt["position_lr_init"])
    return dict(xyz=xyz_lr, t=t_lr * spatial_scale,
                scaling=opt["scaling_lr"], scaling_t=opt["scaling_lr"],
                rotation=opt["rotation_lr"], rotation_r=opt["rotation_lr"],
                f_dc=opt["feature_lr"], f_rest=opt["feature_lr"] / 20.0,
                opacity=opt["opacity_lr"])


def adam(params: dict, grads: dict, mu: dict, nu: dict, count: int,
         lrs: dict):
    """torch.optim.Adam's step, eps outside the square root; returns
    (params, mu, nu)."""
    b1c = 1.0 - ADAM_B1 ** count
    b2c = 1.0 - ADAM_B2 ** count
    out = ({}, {}, {})
    for name in LEAVES:
        g = grads[name]
        m = ADAM_B1 * mu[name] + (1 - ADAM_B1) * g
        v = ADAM_B2 * nu[name] + (1 - ADAM_B2) * g * g
        denom = torch.sqrt(v) / math.sqrt(b2c) + ADAM_EPS
        out[0][name] = params[name] - (lrs[name] / b1c) * (m / denom)
        out[1][name], out[2][name] = m, v
    return out


# --------------------------------------------------------------------------
# The steps
# --------------------------------------------------------------------------

def train_steps(params: dict, batches, cfg: dict, first_step: int,
                adam_count: int, spatial_scale: float, bg, env=None):
    """Run len(batches) training steps from `params` (the raw leaves, Adam
    moments zero after `adam_count` steps). `batches` yields, per step, a
    list of (camera tensors, ground truth (H, W, 3)). `cfg` holds the
    configuration's `OptimizationParams` and `time_duration`; `env` the
    environment map's texture, held fixed (past env_optimize_until).
    Returns dict(losses, grad_norms (the first step's, per leaf),
    change_norms (after the last step, per leaf))."""
    opt = cfg["OptimizationParams"]
    t0, t1 = cfg["time_duration"]
    duration = float(t1 - t0)
    lam = opt["lambda_dssim"]
    p0 = {k: v.detach() for k, v in params.items()}
    cur = dict(p0)
    mu = {k: torch.zeros_like(v) for k, v in p0.items()}
    nu = {k: torch.zeros_like(v) for k, v in p0.items()}
    losses, grad_norms = [], None
    for i, batch in enumerate(batches):
        step = first_step + i + 1
        leaves = {k: v.detach().requires_grad_() for k, v in cur.items()}
        act = activate(leaves)
        per_cam = []
        for cam, gt in batch:
            h, w = gt.shape[:2]
            color, alpha = render(act, cam, bg, h, w, duration)
            if env is not None:
                color = color + (1.0 - alpha)[..., None] * sky(env, cam, h, w)
            l1 = torch.mean(torch.abs(color - gt))
            per_cam.append((1.0 - lam) * l1 + lam * (1.0 - ssim(color, gt)))
        loss = torch.stack(per_cam).mean()
        if opt["lambda_rigid"] > 0:
            loss = loss + opt["lambda_rigid"] * rigid_loss(act)
        loss.backward()
        grads = {k: v.grad if v.grad is not None else torch.zeros_like(v)
                 for k, v in leaves.items()}
        if grad_norms is None:
            grad_norms = {k: float(torch.linalg.vector_norm(g.float()))
                          for k, g in grads.items()}
        losses.append(float(loss.detach()))
        lrs = learning_rates(opt, spatial_scale, step)
        if step < opt["iterations"]:
            cur, mu, nu = adam({k: v.detach() for k, v in leaves.items()},
                               grads, mu, nu, adam_count + i + 1, lrs)
    change = {k: float(torch.linalg.vector_norm((cur[k] - p0[k]).float()))
              for k in LEAVES}
    return dict(losses=losses, grad_norms=grad_norms, change_norms=change)
