"""Brute-force O(P · pixels) oracle renderer, for tests only.

PyTorch counterpart of `fourdgs_tpu/ops/reference_renderer.py`: every
pixel considers every gaussian in global depth order, masked by the tile
rect the binner would have used, with no binning. The pixels are blended
in bands of whole tile rows, one band at a time, each holding at most
BAND_PAIRS (pixel, gaussian) pairs, so that a full-size frame fits in
memory; each pixel's arithmetic is the same whatever the band.
"""

from __future__ import annotations

import torch

from . import gaussmath as gm
from . import preprocess as pre
from .preprocess import TILE, CameraArrays, RenderOptions

# Pixels x gaussians held at once: 2^27 entries, ~0.5 GB per f32 tensor of
# the blend. A small frame is one band.
BAND_PAIRS = 1 << 27


def band_tile_rows(n_points: int, width: int) -> int:
    """Tile rows per band: as many as keep a band within BAND_PAIRS pairs,
    at least one."""
    wp = -(-width // TILE) * TILE
    return max(1, BAND_PAIRS // (TILE * wp * max(n_points, 1)))


def render_reference(*, means3d, t, scales, scales_t, rotations,
                     rotations_r, opacity, sh, active,
                     camera: CameraArrays, bg, opts: RenderOptions):
    """Returns (color (H,W,3), depth (H,W), flow (H,W,2), alpha (H,W))."""
    proc = pre.preprocess(
        means3d=means3d, t=t, scales=scales, scales_t=scales_t,
        rotations=rotations, rotations_r=rotations_r, opacity=opacity,
        sh=sh, active=active, camera=camera, opts=opts)

    # Global stable depth order; each tile's order is its restriction.
    order = torch.argsort(proc.depth, stable=True)
    xy = proc.xy[order]
    conic = proc.conic[order]
    opa = proc.opacity[order]
    feat = torch.cat([proc.rgb, proc.depth[:, None], proc.flow], -1)[order]
    rect = proc.rect[order]
    visible = proc.visible[order]

    hp, wp = opts.tiles_y * TILE, opts.tiles_x * TILE
    device = means3d.device
    band = band_tile_rows(means3d.shape[0], opts.width) * TILE
    outs, t_fins = [], []
    for y0 in range(0, hp, band):
        ys, xs = torch.meshgrid(
            torch.arange(y0, min(y0 + band, hp), device=device),
            torch.arange(wp, device=device), indexing="ij")
        pxf = xs.reshape(-1, 1).to(torch.float32)              # (N, 1)
        pyf = ys.reshape(-1, 1).to(torch.float32)
        tx = (pxf / TILE).to(torch.int32)
        ty = (pyf / TILE).to(torch.int32)
        covered = ((rect[:, 0] <= tx) & (tx < rect[:, 2])
                   & (rect[:, 1] <= ty) & (ty < rect[:, 3]) & visible)
        dx = xy[:, 0] - pxf                                    # (N, P)
        dy = xy[:, 1] - pyf
        power = (-0.5 * (conic[:, 0] * dx * dx + conic[:, 2] * dy * dy)
                 - conic[:, 1] * dx * dy)
        alpha = torch.clamp(opa * torch.exp(power), max=gm.ALPHA_CLAMP)
        valid = covered & (power <= 0.0) & (alpha >= gm.ALPHA_MIN)
        a_v = torch.where(valid, alpha, 0.0)
        q = torch.cumprod(1.0 - a_v, dim=1)
        fail = valid & (q < gm.T_EPS)
        dead = torch.cumsum(fail.to(torch.int32), dim=1) > 0
        used = valid & ~dead
        a_u = torch.where(used, alpha, 0.0)
        cu = 1.0 - a_u
        prod_incl = torch.cumprod(cu, dim=1)
        w = a_u * prod_incl / cu
        outs.append(w @ feat)
        t_fins.append(prod_incl[:, -1])
    out = torch.cat(outs).reshape(hp, wp, -1)[: opts.height, : opts.width]
    t_fin = torch.cat(t_fins).reshape(hp, wp)[: opts.height, : opts.width]
    color = out[..., 0:3] + t_fin[..., None] * bg
    return color, out[..., 3], out[..., 4:6], 1.0 - t_fin
