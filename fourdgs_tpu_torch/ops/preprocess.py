"""Per-gaussian preprocess: temporal conditioning → frustum cull → EWA
projection → conic/radius/tile rect → SH colour.

PyTorch counterpart of `fourdgs_tpu/ops/preprocess.py` (the reference
`preprocessCUDA`, `cuda_rasterizer/forward.cu:355-496`): elementwise work
over (P,) tensors; culling is masking, never a shape change.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import gaussmath as gm
from . import sh as shlib

TILE = 16  # BLOCK_X = BLOCK_Y = 16 (reference config.h:15-16)


class CameraArrays(NamedTuple):
    """Per-camera tensors. Matrices apply as M @ [x; 1] (the reference
    stores them transposed and right-multiplies; `scene/cameras.py:65-71`)."""
    viewmatrix: torch.Tensor   # (4, 4) world → view
    projmatrix: torch.Tensor   # (4, 4) = P @ V
    campos: torch.Tensor       # (3,)
    focal: torch.Tensor        # (2,) [fx, fy] pixels
    tanfov: torch.Tensor       # (2,) [tan(fovx/2), tan(fovy/2)]
    timestamp: torch.Tensor    # () scalar


class RenderOptions(NamedTuple):
    """Static renderer configuration."""
    height: int
    width: int
    gaussian_dim: int = 4
    rot_4d: bool = True
    force_sh_3d: bool = False
    time_duration: float = 1.0
    prefilter_var: float = -1.0
    scale_modifier: float = 1.0

    @property
    def tiles_x(self) -> int:
        return (self.width + TILE - 1) // TILE

    @property
    def tiles_y(self) -> int:
        return (self.height + TILE - 1) // TILE

    @property
    def num_tiles(self) -> int:
        return self.tiles_x * self.tiles_y


class ProcessedGaussians(NamedTuple):
    """Per-gaussian screen-space quantities (all (P, ...), masked by `visible`)."""
    xy: torch.Tensor            # (P, 2) pixel-space mean
    depth: torch.Tensor         # (P,) view-space z
    conic: torch.Tensor         # (P, 3) inverse 2D covariance [a, b, c]
    opacity: torch.Tensor       # (P,) final alpha multiplier (marginal applied)
    rgb: torch.Tensor           # (P, 3) clamped colour
    flow: torch.Tensor          # (P, 2) 2D flow feature (zeros)
    radius: torch.Tensor        # (P,) int32 pixel radius (0 if culled)
    rect: torch.Tensor          # (P, 4) int32 tile rect [x0, y0, x1, y1)
    tiles_touched: torch.Tensor  # (P,) int32
    visible: torch.Tensor       # (P,) bool
    means3d: torch.Tensor       # (P, 3) time-shifted world means
    cov3d: torch.Tensor         # (P, 6) conditional covariance (packed)


def _clip(x, lo, hi):
    """jnp.clip order: lower bound first, then upper."""
    return torch.minimum(torch.maximum(x, lo), hi)


def preprocess(
    *,
    means3d: torch.Tensor,
    t: torch.Tensor,
    scales: torch.Tensor,
    scales_t: torch.Tensor,
    rotations: torch.Tensor,
    rotations_r: torch.Tensor,
    opacity: torch.Tensor,
    sh: torch.Tensor,
    active: torch.Tensor,
    camera: CameraArrays,
    opts: RenderOptions,
    sh_mask: torch.Tensor | None = None,
    mean2d_tap: torch.Tensor | None = None,
) -> ProcessedGaussians:
    """Run the full preprocess for one camera.

    Args:
      means3d (P,3), t (P,), scales (P,3), scales_t (P,): post-activation.
      rotations / rotations_r (P,4): normalised quaternions.
      opacity (P,): post-sigmoid.
      sh (P, M, 3): SH coefficients (dc + rest, reference channel order).
      active (P,): bool mask of live gaussians.
      sh_mask: optional (M,) degree-annealing mask.
      mean2d_tap: optional (P, 2) zeros, added to the NDC mean so that its
        gradient is the reference's viewspace_points gradient
        (`gaussian_renderer/__init__.py:27-31`, NDC units), the
        densification statistic.
    """
    p = means3d.shape[0]
    mod = opts.scale_modifier

    # --- temporal conditioning -------------------------------------------
    if opts.gaussian_dim == 4 and opts.rot_4d:
        scales_xyzt = torch.cat([scales, scales_t[..., None]], dim=-1) * mod
        cov3, delta_mean, marginal, _ = gm.condition_cov4d_columnar(
            scales_xyzt, rotations, rotations_r, t, camera.timestamp,
            opts.prefilter_var)
        marginal_ok = marginal > gm.MARGINAL_CULL
        shifted = means3d + delta_mean
        op = opacity * marginal
    else:
        cov3 = gm.cov3d_columnar(scales * mod, rotations)
        shifted = means3d
        if opts.gaussian_dim == 4:
            marginal = gm.marginal_t_separable(
                t, scales_t * mod, camera.timestamp, opts.prefilter_var)
            marginal_ok = marginal > gm.MARGINAL_CULL
            op = opacity * marginal
        else:
            marginal_ok = torch.ones((p,), dtype=torch.bool,
                                     device=means3d.device)
            op = opacity

    # --- frustum cull + projection ---------------------------------------
    depth = gm.view_z(shifted, camera.viewmatrix)
    in_front = depth > gm.NEAR_PLANE

    wh = torch.tensor([opts.width, opts.height], dtype=means3d.dtype,
                      device=means3d.device)
    xy, _ = gm.project_points_columnar(shifted, camera.projmatrix, wh)
    if mean2d_tap is not None:
        xy = xy + mean2d_tap * (wh * 0.5)
    cov2d = gm.ewa_project_columnar(shifted, cov3, camera.viewmatrix,
                                    camera.focal, camera.tanfov)
    conic, radius_f, conic_ok = gm.cov2d_to_conic_radius(cov2d)

    # --- tile rect (getRect semantics, auxiliary.h:47-57) ----------------
    # The reported radius and the visibility test keep the reference's
    # isotropic ceil(3·sqrt(λmax)) footprint; the rect handed to the
    # binner is tightened below.
    tx, ty = opts.tiles_x, opts.tiles_y
    zero_i = torch.zeros((), dtype=torch.int32, device=means3d.device)
    tx_i = torch.full((), tx, dtype=torch.int32, device=means3d.device)
    ty_i = torch.full((), ty, dtype=torch.int32, device=means3d.device)
    r_int = radius_f.to(torch.int32)
    xi = xy[..., 0]
    yi = xy[..., 1]
    x0r = _clip(((xi - radius_f) / TILE).to(torch.int32), zero_i, tx_i)
    y0r = _clip(((yi - radius_f) / TILE).to(torch.int32), zero_i, ty_i)
    x1r = _clip(((xi + radius_f + TILE - 1) / TILE).to(torch.int32),
                zero_i, tx_i)
    y1r = _clip(((yi + radius_f + TILE - 1) / TILE).to(torch.int32),
                zero_i, ty_i)
    ntiles_ref = (x1r - x0r) * (y1r - y0r)

    visible = active & marginal_ok & in_front & conic_ok & (ntiles_ref > 0)

    # --- opacity-aware rect tightening -----------------------------------
    # alpha = op·exp(-Q/2) reaches ALPHA_MIN only inside Q <= tau,
    # tau = 2·ln(op/ALPHA_MIN), whose bounding box has half-extents
    # sqrt(tau·Σxx), sqrt(tau·Σyy); capped by the reference radius so the
    # footprint stays a subset. Tiles outside it contribute nothing.
    tau = torch.clamp(
        2.0 * torch.log(torch.clamp(op, min=1e-12) * (1.0 / gm.ALPHA_MIN)),
        min=0.0)
    ex = torch.minimum(torch.sqrt(tau * torch.clamp(cov2d[..., 0], min=0.0))
                       * 1.0001 + 0.01, radius_f)
    ey = torch.minimum(torch.sqrt(tau * torch.clamp(cov2d[..., 2], min=0.0))
                       * 1.0001 + 0.01, radius_f)
    x0 = _clip(((xi - ex) / TILE).to(torch.int32), x0r, x1r)
    y0 = _clip(((yi - ey) / TILE).to(torch.int32), y0r, y1r)
    x1 = _clip(((xi + ex + TILE - 1) / TILE).to(torch.int32), x0r, x1r)
    y1 = _clip(((yi + ey + TILE - 1) / TILE).to(torch.int32), y0r, y1r)
    # op < ALPHA_MIN cannot pass the blend's alpha floor anywhere.
    ntiles = torch.where(op >= gm.ALPHA_MIN, (x1 - x0) * (y1 - y0), zero_i)

    # --- colour ------------------------------------------------------------
    # The reference CUDA path evaluates SH at the UNSHIFTED means
    # (forward.cu:480-487 passes orig_points).
    dirs = means3d - camera.campos
    dirs = dirs / torch.clamp(
        torch.sqrt(torch.sum(dirs * dirs, dim=-1, keepdim=True)), min=1e-12)
    if opts.gaussian_dim == 3 or opts.force_sh_3d:
        rgb = shlib.sh_to_rgb(shlib.eval_sh3d(sh, dirs, sh_mask))
    else:
        dir_t = t - camera.timestamp
        rgb = shlib.sh_to_rgb(shlib.eval_sh4d(
            sh, dirs, dir_t, opts.time_duration, sh_mask))

    return ProcessedGaussians(
        xy=xy,
        depth=depth,
        conic=conic,
        opacity=torch.where(visible, op, torch.zeros_like(op)),
        rgb=rgb,
        flow=torch.zeros((p, 2), dtype=means3d.dtype, device=means3d.device),
        radius=torch.where(visible, r_int, zero_i),
        rect=torch.stack([x0, y0, x1, y1], dim=-1),
        tiles_touched=torch.where(visible, ntiles, zero_i),
        visible=visible,
        means3d=shifted,
        cov3d=cov3,
    )
