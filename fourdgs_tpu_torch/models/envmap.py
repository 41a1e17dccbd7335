"""Equirectangular environment map on a radius-60 sky sphere.

PyTorch counterpart of `fourdgs_tpu/models/envmap.py` (reference
`gaussian_renderer/__init__.py:165-178`, `train.py:71-77`): a (res, res, 3)
texture; per pixel a camera ray is intersected with the sphere, mapped to
equirect (u, v) and bilinearly sampled (torch grid_sample
align_corners=False semantics, written out so that the taps are the JAX
package's); composited as `rendered + (1 - alpha) * env`. Channel-last.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple

import numpy as np
import torch

SKY_RADIUS = 60.0


class EnvMapState(NamedTuple):
    """The environment map and its Adam moments (the layout a checkpoint
    stores): tensors, or numpy arrays on the way to and from disk."""
    texture: Any    # (res, res, 3)
    mu: Any
    nu: Any
    count: Any      # () integer


def init_envmap(res: int, device="cuda") -> EnvMapState:
    z = torch.zeros((res, res, 3), dtype=torch.float32, device=device)
    return EnvMapState(z, torch.zeros_like(z), torch.zeros_like(z),
                       torch.zeros((), dtype=torch.int64, device=device))


def from_jax_envmap(env, device="cuda") -> EnvMapState:
    """The port's `EnvMapState` from the JAX package's, given as that
    NamedTuple of numpy arrays (or anything `np.asarray` takes): floats as
    f32, the step count as int64."""
    as_f32 = lambda a: torch.as_tensor(  # noqa: E731
        np.asarray(a, np.float32), device=device)
    return EnvMapState(
        texture=as_f32(env.texture), mu=as_f32(env.mu), nu=as_f32(env.nu),
        count=torch.as_tensor(np.asarray(env.count).astype(np.int64),
                              device=device))


def camera_rays(viewmatrix: torch.Tensor, intrinsics: torch.Tensor,
                height: int, width: int):
    """Per-pixel world-space rays.

    intrinsics: (4,) [fl_x, fl_y, cx, cy] in pixels.
    Returns (origin (3,), dirs (H, W, 3) unit). Matches the reference
    `Camera.get_rays` (`scene/cameras.py:75-82`): pixel centres at +0.5.
    """
    fl_x, fl_y, cx, cy = intrinsics[0], intrinsics[1], intrinsics[2], \
        intrinsics[3]
    kw = dict(dtype=viewmatrix.dtype, device=viewmatrix.device)
    i = torch.arange(width, **kw)[None, :] + 0.5
    j = torch.arange(height, **kw)[:, None] + 0.5
    x = ((i - cx) / fl_x).expand(height, width)
    y = ((j - cy) / fl_y).expand(height, width)
    pts_view = torch.stack([x, y, torch.ones((height, width), **kw)], -1)
    r_c2w = viewmatrix[:3, :3].T          # inverse rotation
    campos = -(r_c2w @ viewmatrix[:3, 3])
    dirs = pts_view @ r_c2w.T
    dirs = dirs / torch.sqrt(torch.sum(dirs * dirs, dim=-1, keepdim=True))
    return campos, dirs


def _bilinear_sample(tex: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """grid_sample(align_corners=False, zeros padding) for uv in [-1, 1],
    tex (R, R, 3), uv (..., 2) with uv[..., 0] = x (width axis)."""
    r_h, r_w = tex.shape[0], tex.shape[1]
    x = (uv[..., 0] + 1.0) * 0.5 * r_w - 0.5
    y = (uv[..., 1] + 1.0) * 0.5 * r_h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx = x - x0
    wy = y - y0

    def tap(yi, xi):
        inb = (xi >= 0) & (xi < r_w) & (yi >= 0) & (yi < r_h)
        xi_c = torch.clamp(xi, 0, r_w - 1).to(torch.int64)
        yi_c = torch.clamp(yi, 0, r_h - 1).to(torch.int64)
        return torch.where(inb[..., None], tex[yi_c, xi_c], 0.0)

    return ((1 - wx)[..., None] * (1 - wy)[..., None] * tap(y0, x0)
            + wx[..., None] * (1 - wy)[..., None] * tap(y0, x0 + 1)
            + (1 - wx)[..., None] * wy[..., None] * tap(y0 + 1, x0)
            + wx[..., None] * wy[..., None] * tap(y0 + 1, x0 + 1))


def sample_sky(texture: torch.Tensor, origin: torch.Tensor,
               dirs: torch.Tensor) -> torch.Tensor:
    """Environment colour for unit rays hitting the R=60 sphere."""
    od = torch.sum(origin * dirs, dim=-1)
    delta = od * od - (torch.sum(origin * origin) - SKY_RADIUS ** 2)
    t_hit = -od + torch.sqrt(torch.clamp(delta, min=1e-12))
    hit = origin + dirs * t_hit[..., None]
    tu = torch.atan2(hit[..., 1], hit[..., 0]) / (2.0 * math.pi) + 0.5
    tv = torch.acos(torch.clamp(hit[..., 2] / SKY_RADIUS, -1.0, 1.0)) \
        / math.pi
    uv = torch.stack([tu, tv], dim=-1) * 2.0 - 1.0
    return _bilinear_sample(texture, uv)


def composite_sky(color: torch.Tensor, alpha: torch.Tensor,
                  texture: torch.Tensor, viewmatrix: torch.Tensor,
                  intrinsics: torch.Tensor) -> torch.Tensor:
    """rendered + (1 - alpha) * env (`gaussian_renderer/__init__.py:178`)."""
    h, w = color.shape[:2]
    origin, dirs = camera_rays(viewmatrix, intrinsics, h, w)
    bg = sample_sky(texture, origin, dirs)
    return color + (1.0 - alpha)[..., None] * bg
