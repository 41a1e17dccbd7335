"""Spherical-harmonic colour: real 3D SH (deg ≤ 4) and the 4D
"spherindrical" basis (spatial SH deg ≤ 3 × temporal Fourier cosines).

PyTorch counterpart of `fourdgs_tpu/ops/sh.py`: an explicit basis (P, M)
contracted with the coefficients (P, M, 3); degree annealing is a
coefficient mask. Channel layout as in the reference
(`utils/sh_utils.py:56-223`):
  3D:  (deg+1)² real SH channels, deg ≤ 4.
  4D:  48 = 16 spatial × (1 + cos(2π dt/T) + cos(4π dt/T)).
"""

from __future__ import annotations

import math

import torch

C0 = 0.28209479177387814
C1 = 0.4886025119029199
C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
      -1.0925484305920792, 0.5462742152960396)
C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
      0.3731763325901154, -0.4570457994644658, 1.445305721320277,
      -0.5900435899266435)
C4 = (2.5033429417967046, -1.7701307697799304, 0.9461746957575601,
      -0.6690465435572892, 0.10578554691520431, -0.6690465435572892,
      0.47308734787878004, -1.7701307697799304, 0.6258357354491761)

# Channel counts for gaussian_dim == 4 as a function of spatial degree when
# deg_t == 0 (reference sh_channels_4d).
SH_CHANNELS_4D = (1, 6, 16, 33)

MAX_SH_4D = 48   # deg 3 spatial x deg_t 2


def num_sh_channels(sh_degree: int, sh_degree_t: int, gaussian_dim: int,
                    force_sh_3d: bool) -> int:
    """Max coefficient count M (reference get_max_sh_channels,
    `gaussian_model.py:221-228`)."""
    if gaussian_dim == 3 or force_sh_3d:
        return (sh_degree + 1) ** 2
    if sh_degree_t == 0:
        return SH_CHANNELS_4D[sh_degree]
    return (sh_degree + 1) ** 2 * (sh_degree_t + 1)


def sh3d_basis(dirs: torch.Tensor, max_deg: int = 3) -> torch.Tensor:
    """Real SH basis values for unit directions (..., 3) → (..., (max_deg+1)²)."""
    x, y, z = dirs.unbind(-1)
    one = torch.ones_like(x)
    out = [C0 * one]
    if max_deg >= 1:
        out += [-C1 * y, C1 * z, -C1 * x]
    if max_deg >= 2:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        out += [C2[0] * xy, C2[1] * yz, C2[2] * (2.0 * zz - xx - yy),
                C2[3] * xz, C2[4] * (xx - yy)]
    if max_deg >= 3:
        out += [C3[0] * y * (3 * xx - yy), C3[1] * xy * z,
                C3[2] * y * (4 * zz - xx - yy),
                C3[3] * z * (2 * zz - 3 * xx - 3 * yy),
                C3[4] * x * (4 * zz - xx - yy), C3[5] * z * (xx - yy),
                C3[6] * x * (xx - 3 * yy)]
    if max_deg >= 4:
        out += [C4[0] * xy * (xx - yy), C4[1] * yz * (3 * xx - yy),
                C4[2] * xy * (7 * zz - 1), C4[3] * yz * (7 * zz - 3),
                C4[4] * (zz * (35 * zz - 30) + 3), C4[5] * xz * (7 * zz - 3),
                C4[6] * (xx - yy) * (7 * zz - 1), C4[7] * xz * (xx - 3 * yy),
                C4[8] * (xx * (xx - 3 * yy) - yy * (3 * xx - yy))]
    return torch.stack(out, dim=-1)


def sh4d_basis(dirs: torch.Tensor, dir_t: torch.Tensor,
               time_duration: float) -> torch.Tensor:
    """Spherindrical basis (..., 48): spatial deg-3 SH modulated by
    cos(2πk·dt/T), k = 0, 1, 2 (`sh_utils.py:115-223`)."""
    spatial = sh3d_basis(dirs, max_deg=3)  # (..., 16)
    t1 = torch.cos(2.0 * math.pi * dir_t / time_duration)[..., None]
    t2 = torch.cos(4.0 * math.pi * dir_t / time_duration)[..., None]
    return torch.cat([spatial, t1 * spatial, t2 * spatial], dim=-1)


def sh_degree_mask_3d(active_deg: int, max_channels: int,
                      device=None) -> torch.Tensor:
    """(max_channels,) 0/1 mask keeping channels with degree ≤ active_deg."""
    chan = torch.arange(max_channels, device=device)
    degs = torch.floor(torch.sqrt(chan.double())).to(torch.int32)
    return (degs <= active_deg).to(torch.float32)


def sh_degree_mask_4d(active_deg: int, active_deg_t: int,
                      device=None) -> torch.Tensor:
    """(48,) mask over the spherindrical layout from (deg, deg_t)."""
    chan = torch.arange(MAX_SH_4D, device=device)
    spatial_deg = torch.floor(torch.sqrt((chan % 16).double())).to(torch.int32)
    temporal_deg = chan // 16
    return ((spatial_deg <= active_deg)
            & (temporal_deg <= active_deg_t)).to(torch.float32)


def eval_sh3d(sh: torch.Tensor, dirs: torch.Tensor,
              mask: torch.Tensor | None = None) -> torch.Tensor:
    """Contract SH coeffs (..., M, 3) with the basis at `dirs` (..., 3) →
    (..., 3). No +0.5 offset or clamp: see `sh_to_rgb`."""
    max_deg = {1: 0, 4: 1, 9: 2, 16: 3, 25: 4}[sh.shape[-2]]
    basis = sh3d_basis(dirs, max_deg=max_deg)
    if mask is not None:
        basis = basis * mask
    return torch.einsum("...m,...mc->...c", basis, sh)


def eval_sh4d(sh: torch.Tensor, dirs: torch.Tensor, dir_t: torch.Tensor,
              time_duration: float,
              mask: torch.Tensor | None = None) -> torch.Tensor:
    """4D spherindrical colour: coeffs (..., M≤48, 3), dirs (..., 3),
    dir_t (...,)."""
    basis = sh4d_basis(dirs, dir_t, time_duration)[..., : sh.shape[-2]]
    if mask is not None:
        basis = basis * mask[: sh.shape[-2]]
    return torch.einsum("...m,...mc->...c", basis, sh)


def sh_to_rgb(raw: torch.Tensor) -> torch.Tensor:
    """+0.5 shift and clamp at zero (`forward.cu:188-194`)."""
    return torch.clamp(raw + 0.5, min=0.0)
