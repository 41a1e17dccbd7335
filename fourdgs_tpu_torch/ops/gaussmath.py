"""Core 4D-gaussian math for the preprocess stage, on (P,) tensor columns.

PyTorch counterpart of `fourdgs_tpu/ops/gaussmath.py` (its columnar
functions): quaternion rotors, covariance construction, temporal
conditioning and EWA screen-space projection. Each function keeps the
JAX version's operation order, so the two agree to f32 rounding.

Reference semantics (fudan-zvg/4d-gaussian-splatting):
  * 4D rotation from an isoclinic left/right quaternion pair
    (`utils/general_utils.py:113-133`).
  * Temporal conditioning: conditional 3D covariance Σ11 − Σ12 Σ12ᵀ/Σtt,
    mean shift Σ12/Σtt · (timestamp − t), marginal exp(−½dt²/Σtt)
    (`forward.cu:332-351`).
  * EWA projection with the +0.3 px low-pass, 1.3·tanfov frustum clamp
    and 3σ radius (`forward.cu:198-237,446-471`).
"""

from __future__ import annotations

import torch

# Matches the reference blend/preprocess epsilons (forward.cu, auxiliary.h).
HOMOGENEOUS_EPS = 1e-7  # p_w = 1/(p_hom.w + 1e-7)            forward.cu:445
NEAR_PLANE = 0.2        # view-space z cull                    auxiliary.h:155
LOWPASS = 0.3           # screen-space covariance low-pass     forward.cu:234
FOV_CLAMP = 1.3         # EWA Jacobian frustum clamp           forward.cu:206
MARGINAL_CULL = 0.05    # temporal marginal hard cull          forward.cu:335
ALPHA_CLAMP = 0.99      # saturating alpha                     forward.cu:588
ALPHA_MIN = 1.0 / 255.0  # alpha floor                         forward.cu:589
T_EPS = 1e-4            # transmittance early-out              forward.cu:592


def rotor4d_rows(q_l: torch.Tensor, q_r: torch.Tensor):
    """SO(4) matrix entries of the isoclinic rotor (q_l, q_r) as 16 (P,)
    columns: r[i][j] is entry (i, j) of flip(L(q_l) @ Rᵀ(q_r))."""
    a, b, c, d = q_l.unbind(-1)
    p, q, r, s = q_r.unbind(-1)
    m = [[a * p + b * q + c * r + d * s,
          a * q - b * p - c * s + d * r,
          a * r + b * s - c * p - d * q,
          a * s - b * r + c * q - d * p],
         [b * p - a * q + d * r - c * s,
          b * q + a * p - d * s - c * r,
          b * r - a * s - d * p + c * q,
          b * s + a * r + d * q + c * p],
         [c * p - d * q - a * r + b * s,
          c * q + d * p + a * s + b * r,
          c * r - d * s + a * p - b * q,
          c * s + d * r - a * q - b * p],
         [d * p + c * q - b * r - a * s,
          d * q - c * p + b * s - a * r,
          d * r + c * s + b * p + a * q,
          d * s - c * r - b * q + a * p]]
    # Both matrix axes reversed (torch `.flip(1, 2)` in the reference).
    return [[m[3 - i][3 - j] for j in range(4)] for i in range(4)]


def cov4d_blocks_columnar(scales_xyzt: torch.Tensor, q_l: torch.Tensor,
                          q_r: torch.Tensor):
    """Σ = R S² Rᵀ blocks as columns: (cov11 packed 6-list, cov12 3-list,
    cov_t)."""
    rr = rotor4d_rows(q_l, q_r)
    s2 = [scales_xyzt[..., k] ** 2 for k in range(4)]

    def entry(i, j):
        return sum(rr[i][k] * s2[k] * rr[j][k] for k in range(4))

    cov11 = [entry(0, 0), entry(0, 1), entry(0, 2),
             entry(1, 1), entry(1, 2), entry(2, 2)]
    cov12 = [entry(0, 3), entry(1, 3), entry(2, 3)]
    return cov11, cov12, entry(3, 3)


def build_cov4d(scales_xyzt: torch.Tensor, q_l: torch.Tensor,
                q_r: torch.Tensor) -> torch.Tensor:
    """Full 4D covariance Σ = R S² Rᵀ as (P, 4, 4), R the SO(4) matrix of
    the rotor (`gaussian_model.py:34-40`, `general_utils.py:135-145`)."""
    rr = rotor4d_rows(q_l, q_r)
    rot = torch.stack([torch.stack(row, dim=-1) for row in rr], dim=-2)
    m = rot * scales_xyzt[..., None, :]
    return m @ m.transpose(-1, -2)


def condition_cov4d_columnar(scales_xyzt, q_l, q_r, t, timestamp,
                             prefilter_var: float = -1.0):
    """Temporal slice of the 4D gaussian at `timestamp`. Returns
    (cov3 packed (P, 6), delta_mean (P, 3), marginal (P,), cov_t (P,)),
    with dt = timestamp − t."""
    cov11, cov12, cov_t = cov4d_blocks_columnar(scales_xyzt, q_l, q_r)
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
    var = safe + prefilter_var if prefilter_var > 0.0 else safe
    marginal = torch.exp(-0.5 * dt * dt / var)
    return cond, delta, marginal, cov_t


def marginal_t_separable(t, scales_t, timestamp,
                         prefilter_var: float = -1.0) -> torch.Tensor:
    """Temporal marginal for gaussian_dim=4, rot_4d=False: an independent
    1D time gaussian whose variance is the activated scale_t
    (`forward.cu:431-437`)."""
    dt = t - timestamp
    var = scales_t + prefilter_var if prefilter_var > 0.0 else scales_t
    return torch.exp(-0.5 * dt * dt / torch.clamp(var, min=1e-12))


def quat_rows(quats: torch.Tensor):
    """Rotation matrix entries of a unit wxyz quaternion as 9 (P,) columns:
    r[i][j] is entry (i, j) (`general_utils.py:79-100`)."""
    r_, x, y, z = quats.unbind(-1)
    return [[1 - 2 * (y * y + z * z), 2 * (x * y - r_ * z),
             2 * (x * z + r_ * y)],
            [2 * (x * y + r_ * z), 1 - 2 * (x * x + z * z),
             2 * (y * z - r_ * x)],
            [2 * (x * z - r_ * y), 2 * (y * z + r_ * x),
             1 - 2 * (x * x + y * y)]]


def cov3d_columnar(scales: torch.Tensor, quats: torch.Tensor) -> torch.Tensor:
    """3D covariance R S² Rᵀ from a unit wxyz quaternion: packed (P, 6)
    [xx, xy, xz, yy, yz, zz]."""
    rr = quat_rows(quats)
    s2 = [scales[..., k] ** 2 for k in range(3)]

    def entry(i, j):
        return sum(rr[i][k] * s2[k] * rr[j][k] for k in range(3))

    return torch.stack([entry(0, 0), entry(0, 1), entry(0, 2),
                        entry(1, 1), entry(1, 2), entry(2, 2)], dim=-1)


def ewa_project_columnar(mean3d, cov3, viewmatrix, focal, tan_fov):
    """EWA splat: packed world covariance (P, 6) → packed 2D screen
    covariance (P, 3) [cxx, cxy, cyy] with the +0.3 low-pass. viewmatrix
    (4, 4) applies as V @ [x; 1]; focal, tan_fov are (2,)."""
    w = viewmatrix[:3, :3]
    x, y, z = mean3d.unbind(-1)
    tview = [w[i, 0] * x + w[i, 1] * y + w[i, 2] * z + viewmatrix[i, 3]
             for i in range(3)]
    tz = tview[2]
    lim0 = FOV_CLAMP * tan_fov[0]
    lim1 = FOV_CLAMP * tan_fov[1]
    txz = torch.clamp(tview[0] / tz, -lim0, lim0) * tz
    tyz = torch.clamp(tview[1] / tz, -lim1, lim1) * tz
    inv_z = 1.0 / tz
    inv_z2 = inv_z * inv_z
    j00 = focal[0] * inv_z
    j02 = -(focal[0] * txz) * inv_z2
    j11 = focal[1] * inv_z
    j12 = -(focal[1] * tyz) * inv_z2
    m0 = [j00 * w[0, k] + j02 * w[2, k] for k in range(3)]
    m1 = [j11 * w[1, k] + j12 * w[2, k] for k in range(3)]
    xx, xy, xz, yy, yz, zz = cov3.unbind(-1)
    sig = [[xx, xy, xz], [xy, yy, yz], [xz, yz, zz]]
    sm0 = [sum(sig[i][k] * m0[k] for k in range(3)) for i in range(3)]
    sm1 = [sum(sig[i][k] * m1[k] for k in range(3)) for i in range(3)]
    cxx = sum(m0[k] * sm0[k] for k in range(3)) + LOWPASS
    cxy = sum(m0[k] * sm1[k] for k in range(3))
    cyy = sum(m1[k] * sm1[k] for k in range(3)) + LOWPASS
    return torch.stack([cxx, cxy, cyy], dim=-1)


def cov2d_to_conic_radius(cov2d: torch.Tensor):
    """Invert the 2D covariance and bound the splat extent.

    Returns (conic (P, 3) [a, b, c], radius (P,) float pixels, valid (P,)).
    Radius = ceil(3·√λmax) with the reference's max(0.1, ·) eigenvalue
    guard; valid requires det != 0 and int(radius) >= 1
    (`forward.cu:446-471`).
    """
    cxx, cxy, cyy = cov2d.unbind(-1)
    det = cxx * cyy - cxy * cxy
    valid = det != 0.0
    det_inv = torch.where(
        valid, 1.0 / torch.where(valid, det, torch.ones_like(det)),
        torch.zeros_like(det))
    conic = torch.stack([cyy * det_inv, -cxy * det_inv, cxx * det_inv], -1)
    mid = 0.5 * (cxx + cyy)
    lam = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    radius = torch.ceil(3.0 * torch.sqrt(lam))
    valid = valid & (radius.to(torch.int32) >= 1)
    return conic, radius, valid


def project_points_columnar(mean3d, projmatrix, wh):
    """Full projection to pixel coordinates. projmatrix (4, 4) = P @ V
    applied as M @ [x; 1]; wh = [width, height]. Returns
    (xy_pixel (P, 2), ndc (P, 3)) with ndc2Pix(v, S) = ((v+1)·S − 1)/2
    (`auxiliary.h:42-45`)."""
    x, y, z = mean3d.unbind(-1)
    hom = [projmatrix[i, 0] * x + projmatrix[i, 1] * y
           + projmatrix[i, 2] * z + projmatrix[i, 3] for i in range(4)]
    inv_w = 1.0 / (hom[3] + HOMOGENEOUS_EPS)
    ndc = torch.stack([hom[0] * inv_w, hom[1] * inv_w, hom[2] * inv_w], -1)
    xy = ((ndc[..., :2] + 1.0) * wh - 1.0) * 0.5
    return xy, ndc


def view_z(mean3d: torch.Tensor, viewmatrix: torch.Tensor) -> torch.Tensor:
    """View-space depth (the blend's depth channel)."""
    return mean3d @ viewmatrix[2, :3] + viewmatrix[2, 3]
