"""One training step: render a batch of cameras → loss → backward →
densification statistics → Adam.

PyTorch counterpart of `fourdgs_tpu/engine/step.py:build_step_fn` (the
reference hot loop, `train.py:83-252`). The JAX step vmaps the camera
batch; here the cameras are rendered one after another into one loss and
one `backward()`, which is the same math (losses are averaged over the
batch). Strips (multi-device) are not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from ..models import envmap as envmap_lib
from ..models.densify import add_densification_stats
from ..models.gaussians import (ADAM_B1, ADAM_B2, ADAM_EPS, GaussianParams,
                                GaussianState, activate, adam_update,
                                group_lrs)
from ..ops import gaussmath as gm
from ..ops import sh as shlib
from ..ops.knn import knn
from ..ops.preprocess import CameraArrays, RenderOptions
from ..render import render
from ..utils import losses as loss_lib


class StepConfig(NamedTuple):
    """Per-run configuration of the train step: the JAX package's fields."""
    lambda_dssim: float = 0.2
    lambda_opa_mask: float = 0.0
    lambda_rigid: float = 0.0
    lambda_motion: float = 0.0
    position_lr_init: float = 0.00016
    position_lr_final: float = 0.0000016
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 30_000
    position_t_lr_init: float = -1.0
    feature_lr: float = 0.0025
    opacity_lr: float = 0.05
    scaling_lr: float = 0.005
    rotation_lr: float = 0.001
    spatial_lr_scale: float = 1.0
    sh_increase_interval: int = 1000
    sh_degree: int = 3
    sh_degree_t: int = 0
    rigid_k: int = 20
    env_map_res: int = 0
    env_optimize_from: int = 0
    env_optimize_until: int = 1 << 30
    # The reference steps the optimizer only while iteration <
    # opt.iterations (`train.py:245-246`): the final iteration computes
    # grads but skips the update.
    iterations: int = 1 << 30


class StepMetrics(NamedTuple):
    """What one step reports. Tensors stay on the device; the counts of
    binning are host values already."""
    loss: torch.Tensor
    l1: torch.Tensor
    ssim_loss: torch.Tensor
    psnr: torch.Tensor
    num_rendered: int          # max over the batch
    max_per_tile: torch.Tensor  # max over the batch
    instances_dropped: int     # sum over the batch: 0 by construction
    n_active: torch.Tensor
    rigid: torch.Tensor
    motion: torch.Tensor


def sh_annealing_mask(step: int, cfg: StepConfig, opts: RenderOptions,
                      num_channels: int, device=None) -> torch.Tensor:
    """Degree-annealing mask (reference oneupSHdegree,
    `gaussian_model.py:253-257`, every sh_increase_interval steps)."""
    k = step // cfg.sh_increase_interval
    deg = min(k, cfg.sh_degree)
    if opts.gaussian_dim == 3 or opts.force_sh_3d:
        return shlib.sh_degree_mask_3d(deg, num_channels, device)
    deg_t = min(max(k - cfg.sh_degree, 0), cfg.sh_degree_t)
    return shlib.sh_degree_mask_4d(deg, deg_t, device)[:num_channels]


def _velocity(act) -> torch.Tensor:
    """Mean velocity Δμ/Δt at dt = 0.1 for the rigid/motion losses
    (`train.py:138-158` via get_current_covariance_and_mean_offset)."""
    scales_xyzt = torch.cat([act.scales, act.scales_t[..., None]], dim=-1)
    cov4 = gm.build_cov4d(scales_xyzt, act.rotations, act.rotations_r)
    cov_t = torch.clamp(cov4[..., 3, 3], min=1e-12)
    return cov4[..., :3, 3] / cov_t[..., None] * 0.1


def _motion_losses(act, n_active, cfg: StepConfig):
    """(rigid, motion) losses of the activated cloud, zeros where their
    lambda is 0."""
    zero = torch.zeros((), device=act.means3d.device)
    rigid = motion = zero
    if cfg.lambda_rigid <= 0 and cfg.lambda_motion <= 0:
        return rigid, motion
    vel = _velocity(act)
    n = torch.clamp(n_active.to(torch.float32), min=1.0)
    if cfg.lambda_rigid > 0:
        # knn excludes self where the reference's pointops knn returns it
        # as a zero-contribution neighbour: query k−1, keep /k
        # (`train.py:138-152`). span 8192 × 2 rotated passes, the JAX
        # step's per-step budget.
        idx, dist2 = knn(act.means3d.detach(), k=cfg.rigid_k - 1,
                         valid=act.active, span=8192)
        w = torch.exp(-100.0 * torch.sqrt(torch.clamp(dist2, min=0.0)))
        vd2 = torch.zeros(idx.shape, dtype=vel.dtype, device=vel.device)
        for c in range(3):
            col = vel[:, c]
            vd2 = vd2 + (col[idx] - col[:, None]) ** 2
        # A zero-safe norm: identical neighbour velocities are common.
        vel_dist = torch.sqrt(torch.clamp(vd2, min=1e-24))
        w = torch.where(act.active[:, None], w, 0.0)
        rigid = torch.sum(w * vel_dist) / cfg.rigid_k / n
    if cfg.lambda_motion > 0:
        vnorm = torch.sqrt(torch.clamp(torch.sum(vel * vel, dim=-1),
                                       min=1e-24))
        motion = torch.sum(torch.where(act.active, vnorm, 0.0)) / n
    return rigid, motion


def _grad_or_zeros(x: torch.Tensor) -> torch.Tensor:
    """A leaf's gradient, zeros where no loss term reached it (the JAX
    step differentiates every leaf: `t`, `scaling_t` and `rotation_r` in
    3D mode get zeros there)."""
    return x.grad if x.grad is not None else torch.zeros_like(x)


def env_adam_update(env: envmap_lib.EnvMapState, grad: torch.Tensor,
                    step: int, cfg: StepConfig) -> envmap_lib.EnvMapState:
    """The environment map's own Adam (lr feature_lr, eps 1e-15 outside
    the sqrt; `fourdgs_tpu/engine/step.py:287-298`), stepped only while
    env_optimize_from <= step < min(env_optimize_until, iterations)."""
    do_env = (step < cfg.iterations and step >= cfg.env_optimize_from
              and step < cfg.env_optimize_until)
    if not do_env:
        return env
    count = env.count + 1
    cnt = torch.clamp(count.to(torch.float32), min=1.0)
    b1c = 1.0 - torch.pow(torch.tensor(ADAM_B1, device=cnt.device), cnt)
    b2c = 1.0 - torch.pow(torch.tensor(ADAM_B2, device=cnt.device), cnt)
    mu = ADAM_B1 * env.mu + (1 - ADAM_B1) * grad
    nu = ADAM_B2 * env.nu + (1 - ADAM_B2) * grad * grad
    upd = cfg.feature_lr * (mu / b1c) / (torch.sqrt(nu / b2c) + ADAM_EPS)
    return envmap_lib.EnvMapState(env.texture - upd, mu, nu, count)


def train_step(state: GaussianState, step: int,
               cams: Sequence[CameraArrays], gt: torch.Tensor,
               alpha_mask: torch.Tensor, bg: torch.Tensor, cfg: StepConfig,
               opts: RenderOptions, env: envmap_lib.EnvMapState | None = None,
               intrinsics: torch.Tensor | None = None, mark=None):
    """One optimizer step over the camera batch `cams` (B cameras; gt
    (B, H, W, 3), alpha_mask (B, H, W), bg (3,)). With cfg.env_map_res > 0
    the sky of `env` is composited into each camera's colour before the
    loss (rays from `intrinsics` (B, 4) [fl_x, fl_y, cx, cy]) and the map
    takes its own Adam step. Returns (new state, new env, StepMetrics);
    nothing is changed in place.

    `mark`, if given, is called with a name as soon as the work of each
    stage is issued, for timing: `render`'s marks for each camera
    (preprocess, binning, blend), then "loss" (photometric losses),
    "knn" (the rigid and motion losses), and in the backward
    "blend_backward_start" and "blend_backward" around each camera's
    blend backward (cotangents and K2), "backward" at its end, and
    "update" (statistics and Adam)."""
    has_env = cfg.env_map_res > 0
    if has_env and (env is None or intrinsics is None):
        raise ValueError("env_map_res > 0 needs the env map and the "
                         "cameras' intrinsics")
    params = GaussianParams(*(x.detach().requires_grad_() for x in
                              state.params))
    tex = env.texture.detach().requires_grad_() if has_env else None
    p = params.xyz.shape[0]
    act = activate(params, state.n_active)
    sh_mask = sh_annealing_mask(step, cfg, opts, act.sh.shape[1],
                                act.sh.device)
    taps, outs, colors = [], [], []
    for i, cam in enumerate(cams):
        tap = torch.zeros((p, 2), dtype=params.xyz.dtype,
                          device=params.xyz.device, requires_grad=True)
        out = render(**act._asdict(), camera=cam, bg=bg, opts=opts,
                     sh_mask=sh_mask, mean2d_tap=tap, mark=mark)
        if mark:
            node = out.color.grad_fn          # the Blend backward
            node.register_prehook(
                lambda *_: mark("blend_backward_start"))
            node.register_hook(lambda *_: mark("blend_backward"))
        color = out.color
        if has_env:
            color = envmap_lib.composite_sky(color, out.alpha, tex,
                                             cam.viewmatrix, intrinsics[i])
        outs.append(out)
        colors.append(color)
        taps.append(tap)

    per_cam = [loss_lib.photometric_loss(c, g, cfg.lambda_dssim)
               for c, g in zip(colors, gt)]
    loss = torch.mean(torch.stack([c[0] for c in per_cam]))
    if cfg.lambda_opa_mask > 0:
        loss = loss + cfg.lambda_opa_mask * torch.mean(torch.stack([
            loss_lib.opacity_mask_loss(o.alpha, m)
            for o, m in zip(outs, alpha_mask)]))
    if mark:
        mark("loss")
    rigid, motion = _motion_losses(act, state.n_active, cfg)
    loss = loss + cfg.lambda_rigid * rigid + cfg.lambda_motion * motion
    if mark:
        mark("knn")

    loss.backward()
    if mark:
        mark("backward")

    # --- densification statistics (train.py:164-183, 231-238) -----------
    b = len(cams)
    vis = torch.stack([o.visible for o in outs])                 # (B, P)
    vis_count = vis.to(torch.int32).sum(dim=0)
    denom = torch.clamp(vis_count.to(torch.float32), min=1.0)
    tap_norm = torch.linalg.vector_norm(
        torch.stack([t.grad for t in taps]), dim=-1)              # (B, P)
    point_grad = tap_norm.sum(dim=0) * b / denom
    t_grad = _grad_or_zeros(params.t)[:, 0] * b / denom
    radii_max = torch.stack([o.radii for o in outs]).max(dim=0).values
    new = add_densification_stats(state, point_grad, t_grad, vis_count > 0,
                                  radii_max)

    # --- Adam ------------------------------------------------------------
    lrs = group_lrs(cfg, cfg.spatial_lr_scale, step)
    active = torch.arange(p, device=params.xyz.device) < state.n_active
    active = active & (step < cfg.iterations)
    grads = GaussianParams(*(_grad_or_zeros(x) for x in params))
    with torch.no_grad():
        new_params, new_adam = adam_update(
            GaussianParams(*(x.detach() for x in params)), grads,
            state.adam, lrs, update_mask=active)
        if has_env:
            env = env_adam_update(env, _grad_or_zeros(tex), step, cfg)
    new = new._replace(params=new_params, adam=new_adam)
    if mark:
        mark("update")

    metrics = StepMetrics(
        loss=loss.detach(),
        l1=torch.mean(torch.stack([c[1] for c in per_cam])).detach(),
        ssim_loss=torch.mean(torch.stack([c[2] for c in per_cam])).detach(),
        psnr=loss_lib.psnr(colors[-1].detach(), gt[-1]),
        num_rendered=max(o.num_rendered for o in outs),
        max_per_tile=torch.stack([o.max_per_tile for o in outs]).max(),
        instances_dropped=sum(o.instances_dropped for o in outs),
        n_active=state.n_active,
        rigid=rigid.detach(), motion=motion.detach())
    return new, env, metrics
