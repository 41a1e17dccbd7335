"""One training step: render a batch of cameras → loss → backward →
densification statistics → Adam.

PyTorch counterpart of `fourdgs_tpu/engine/step.py:build_step_fn` (the
reference hot loop, `train.py:83-252`). The JAX step vmaps the camera
batch; here the cameras are rendered one after another into one loss and
one `backward()`, which is the same math (losses are averaged over the
batch). A camera may render as horizontal strips (`strips`), joined into
its full frame before the loss, and the batch may spread over the ranks
of a process group (`mesh`, `parallel/mesh.py`).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch
import torch.distributed as dist

from ..models import envmap as envmap_lib
from ..models.densify import add_densification_stats
from ..models.gaussians import (ADAM_B1, ADAM_B2, ADAM_EPS, GaussianParams,
                                GaussianState, activate, adam_update,
                                group_lrs)
from ..ops import gaussmath as gm
from ..ops import sh as shlib
from ..ops.knn import knn
from ..ops.preprocess import CameraArrays, RenderOptions
from ..parallel.mesh import Mesh, gather_strips
from ..parallel.strips import strip_windows, window_intrinsics, window_rows
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


def _render_strips(act, sh_mask, cams: Sequence[CameraArrays],
                   opts: RenderOptions, intrinsics, strips: int, lo: int,
                   hi: int, *, bg, tex, mark):
    """Render camera-strips lo..hi-1 of the batch `cams` (strip g is strip
    g % strips of camera g // strips, rendered as its window of the frame,
    `parallel/strips.py:strip_windows`) from the activated cloud `act`,
    each with a zero viewspace tap (its gradient is the densification
    statistic) and the sky of `tex` composited (rays from the camera's row
    of `intrinsics`, moved to the window): (render outputs, taps, colours,
    alphas), the colours and alphas cut to the strip's rows."""
    windows = strip_windows(opts, strips) if strips > 1 else [opts]
    crops = window_rows(opts.height, strips)
    p = act.means3d.shape[0]
    outs, taps, colors, alphas = [], [], [], []
    for g in range(lo, hi):
        cam, s = cams[g // strips], g % strips
        tap = torch.zeros((p, 2), dtype=act.means3d.dtype,
                          device=act.means3d.device, requires_grad=True)
        out = render(**act._asdict(), camera=cam, bg=bg, opts=windows[s],
                     sh_mask=sh_mask, mean2d_tap=tap, mark=mark)
        if mark:
            node = out.color.grad_fn          # the Blend backward
            node.register_prehook(
                lambda *_: mark("blend_backward_start"))
            node.register_hook(lambda *_: mark("blend_backward"))
        color = out.color
        if tex is not None:
            color = envmap_lib.composite_sky(
                color, out.alpha, tex, cam.viewmatrix,
                window_intrinsics(intrinsics[g // strips], windows[s]))
        outs.append(out)
        taps.append(tap)
        colors.append(color[crops[s]:])
        alphas.append(out.alpha[crops[s]:])
    return outs, taps, colors, alphas


def _join_frames(parts: Sequence[torch.Tensor], strips: int):
    """Full frames from camera-major strips: the rows of each run of
    `strips` consecutive parts, top to bottom."""
    if strips == 1:
        return list(parts)
    return [torch.cat(list(parts[i:i + strips]), dim=0)
            for i in range(0, len(parts), strips)]


def _fold_strips(x: torch.Tensor, strips: int, how: str) -> torch.Tensor:
    """Per camera-strip (B·strips, ...) → per camera (B, ...) by `how`
    ("any", "sum" or "amax") over each camera's strips
    (`fourdgs_tpu/engine/step.py:256-268`)."""
    if strips == 1:
        return x
    return getattr(x.reshape((-1, strips) + x.shape[1:]), how)(dim=1)


def _batch_mean(values: Sequence[torch.Tensor], b: int) -> torch.Tensor:
    """sum(values) / b: the mean of `values` where they are the whole
    batch of b."""
    return torch.mean(torch.stack(list(values))) * (len(values) / b)


def _all_reduce(mesh: Mesh, leaves, vis, tap, radii, floats, ints):
    """Over the ranks of `mesh`: the sum of the gradients of `leaves`
    (written back to their .grad), of the per-camera `vis` and `tap` and
    of the scalars `floats`; the largest `radii` and integer scalars
    `ints`. Returns (vis, tap, radii, floats, ints) reduced, vis as a
    bool."""
    grads = [_grad_or_zeros(x) for x in leaves]
    flat = torch.cat([g.reshape(-1) for g in grads] + [
        tap.reshape(-1), vis.to(tap.dtype).reshape(-1),
        torch.stack([torch.as_tensor(v, dtype=tap.dtype, device=tap.device)
                     for v in floats])])
    top = torch.cat([radii.reshape(-1), torch.stack([
        torch.as_tensor(v, dtype=radii.dtype, device=radii.device)
        for v in ints])])
    dist.all_reduce(flat, group=mesh.group)
    dist.all_reduce(top, op=dist.ReduceOp.MAX, group=mesh.group)
    parts = torch.split(flat, [g.numel() for g in grads]
                        + [tap.numel(), vis.numel(), len(floats)])
    for x, g in zip(leaves, parts):
        x.grad = g.view_as(x)
    return (parts[-2].view(vis.shape) > 0, parts[-3].view_as(tap),
            top[:radii.numel()].view_as(radii), parts[-1],
            top[radii.numel():])


def train_step(state: GaussianState, step: int,
               cams: Sequence[CameraArrays], gt: torch.Tensor,
               alpha_mask: torch.Tensor, bg: torch.Tensor, cfg: StepConfig,
               opts: RenderOptions, env: envmap_lib.EnvMapState | None = None,
               intrinsics: torch.Tensor | None = None, mark=None,
               strips: int = 1, mesh: Mesh | None = None):
    """One optimizer step over the camera batch `cams` (B cameras; gt
    (B, H, W, 3), alpha_mask (B, H, W), bg (3,)). With cfg.env_map_res > 0
    the sky of `env` is composited into each camera's colour before the
    loss (rays from `intrinsics` (B, 4) [fl_x, fl_y, cx, cy]) and the map
    takes its own Adam step. Returns (new state, new env, StepMetrics);
    nothing is changed in place.

    strips > 1: each camera renders as `strips` horizontal strips, each
    as its window of the frame (`parallel/strips.py:strip_windows`) cut
    to its H/strips rows, one blend per strip; the strips are joined into
    full frames before the loss, so that SSIM windows cross the strip
    boundaries and the math is that of the full frame. (The JAX step
    takes B·strips strip cameras instead, `parallel/strips.py` says why
    the port does not.)

    mesh (`parallel/mesh.py:Mesh`): the data-parallel step. Every rank
    passes the whole batch and renders its contiguous share of the
    B·strips camera-strips; the gradients, statistics and metrics are
    reduced over the ranks, and every rank returns what one process
    returns for the whole batch. B·strips must divide by the mesh size
    (else ValueError). Where a camera's strips lie on two ranks, the strip
    colours are all-gathered, with their gradients, before its loss.

    `mark`, if given, is called with a name as soon as the work of each
    stage is issued, for timing: `render`'s marks for each camera-strip
    (preprocess, binning, blend), then "loss" (photometric losses),
    "knn" (the rigid and motion losses), and in the backward
    "blend_backward_start" and "blend_backward" around each blend
    backward (cotangents and K2), "backward" at its end, with a mesh
    "all_reduce_start" and "all_reduce" around the collectives, and
    "update" (statistics and Adam)."""
    has_env = cfg.env_map_res > 0
    if has_env and (env is None or intrinsics is None):
        raise ValueError("env_map_res > 0 needs the env map and the "
                         "cameras' intrinsics")
    b = len(cams)
    size, rank = (mesh.size, mesh.rank) if mesh is not None else (1, 0)
    if (b * strips) % size:
        raise ValueError(f"batch_size*strips {b * strips} not divisible by "
                         f"mesh size {size}")
    per = b * strips // size
    lo, hi = rank * per, (rank + 1) * per
    # The cameras whose strips this rank renders: it takes their losses
    # (they read its strips), and reports those whose first strip it holds.
    first_cam, last_cam = lo // strips, (hi - 1) // strips
    mine = [c - first_cam for c in range(first_cam, last_cam + 1)
            if c * strips >= lo]

    params = GaussianParams(*(x.detach().requires_grad_() for x in
                              state.params))
    tex = env.texture.detach().requires_grad_() if has_env else None
    p = params.xyz.shape[0]
    act = activate(params, state.n_active)
    sh_mask = sh_annealing_mask(step, cfg, opts, act.sh.shape[1],
                                act.sh.device)
    outs, taps, colors, alphas = _render_strips(
        act, sh_mask, cams, opts, intrinsics, strips, lo, hi, bg=bg,
        tex=tex, mark=mark)
    if per % strips:                       # a camera's strips on two ranks
        span = slice(first_cam * strips, (last_cam + 1) * strips)
        colors = list(gather_strips(torch.stack(colors), mesh))[span]
        if cfg.lambda_opa_mask > 0:
            alphas = list(gather_strips(torch.stack(alphas), mesh))[span]
    frames = _join_frames(colors, strips)
    per_cam = [loss_lib.photometric_loss(c, g, cfg.lambda_dssim)
               for c, g in zip(frames, gt[first_cam:last_cam + 1])]
    loss = _batch_mean([c[0] for c in per_cam], b)
    opa = []
    if cfg.lambda_opa_mask > 0:
        opa = [loss_lib.opacity_mask_loss(a, m) for a, m in zip(
            _join_frames(alphas, strips), alpha_mask[first_cam:last_cam + 1])]
        loss = loss + cfg.lambda_opa_mask * _batch_mean(opa, b)
    if mark:
        mark("loss")
    zero = torch.zeros((), device=params.xyz.device)
    rigid, motion = (_motion_losses(act, state.n_active, cfg) if rank == 0
                     else (zero, zero))
    loss = loss + cfg.lambda_rigid * rigid + cfg.lambda_motion * motion
    if mark:
        mark("knn")

    loss.backward()
    if mark:
        mark("backward")

    def reported(values):
        """This rank's share of the batch mean of `values` (one per camera
        whose loss it took)."""
        return _batch_mean([values[i] for i in mine], b) if mine else zero

    vis = torch.stack([o.visible for o in outs])    # (camera-strips, P)
    tap = torch.stack([t.grad for t in taps])
    radii = torch.stack([o.radii for o in outs])
    metrics = dict(
        loss=loss.detach(), l1=reported([c[1] for c in per_cam]).detach(),
        ssim_loss=reported([c[2] for c in per_cam]).detach(),
        psnr=(loss_lib.psnr(frames[-1].detach(), gt[b - 1])
              if lo <= (b - 1) * strips < hi else zero),
        rigid=rigid.detach(), motion=motion.detach(),
        instances_dropped=sum(o.instances_dropped for o in outs),
        num_rendered=max(o.num_rendered for o in outs),
        max_per_tile=torch.stack([o.max_per_tile for o in outs]).max())
    if mesh is not None:
        # This rank's strips in the whole batch, zeros elsewhere.
        vis, tap, radii = (torch.zeros((b * strips,) + x.shape[1:],
                                       dtype=x.dtype, device=x.device)
                           .index_copy(0, torch.arange(lo, hi,
                                                       device=x.device), x)
                           for x in (vis, tap, radii))
    vis = _fold_strips(vis, strips, "any")                 # (B, P)
    tap = _fold_strips(tap, strips, "sum")
    radii = _fold_strips(radii, strips, "amax")
    if mesh is not None:
        total = reported([c[0] for c in per_cam])
        if opa:
            total = total + cfg.lambda_opa_mask * reported(opa)
        metrics["loss"] = (total + cfg.lambda_rigid * rigid
                           + cfg.lambda_motion * motion).detach()
        floats = ("loss", "l1", "ssim_loss", "psnr", "rigid", "motion",
                  "instances_dropped")
        if mark:
            mark("all_reduce_start")
        vis, tap, radii, summed, top = _all_reduce(
            mesh, list(params) + ([tex] if has_env else []), vis, tap, radii,
            [metrics[k] for k in floats],
            [metrics["num_rendered"], metrics["max_per_tile"]])
        if mark:
            mark("all_reduce")
        metrics.update(zip(floats, summed))
        metrics.update(instances_dropped=int(metrics["instances_dropped"]),
                       num_rendered=int(top[0]), max_per_tile=top[1])

    # --- densification statistics (train.py:164-183, 231-238) -----------
    vis_count = vis.to(torch.int32).sum(dim=0)
    denom = torch.clamp(vis_count.to(torch.float32), min=1.0)
    tap_norm = torch.linalg.vector_norm(tap, dim=-1)             # (B, P)
    point_grad = tap_norm.sum(dim=0) * b / denom
    t_grad = _grad_or_zeros(params.t)[:, 0] * b / denom
    radii_max = radii.max(dim=0).values
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
    return new, env, StepMetrics(n_active=state.n_active, **metrics)
