"""Adaptive density control: densification statistics, clone / split /
prune, and the opacity reset.

PyTorch counterpart of `fourdgs_tpu/models/densify.py` (reference
`scene/gaussian_model.py:376-589`). The JAX package keeps the cloud in
capacity-padded arrays and scatters survivors and new rows into them; here
every tensor takes its true size, so each event gathers the rows it keeps
and concatenates the new ones. Rows at or past `n_active` (a JAX state's
padding) are dropped. The row order is the JAX package's: kept old rows in
order, then clones in order, then the `split_n` children of the k-th kept
split parent at `n_old + n_clone + k·split_n + j`.

Behaviour, as in the JAX package:
  * clone: grad-norm >= thr and max world scale <= percent_dense · extent;
    an exact copy with zeroed Adam moments (`gaussian_model.py:533-555`).
  * split: grad-norm >= thr and max scale > percent_dense · extent;
    `split_n` children drawn from the parent's own (4D, when rot_4d)
    gaussian, child scales parent / (0.8 · split_n), parents pruned
    (`gaussian_model.py:486-531`). The normal draws are an argument
    (`split_noise` makes them from a `torch.Generator`).
  * final prune: opacity < min_opacity, plus (with the size threshold)
    world scale > 0.1 · extent; the radii test is dead in the densify path
    (statistics just zeroed) and live in `prune_only`
    (`gaussian_model.py:557-575`, postfix reset at 478-483).
  * every statistic is zeroed after `densify_and_prune`; `prune_only`
    compacts them (`prune_points`, `gaussian_model.py:421-431`).
  * opacity reset: op <- min(op, 0.01), opacity Adam moments zeroed
    (`gaussian_model.py:371-389`).
"""

from __future__ import annotations

from typing import List, NamedTuple

import torch

from ..ops import gaussmath as gm
from ..utils import tracing
from .gaussians import AdamState, GaussianParams, GaussianState, normalize


class DensifyConfig(NamedTuple):
    """Densification hyper-parameters (reference OptimizationParams)."""
    grad_threshold: float = 0.0002
    min_opacity: float = 0.005
    percent_dense: float = 0.01
    max_screen_size: float = 20.0
    split_n: int = 2


class DensifyInfo(NamedTuple):
    """What one event did, as host ints."""
    n_active: int
    n_cloned: int
    n_split: int
    n_pruned: int


def _f32(x: float, device) -> torch.Tensor:
    # Thresholds as f32 products, as the JAX package forms them.
    return torch.tensor(x, dtype=torch.float32, device=device)


def split_noise(rows: int, split_n: int, rot_4d: bool, gaussian_dim: int,
                generator: torch.Generator, device) -> List[torch.Tensor]:
    """The normal draws of one event's split children: `split_n` tensors
    of (rows, 4) (rot_4d: one 4-vector; 4D without rot_4d: three spatial
    columns, then the time draw), or (rows, 3) in 3D."""
    k = 4 if rot_4d or gaussian_dim == 4 else 3
    return [torch.randn((rows, k), generator=generator, device=device)
            for _ in range(split_n)]


def _split_children(params: GaussianParams, noise, n: int, rot_4d: bool,
                    gaussian_dim: int) -> List[GaussianParams]:
    """The `n` children of every row of `params`, from the draws `noise`
    (rows of `split_noise`'s). Sampling as `gaussian_model.py:505-526`."""
    scales = torch.exp(params.scaling)
    scales_t = torch.exp(params.scaling_t)
    shrink = torch.log(_f32(1.0 / (0.8 * n), scales.device))
    children = []
    for eps in noise:
        if rot_4d:
            rr = gm.rotor4d_rows(normalize(params.rotation),
                                 normalize(params.rotation_r))
            v = eps * torch.cat([scales, scales_t], dim=-1)
            delta = torch.stack([sum(rr[i][k] * v[:, k] for k in range(4))
                                 for i in range(4)], dim=-1)
            xyz, t = params.xyz + delta[:, :3], params.t + delta[:, 3:4]
            scaling_t = params.scaling_t + shrink
        else:
            rr = gm.quat_rows(normalize(params.rotation))
            v = eps[:, :3] * scales
            delta = torch.stack([sum(rr[i][k] * v[:, k] for k in range(3))
                                 for i in range(3)], dim=-1)
            xyz = params.xyz + delta
            if gaussian_dim == 4:
                t = params.t + eps[:, 3:4] * scales_t
                scaling_t = params.scaling_t + shrink
            else:
                t, scaling_t = params.t, params.scaling_t
        children.append(params._replace(
            xyz=xyz, t=t, scaling=params.scaling + shrink,
            scaling_t=scaling_t))
    return children


def _rows(params: GaussianParams, idx: torch.Tensor) -> GaussianParams:
    return GaussianParams(*(x[idx] for x in params))


def _cat(parts) -> GaussianParams:
    return GaussianParams(*(torch.cat(xs) for xs in zip(*parts)))


def _zeros(params: GaussianParams) -> GaussianParams:
    return GaussianParams(*(torch.zeros_like(x) for x in params))


@torch.no_grad()
def densify_and_prune(state: GaussianState, noise, extent: float, *,
                      cfg: DensifyConfig, rot_4d: bool = True,
                      gaussian_dim: int = 4,
                      use_size_threshold: bool = False):
    """One densification event. `noise`: `cfg.split_n` tensors of normal
    draws, one row per row of the state (`split_noise`). Returns (new
    state of exactly n_active rows, DensifyInfo)."""
    params = state.params
    device = params.xyz.device
    rows = params.xyz.shape[0]
    active = torch.arange(rows, device=device) < tracing.read(
        "densify", state.n_active)

    denom = torch.clamp(state.denom, min=1.0)
    grads = torch.where(state.denom > 0, state.xyz_grad_accum / denom, 0.0)
    scales = torch.exp(params.scaling)
    max_scale = scales.max(dim=-1).values
    opacity = torch.sigmoid(params.opacity[:, 0])
    extent32 = _f32(extent, device)
    dense = _f32(cfg.percent_dense, device) * extent32
    big = _f32(0.1, device) * extent32

    hot = active & (grads >= cfg.grad_threshold)
    clone = hot & (max_scale <= dense)
    split = hot & (max_scale > dense)
    # The final prune covers old and new rows; its radii test is dead
    # here (the statistics were just zeroed: reference parity).
    too_big = (max_scale > big if use_size_threshold
               else torch.zeros_like(active))
    drop = (opacity < cfg.min_opacity) | too_big
    keep_old = active & ~split & ~drop
    keep_clone = clone & ~drop          # clones copy the parent's op, scale
    keep_child = split & (opacity >= cfg.min_opacity)
    if use_size_threshold:              # children test their own size
        keep_child = keep_child & ~(
            (scales / (0.8 * cfg.split_n)).max(dim=-1).values > big)

    old = keep_old.nonzero()[:, 0]
    cloned = keep_clone.nonzero()[:, 0]
    parents = keep_child.nonzero()[:, 0]
    children = _split_children(_rows(params, parents),
                               [eps[parents] for eps in noise],
                               cfg.split_n, rot_4d, gaussian_dim)
    # (k, j) → row k·split_n + j: a parent's children side by side.
    interleaved = GaussianParams(*(
        torch.stack(xs, dim=1).flatten(0, 1) for xs in zip(*children)))
    fresh = _cat([_rows(params, cloned), interleaved])
    new_params = _cat([_rows(params, old), fresh])
    zero_new = _zeros(fresh)
    n = new_params.xyz.shape[0]
    zeros1 = torch.zeros(n, dtype=state.xyz_grad_accum.dtype, device=device)
    new_state = GaussianState(
        params=new_params,
        adam=AdamState(mu=_cat([_rows(state.adam.mu, old), zero_new]),
                       nu=_cat([_rows(state.adam.nu, old), zero_new]),
                       count=state.adam.count),
        n_active=torch.as_tensor(n, device=device),
        xyz_grad_accum=zeros1, t_grad_accum=zeros1.clone(),
        denom=zeros1.clone(), max_radii2d=zeros1.clone())
    info = DensifyInfo(
        n_active=n, n_cloned=int(cloned.numel()),
        n_split=int(parents.numel()),
        n_pruned=tracing.read("densify", (active & drop & ~split).sum()))
    return new_state, info


@torch.no_grad()
def prune_only(state: GaussianState, extent: float, *, cfg: DensifyConfig,
               use_size_threshold: bool = True):
    """A prune pass alone (reference densify_and_prune(prune_only=True):
    the radii test is live). The statistics are compacted with the rows,
    not zeroed. Returns (new state, kept rows as a host int)."""
    params = state.params
    device = params.xyz.device
    rows = params.xyz.shape[0]
    active = torch.arange(rows, device=device) < tracing.read(
        "densify", state.n_active)
    drop = torch.sigmoid(params.opacity[:, 0]) < cfg.min_opacity
    if use_size_threshold:
        big = _f32(0.1, device) * _f32(extent, device)
        drop = (drop | (state.max_radii2d > cfg.max_screen_size)
                | (torch.exp(params.scaling).max(dim=-1).values > big))
    keep = (active & ~drop).nonzero()[:, 0]
    n = int(keep.numel())
    return GaussianState(
        params=_rows(params, keep),
        adam=AdamState(_rows(state.adam.mu, keep),
                       _rows(state.adam.nu, keep), state.adam.count),
        n_active=torch.as_tensor(n, device=device),
        xyz_grad_accum=state.xyz_grad_accum[keep],
        t_grad_accum=state.t_grad_accum[keep],
        denom=state.denom[keep], max_radii2d=state.max_radii2d[keep]), n


@torch.no_grad()
def reset_opacity(state: GaussianState) -> GaussianState:
    """op <- inverse_sigmoid(min(sigmoid(op), 0.01)), opacity Adam moments
    zeroed (`gaussian_model.py:371-389`)."""
    op = torch.clamp(torch.sigmoid(state.params.opacity), max=0.01)
    new_op = torch.log(op / (1.0 - op))
    zero = torch.zeros_like(new_op)
    return state._replace(
        params=state.params._replace(opacity=new_op),
        adam=state.adam._replace(mu=state.adam.mu._replace(opacity=zero),
                                 nu=state.adam.nu._replace(opacity=zero)))


def add_densification_stats(state: GaussianState,
                            viewspace_grad_norm: torch.Tensor,
                            t_grad: torch.Tensor, visible: torch.Tensor,
                            radii: torch.Tensor) -> GaussianState:
    """Accumulate per-point gradient statistics and screen radii
    (`gaussian_model.py:579-589`, `train.py:233-238`).

    viewspace_grad_norm (P,): batch-normalised |dL/dmean2d|; t_grad (P,):
    batch-normalised dL/dt; visible (P,) bool; radii (P,) int."""
    vis = visible
    zero = torch.zeros((), dtype=state.xyz_grad_accum.dtype,
                       device=vis.device)
    return state._replace(
        xyz_grad_accum=state.xyz_grad_accum
        + torch.where(vis, viewspace_grad_norm, zero),
        t_grad_accum=state.t_grad_accum + torch.where(vis, t_grad, zero),
        denom=state.denom + vis.to(state.denom.dtype),
        max_radii2d=torch.maximum(
            state.max_radii2d,
            torch.where(vis, radii.to(torch.float32), zero)))

