"""The 4D gaussian parameter set.

PyTorch counterpart of `fourdgs_tpu/models/gaussians.py`: the 9 learned
tensors (`GaussianParams`, field names and shapes of the JAX NamedTuple and
of the reference param groups, `gaussian_model.py:336-351`) held by an
`nn.Module` for serving, their activation (`gaussian_model.py:49-60`), and
for training the state as tensors (`GaussianState`), the initial cloud
from a point cloud (`init_from_pcd`), the per-group learning rates and the
hand-rolled torch-order Adam (`gaussian_model.py:331-369`).
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple

import numpy as np
import torch
from torch import nn

from ..ops import sh as shlib

ADAM_B1 = 0.9
ADAM_B2 = 0.999
ADAM_EPS = 1e-15  # reference gaussian_model.py:353


class GaussianParams(NamedTuple):
    """Raw (pre-activation) learned tensors, padded to capacity P."""
    xyz: Any          # (P, 3)
    t: Any            # (P, 1)
    scaling: Any      # (P, 3)   log-scale
    scaling_t: Any    # (P, 1)   log-scale
    rotation: Any     # (P, 4)   unnormalised quat (left)
    rotation_r: Any   # (P, 4)   unnormalised quat (right)
    f_dc: Any         # (P, 1, 3)
    f_rest: Any       # (P, M-1, 3)
    opacity: Any      # (P, 1)   pre-sigmoid


class AdamState(NamedTuple):
    """Adam moments and step count (the JAX checkpoint's layout)."""
    mu: GaussianParams
    nu: GaussianParams
    count: Any


class GaussianState(NamedTuple):
    """The training state (the one a JAX checkpoint stores). The
    densification accumulators are (P,) f32."""
    params: GaussianParams
    adam: AdamState
    n_active: Any
    xyz_grad_accum: Any
    t_grad_accum: Any
    denom: Any
    max_radii2d: Any


class Activated(NamedTuple):
    """Post-activation views consumed by the renderer."""
    means3d: torch.Tensor
    t: torch.Tensor
    scales: torch.Tensor
    scales_t: torch.Tensor
    rotations: torch.Tensor
    rotations_r: torch.Tensor
    opacity: torch.Tensor
    sh: torch.Tensor
    active: torch.Tensor


def normalize(q: torch.Tensor) -> torch.Tensor:
    n = torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True))
    return q / torch.clamp(n, min=1e-12)


def activate(params: GaussianParams, n_active: int) -> Activated:
    """exp / sigmoid / normalise activations; rows at index >= n_active
    are inactive padding."""
    p = params.xyz.shape[0]
    return Activated(
        means3d=params.xyz,
        t=params.t[:, 0],
        scales=torch.exp(params.scaling),
        scales_t=torch.exp(params.scaling_t[:, 0]),
        rotations=normalize(params.rotation),
        rotations_r=normalize(params.rotation_r),
        opacity=torch.sigmoid(params.opacity[:, 0]),
        sh=torch.cat([params.f_dc, params.f_rest], dim=1),
        active=torch.arange(p, device=params.xyz.device) < n_active,
    )


class GaussianModel(nn.Module):
    """The learned tensors of one cloud as parameters, plus its active
    count."""

    def __init__(self, params: GaussianParams, n_active: int):
        super().__init__()
        for name, value in params._asdict().items():
            setattr(self, name, nn.Parameter(value, requires_grad=False))
        self.n_active = int(n_active)

    def params(self) -> GaussianParams:
        return GaussianParams(*(getattr(self, f)
                                for f in GaussianParams._fields))

    def activate(self) -> Activated:
        return activate(self.params(), self.n_active)


def from_jax_params(params, n_active, device="cuda") -> GaussianModel:
    """A `GaussianModel` from the JAX package's `GaussianParams`, given as
    that NamedTuple or as a dict keyed by its field names, of numpy arrays
    (or anything `np.asarray` takes)."""
    fields = params if isinstance(params, dict) else params._asdict()
    tensors = GaussianParams(**{
        f: torch.as_tensor(np.asarray(fields[f], np.float32), device=device)
        for f in GaussianParams._fields})
    return GaussianModel(tensors, int(np.asarray(n_active)))


def as_tensors(tree, device):
    """A NamedTuple tree of arrays (numpy, or anything `np.asarray`
    takes) → the same tree of tensors on `device`: floating arrays as f32,
    integer ones as int64."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(as_tensors(x, device) for x in tree))
    a = np.asarray(tree)
    dtype = np.float32 if a.dtype.kind == "f" else np.int64
    return torch.as_tensor(a.astype(dtype), device=device)


def from_jax_state(state, device="cuda") -> GaussianState:
    """The port's training state from the JAX package's `GaussianState`
    (params, Adam mu/nu/count, n_active and the densification
    accumulators), given as that NamedTuple of numpy arrays, or as this
    module's `GaussianState` of them (what `load_checkpoint` reads)."""
    def params(x):
        return GaussianParams(**x._asdict())

    adam = state.adam
    return as_tensors(GaussianState(
        params=params(state.params),
        adam=AdamState(params(adam.mu), params(adam.nu), adam.count),
        **{f: getattr(state, f) for f in GaussianState._fields[2:]}),
        device)


def init_from_pcd(points: np.ndarray, colors: np.ndarray, *,
                  sh_channels: int, time_duration=(0.0, 1.0),
                  times: np.ndarray | None = None, seed: int = 0,
                  mean_knn_dist2: np.ndarray | None = None,
                  device="cuda") -> GaussianState:
    """The initial training state of exactly the cloud's n rows on
    `device` (reference create_from_pcd, `gaussian_model.py:259-300`;
    `fourdgs_tpu/models/gaussians.py:init_from_pcd` less its capacity):
      * colour DC from RGB, the rest of the SH zero;
      * times from the ply, else uniform over 1.2 × duration − 0.1, drawn
        from `np.random.default_rng(seed)` as the JAX package draws them;
      * log-scale = log √(max(mean squared distance to the 3 nearest
        neighbours, 1e-7)), the distances from `ops/knn.py` on `device`
        unless given;
      * scale_t = log √(duration / 5); opacity 0.1; identity quaternions.
    The host arithmetic is the JAX package's numpy, so that equal inputs
    give equal parameters."""
    n = points.shape[0]
    rng = np.random.default_rng(seed)
    dur = time_duration[1] - time_duration[0]
    if times is None:
        times = ((rng.random((n, 1)) * 1.2 - 0.1) * dur
                 + time_duration[0])
    xyz = torch.as_tensor(np.asarray(points, np.float32), device=device)
    if mean_knn_dist2 is None:
        from ..ops.knn import mean_dist2_to_3nn
        mean_knn_dist2 = mean_dist2_to_3nn(xyz).cpu().numpy()
    dist2 = np.maximum(np.asarray(mean_knn_dist2, np.float32), 1e-7)
    scales = np.log(np.sqrt(dist2))[:, None].repeat(3, axis=1)
    f_dc = (np.asarray(colors, np.float32) - 0.5) / shlib.C0
    identity = np.tile(np.float32([1, 0, 0, 0]), (n, 1))

    def f32(x):
        return torch.as_tensor(np.ascontiguousarray(x, np.float32),
                               device=device)

    params = GaussianParams(
        xyz=xyz, t=f32(times), scaling=f32(scales),
        scaling_t=f32(np.full((n, 1), math.log(math.sqrt(dur / 5.0)))),
        rotation=f32(identity), rotation_r=f32(identity),
        f_dc=f32(f_dc[:, None, :]),
        f_rest=f32(np.zeros((n, sh_channels - 1, 3))),
        opacity=f32(np.full((n, 1), np.log(0.1 / (1 - 0.1)))))
    return new_state(params, n)


def new_state(params: GaussianParams, n_active: int) -> GaussianState:
    """A fresh training state for `params` (tensors): Adam moments zero,
    step count 0, densification accumulators zero."""
    zeros = GaussianParams(*(torch.zeros_like(x) for x in params))
    p = params.xyz.shape[0]
    device = params.xyz.device
    acc = lambda: torch.zeros(p, dtype=torch.float32, device=device)  # noqa: E731
    return GaussianState(
        params=params,
        adam=AdamState(mu=zeros, nu=zeros,
                       count=torch.zeros((), dtype=torch.int64,
                                         device=device)),
        n_active=torch.as_tensor(int(n_active), device=device),
        xyz_grad_accum=acc(), t_grad_accum=acc(), denom=acc(),
        max_radii2d=acc())


def expon_lr(step: int, lr_init: float, lr_final: float,
             lr_delay_steps: int = 0, lr_delay_mult: float = 1.0,
             max_steps: int = 1000000) -> float:
    """JaxNeRF-style log-linear decay (`general_utils.py:30-63`), on the
    host: the step is a Python int here."""
    t = min(max(step / max_steps, 0.0), 1.0)
    log_lerp = math.exp(math.log(lr_init) * (1 - t) + math.log(lr_final) * t)
    if lr_delay_steps > 0:
        delay = lr_delay_mult + (1 - lr_delay_mult) * math.sin(
            0.5 * math.pi * min(max(step / lr_delay_steps, 0.0), 1.0))
    else:
        delay = 1.0
    return delay * log_lerp


def group_lrs(opt_cfg, spatial_lr_scale: float, step: int) -> GaussianParams:
    """Per-group learning rates at `step` (reference training_setup +
    update_learning_rate, `gaussian_model.py:331-369`)."""
    xyz_lr = expon_lr(
        step,
        opt_cfg.position_lr_init * spatial_lr_scale,
        opt_cfg.position_lr_final * spatial_lr_scale,
        lr_delay_mult=opt_cfg.position_lr_delay_mult,
        max_steps=opt_cfg.position_lr_max_steps)
    t_lr_init = (opt_cfg.position_t_lr_init
                 if opt_cfg.position_t_lr_init >= 0
                 else opt_cfg.position_lr_init)
    return GaussianParams(
        xyz=xyz_lr,
        t=t_lr_init * spatial_lr_scale,
        scaling=opt_cfg.scaling_lr,
        scaling_t=opt_cfg.scaling_lr,
        rotation=opt_cfg.rotation_lr,
        rotation_r=opt_cfg.rotation_lr,
        f_dc=opt_cfg.feature_lr,
        f_rest=opt_cfg.feature_lr / 20.0,
        opacity=opt_cfg.opacity_lr,
    )


def adam_update(params: GaussianParams, grads: GaussianParams,
                state: AdamState, lrs: GaussianParams,
                update_mask: torch.Tensor | None = None):
    """torch-Adam step (eps added outside the sqrt, eps = 1e-15), in
    torch's evaluation order: denom = sqrt(v)/sqrt(b2c) + eps;
    p -= (lr/b1c) * m / denom. The bias corrections are f32, as in the
    JAX package. `update_mask` (P,) freezes the rows where it is False
    (their moments still decay). Returns new (params, AdamState); nothing
    is updated in place."""
    count = state.count + 1
    cnt = count.to(torch.float32)
    b1c = 1.0 - torch.pow(torch.tensor(ADAM_B1, device=cnt.device), cnt)
    b2c = 1.0 - torch.pow(torch.tensor(ADAM_B2, device=cnt.device), cnt)
    new_p, new_m, new_v = [], [], []
    for p, g, m, v, lr in zip(params, grads, state.mu, state.nu, lrs):
        m = ADAM_B1 * m + (1 - ADAM_B1) * g
        v = ADAM_B2 * v + (1 - ADAM_B2) * g * g
        step = (lr / b1c) * (m / (torch.sqrt(v) / torch.sqrt(b2c)
                                  + ADAM_EPS))
        if update_mask is not None:
            mask = update_mask.reshape((-1,) + (1,) * (p.dim() - 1))
            step = torch.where(mask, step, 0.0)
        new_p.append(p - step)
        new_m.append(m)
        new_v.append(v)
    return (GaussianParams(*new_p),
            AdamState(GaussianParams(*new_m), GaussianParams(*new_v), count))
