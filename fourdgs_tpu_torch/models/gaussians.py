"""The 4D gaussian parameter set.

PyTorch counterpart of `fourdgs_tpu/models/gaussians.py` for serving: the
9 learned tensors (`GaussianParams`, field names and shapes of the JAX
NamedTuple and of the reference param groups, `gaussian_model.py:336-351`)
held by an `nn.Module`, and their activation (`gaussian_model.py:49-60`).
The optimizer and densification come with the training port.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch
from torch import nn


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
    """Adam moments as a JAX checkpoint stores them (unused by serving)."""
    mu: GaussianParams
    nu: GaussianParams
    count: Any


class GaussianState(NamedTuple):
    """The training state a JAX checkpoint stores."""
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


def _normalize(q: torch.Tensor) -> torch.Tensor:
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
        rotations=_normalize(params.rotation),
        rotations_r=_normalize(params.rotation_r),
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
