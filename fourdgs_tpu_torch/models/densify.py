"""Densification statistics.

PyTorch counterpart of `fourdgs_tpu/models/densify.py:add_densification_stats`
(`gaussian_model.py:579-589`, `train.py:233-238`). Densify, prune and the
opacity reset are not ported yet.
"""

from __future__ import annotations

import torch

from .gaussians import GaussianState


def add_densification_stats(state: GaussianState,
                            viewspace_grad_norm: torch.Tensor,
                            t_grad: torch.Tensor, visible: torch.Tensor,
                            radii: torch.Tensor) -> GaussianState:
    """Accumulate per-point gradient statistics and screen radii.

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
