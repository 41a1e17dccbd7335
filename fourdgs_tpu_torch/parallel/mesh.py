"""Data parallelism of the camera(-strip) batch over a process group.

PyTorch counterpart of `fourdgs_tpu/parallel/mesh.py`. The JAX package
jits the step over a device mesh and lets XLA insert the collectives from
the shardings; here each rank of a `torch.distributed` group runs
`engine.step.train_step(..., mesh=)` on its share of the batch and the
collectives are written out there:

  * the gaussian cloud, its Adam state and the env map: REPLICATED on
    every rank (every camera needs every gaussian), and updated
    identically on every rank from the same summed gradients;
  * the camera(-strip) batch: rank r renders its contiguous share of the
    B·n camera-major strips;
  * the loss: the mean over the B full frames, each frame's loss taken
    once; the rigid and motion terms once, on rank 0;
  * the gradients of every parameter and of the env texture, the
    per-camera visibility and viewspace tap gradients: summed over ranks
    by one all_reduce; the per-camera radii and the binning counts: one
    all_reduce with MAX.

Where one camera's strips lie on different ranks, the strip colours (and
alphas, for the opacity-mask loss) are all-gathered with their gradients
before the full-frame loss, as XLA inserts the same all-gather in the JAX
step (`fourdgs_tpu/engine/step.py:171-173`).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist

from ..models.gaussians import GaussianState
from ..ops.preprocess import CameraArrays, RenderOptions

DATA_AXIS = "data"


class Mesh(NamedTuple):
    """A 1-D data axis over the ranks of a process group: this process's
    rank in it, the group's size, and the device its tensors live on."""
    group: Optional[dist.ProcessGroup]   # None: the default group
    rank: int
    size: int
    device: torch.device


def make_mesh(n_devices: Optional[int] = None, group=None) -> Mesh:
    """The data axis over the ranks of `group` (default: the world). A
    process group must be open (`multihost.initialize`). `n_devices`, if
    given, must be the group's size: each process drives one device."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call "
                           "parallel.multihost.initialize first")
    size = dist.get_world_size(group)
    if n_devices is not None and n_devices != size:
        raise ValueError(f"a mesh of {n_devices} devices over a group of "
                         f"{size} processes")
    device = (torch.device("cuda", torch.cuda.current_device())
              if dist.get_backend(group) == "nccl" else torch.device("cpu"))
    return Mesh(group, dist.get_rank(group), size, device)


def replicate(mesh: Mesh, tensors: Sequence[torch.Tensor]):
    """Make every rank's copy of `tensors` equal to rank 0's (in place)."""
    src = dist.get_global_rank(mesh.group, 0) if mesh.group else 0
    for x in tensors:
        dist.broadcast(x, src, group=mesh.group)


def shard_batch(mesh: Mesh, items: Sequence):
    """This rank's contiguous share of a leading-axis batch (a list or a
    tensor); the batch must divide by the mesh size."""
    if len(items) % mesh.size != 0:
        raise ValueError(f"batch {len(items)} not divisible by mesh size "
                         f"{mesh.size}")
    per = len(items) // mesh.size
    return items[mesh.rank * per:(mesh.rank + 1) * per]


class _GatherStrips(torch.autograd.Function):
    """all_gather along dim 0 of equal-sized parts, differentiable: every
    rank computes the losses that read its own part, so the backward
    keeps the rank's slice of the gathered gradient and needs no
    collective."""

    @staticmethod
    def forward(ctx, x, mesh: Mesh):
        parts = [torch.empty_like(x) for _ in range(mesh.size)]
        dist.all_gather(parts, x.contiguous(), group=mesh.group)
        ctx.rank, ctx.n = mesh.rank, x.shape[0]
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, grad):
        return grad[ctx.rank * ctx.n:(ctx.rank + 1) * ctx.n], None


def gather_strips(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The (L, ...) parts of every rank, concatenated in rank order."""
    return _GatherStrips.apply(x, mesh)


def make_sharded_train_step(opts: RenderOptions, cfg, mesh: Mesh, *,
                            batch_size: int = 1, strips: int = 1):
    """`engine.step.train_step` over `mesh` for batches of `batch_size`
    cameras as `strips` strips each: each rank renders its contiguous
    share of the batch_size·strips camera(-strip) axis, and the result
    equals `train_step` on the whole batch, on every rank. Requires
    batch_size·strips to be a multiple of the mesh size (the JAX
    package's rule, `fourdgs_tpu/parallel/mesh.py:75-79`).

    The returned `step_fn(state, step, cams, gt, alpha_mask, bg, env=None,
    intrinsics=None, mark=None)` takes the whole batch of B cameras on
    every rank and returns (new state, new env, StepMetrics)."""
    from ..engine.step import train_step     # engine.step imports this

    total = batch_size * strips
    if total % mesh.size != 0:
        raise ValueError(f"batch_size*strips {total} not divisible by "
                         f"mesh size {mesh.size}")

    def step_fn(state: GaussianState, step: int,
                cams: Sequence[CameraArrays], gt: torch.Tensor,
                alpha_mask: torch.Tensor, bg: torch.Tensor, env=None,
                intrinsics: torch.Tensor | None = None, mark=None):
        if len(cams) != batch_size or gt.shape[0] != batch_size:
            raise ValueError(f"{len(cams)} cameras and {gt.shape[0]} frames "
                             f"for batch_size {batch_size}")
        return train_step(state, step, cams, gt, alpha_mask, bg, cfg, opts,
                          env=env, intrinsics=intrinsics, mark=mark,
                          strips=strips, mesh=mesh)

    return step_fn
