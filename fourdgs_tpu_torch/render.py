"""Public rendering API: preprocess → tile binning → blend, and the serving
module that renders a trained cloud.

PyTorch counterpart of `fourdgs_tpu/render.py` (the reference
`gaussian_renderer.render()` contract, `gaussian_renderer/__init__.py:19-194`)
and of the trainer's eval renderer (`engine/trainer.py`,
`_make_eval_render.eval_fn`).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch
from torch import nn

from .engine.checkpoint import load_checkpoint
from .models.gaussians import GaussianModel
from .ops import binning
from .ops import blend as blend_lib
from .ops import gaussmath as gm
from .ops import preprocess as pre
from .ops.preprocess import CameraArrays, RenderOptions


class RenderOutputs(NamedTuple):
    color: torch.Tensor         # (H, W, 3)
    depth: torch.Tensor         # (H, W) alpha-weighted, unnormalised
    alpha: torch.Tensor         # (H, W)
    flow: torch.Tensor          # (H, W, 2)
    radii: torch.Tensor         # (P,) int32 screen radius (0 = invisible)
    visible: torch.Tensor       # (P,) bool
    num_rendered: int           # tile instances this render
    max_per_tile: torch.Tensor  # () int32 densest tile population
    instances_dropped: int      # instances not rendered: 0 by construction
    cov3d_com: torch.Tensor     # (P, 6) conditional 3D covariance (packed)


def blend_inputs(*, camera: CameraArrays, opts: RenderOptions,
                 mark: Callable[[str], None] | None = None,
                 infer: bool = False, **gaussians):
    """Preprocess and tile binning of the post-activation `gaussians`
    (the keyword arguments of `preprocess`): (proc, bins, the record table
    that the blend kernels gather from: (P, 12) f32, or with `infer` the
    packed (P, 8) int32 table of kernel K3). Binning sees a detached
    `proc` (the JAX package's stop_gradient): gradients reach the gaussians
    through the records only."""
    proc = pre.preprocess(**gaussians, camera=camera, opts=opts)
    if mark:
        mark("preprocess")
    bins = binning.bin_gaussians(
        pre.ProcessedGaussians(*(x.detach() for x in proc)), opts)
    if mark:
        mark("binning")
    build = blend_lib.pack_records_infer if infer else blend_lib.build_records
    return proc, bins, build(proc)


def render(*, means3d, t, scales, scales_t, rotations, rotations_r,
           opacity, sh, active, camera: CameraArrays, bg,
           opts: RenderOptions, sh_mask=None, mean2d_tap=None,
           colors_precomp=None, cov3d_precomp=None, infer: bool = False,
           mark: Callable[[str], None] | None = None) -> RenderOutputs:
    """Render one camera, differentiably. All inputs post-activation (see
    `preprocess`, which also takes `sh_mask`, `mean2d_tap`,
    `colors_precomp` and `cov3d_precomp`), on one device: CUDA tensors run
    the CUDA blend kernels (K1 forward, K2 in the backward), CPU tensors
    their plain versions. `mark`, if given, is called with the name of
    each stage (preprocess, binning, blend) as soon as its work is issued.

    infer=True takes the forward-only packed path (kernel K3): xy and conic
    exact, opacity, rgb and depth rounded to bf16 (~0.4%). It is not
    differentiable: the outputs carry no graph, and the flow output is
    zeros."""
    with torch.set_grad_enabled(torch.is_grad_enabled() and not infer):
        proc, bins, rec = blend_inputs(
            means3d=means3d, t=t, scales=scales, scales_t=scales_t,
            rotations=rotations, rotations_r=rotations_r, opacity=opacity,
            sh=sh, active=active, camera=camera, opts=opts, sh_mask=sh_mask,
            mean2d_tap=mean2d_tap, colors_precomp=colors_precomp,
            cov3d_precomp=cov3d_precomp, mark=mark, infer=infer)
        if infer:
            accum, t_final = blend_lib.blend_infer(
                rec, bins.gauss_id, bins.tile_start, bins.tile_count,
                opts.tiles_x)
            color, depth, alpha = blend_lib.assemble_outputs_infer(
                accum, t_final, bg, opts)
            flow = torch.zeros((opts.height, opts.width, 2),
                               dtype=torch.float32, device=color.device)
        else:
            color, depth, flow, alpha = blend_lib.Blend.apply(
                rec, bg, bins, opts)
    if mark:
        mark("blend")
    return RenderOutputs(
        color=color, depth=depth, alpha=alpha, flow=flow,
        radii=proc.radius, visible=proc.visible,
        num_rendered=bins.num_rendered, max_per_tile=bins.max_per_tile,
        instances_dropped=bins.dropped, cov3d_com=proc.cov3d)


def mark_visible(means3d: torch.Tensor, viewmatrix: torch.Tensor,
                 projmatrix: torch.Tensor | None = None) -> torch.Tensor:
    """True where the point sits in front of the near plane (view-space
    z > 0.2). The projection matrix is accepted for signature parity with
    the reference's `markVisible`, whose NDC bound check is commented out
    (`auxiliary.h:140-163`)."""
    del projmatrix
    return gm.view_z(means3d, viewmatrix) > gm.NEAR_PLANE


class GaussianRenderer(nn.Module):
    """Serves renders of one trained cloud: activate → render → clip."""

    def __init__(self, model: GaussianModel, opts: RenderOptions,
                 bg=(0.0, 0.0, 0.0), infer: bool = False):
        super().__init__()
        self.model = model
        self.opts = opts
        self.infer = infer    # the packed inference blend (kernel K3)
        self.register_buffer("bg", torch.as_tensor(
            bg, dtype=torch.float32, device=model.xyz.device))

    @classmethod
    def from_checkpoint(cls, path: str, opts: RenderOptions,
                        bg=(0.0, 0.0, 0.0), device="cuda",
                        infer: bool = False):
        gauss, _, _, _ = load_checkpoint(path, device=device)
        return cls(GaussianModel(gauss.params, int(gauss.n_active)), opts,
                   bg, infer)

    @torch.no_grad()
    def forward(self, camera: CameraArrays,
                mark: Callable[[str], None] | None = None):
        """Returns (color (H,W,3) clipped to [0, 1], depth (H,W),
        alpha (H,W), num_rendered, max_per_tile, instances_dropped).
        `mark` as in `render`."""
        act = self.model.activate()
        out = render(**act._asdict(), camera=camera, bg=self.bg,
                     opts=self.opts, infer=self.infer, mark=mark)
        return (torch.clamp(out.color, 0.0, 1.0), out.depth, out.alpha,
                out.num_rendered, out.max_per_tile, out.instances_dropped)
