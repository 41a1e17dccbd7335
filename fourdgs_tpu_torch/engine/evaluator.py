"""Evaluation and serving of a trained checkpoint: scene setup, the eval
renderer, ground-truth fetch and the PSNR / SSIM / MS-SSIM report.

PyTorch counterpart of the evaluation half of `fourdgs_tpu/engine/
trainer.py` (`Trainer.load`, `_make_eval_render.eval_fn`, `render_view`,
`render_arrays`, `evaluate`; reference training_report, `train.py:302-342`).
The JAX trainer renders inside static instance budgets and regrows them on
overflow; the port sizes each render's instance list from the true count,
so a render is never truncated and there is nothing to regrow. Training
(densification, cadence, checkpoints of a run) is `engine/trainer.py`'s
`Trainer`, a subclass.
"""

from __future__ import annotations

import math
import os
from typing import Callable, Optional

import numpy as np
import torch

from ..config import TrainConfig
from ..data.cameras import Camera
from ..data.scene import (SceneInfo, load_image_composited, load_scene,
                          resize_image)
from ..models import envmap as envmap_lib
from ..models.gaussians import activate
from ..ops import gaussmath as gm
from ..ops import sh as shlib
from ..ops.preprocess import CameraArrays, RenderOptions
from ..render import render
from ..utils import losses as loss_lib
from . import checkpoint as ckpt_lib


def camera_intrinsics(cam: Camera) -> np.ndarray:
    """[fl_x, fl_y, cx, cy] with fov fallback (for env-map rays)."""
    if cam.fl_x > 0:
        return np.array([cam.fl_x, cam.fl_y, cam.cx, cam.cy], np.float32)
    fl_x = cam.width / (2 * math.tan(cam.fovx / 2))
    fl_y = cam.height / (2 * math.tan(cam.fovy / 2))
    return np.array([fl_x, fl_y, cam.width / 2, cam.height / 2], np.float32)


def fetch_gt(cam: Camera, white_background: bool):
    """(image (H,W,3), alpha (H,W)) numpy arrays for one camera; lazy
    cameras load + composite + resize here (reference
    CameraDataset.__getitem__, `utils/data_utils.py:16-34`). The reference
    multiplies the gt image by the alpha mask when one exists
    (`scene/cameras.py:53-56`)."""
    if cam.image is not None:
        img, alpha = cam.image, cam.alpha_mask
    else:
        img, alpha = load_image_composited(cam.image_path, white_background)
        img = resize_image(img, (cam.width, cam.height))
        if alpha is not None:
            alpha = resize_image(alpha, (cam.width, cam.height))
    if alpha is not None:
        img = img * alpha[..., None]
    else:
        alpha = np.ones(img.shape[:2], np.float32)
    return img.astype(np.float32), alpha.astype(np.float32)


class Evaluator:
    """Renders and scores the views of a scene from a loaded checkpoint.

    `cfg` as `load_config` gives it; `scene` is read from
    `cfg.model.source_path` unless given. Everything runs on `device`.
    `eval_infer` switches the renders to the forward-only packed path
    (kernel K3 on a CUDA device): ~0.4% bf16 rounding of opacity, colour
    and depth. Renders run under `torch.no_grad()` and are not
    differentiable.
    """

    def __init__(self, cfg: TrainConfig, scene: Optional[SceneInfo] = None,
                 device="cuda", verbose: bool = True):
        if cfg.strips > 1:
            raise NotImplementedError(
                "cfg.strips > 1 renders one frame across devices; the "
                "multi-device modules (parallel/) are not ported yet "
                "(ROADMAP.md, Queue 1)")
        self.cfg = cfg
        self.device = torch.device(device)
        self.verbose = verbose

        self.time_duration = list(cfg.time_duration)
        if cfg.model.frame_ratio > 1:
            self.time_duration = [t / cfg.model.frame_ratio
                                  for t in self.time_duration]
        if scene is None:
            scene = load_scene(
                cfg.model.source_path,
                images=cfg.model.images,
                white_background=cfg.model.white_background,
                eval_holdout=cfg.model.eval,
                extension=cfg.model.extension,
                num_pts=cfg.num_pts,
                num_pts_ratio=cfg.num_pts_ratio,
                time_duration=self.time_duration,
                num_extra_pts=cfg.model.num_extra_pts,
                frame_ratio=cfg.model.frame_ratio,
                dataloader=cfg.model.dataloader,
                resolution=cfg.model.resolution,
                seed=cfg.seed)
        self.scene = scene

        cam0 = scene.train_cameras[0]
        self.opts = RenderOptions(
            height=cam0.height, width=cam0.width,
            gaussian_dim=cfg.gaussian_dim, rot_4d=cfg.rot_4d,
            force_sh_3d=cfg.force_sh_3d,
            time_duration=float(self.time_duration[1]
                                - self.time_duration[0]),
            prefilter_var=cfg.model.prefilter_var)
        self.bg = torch.tensor(
            [1.0, 1.0, 1.0] if cfg.model.white_background
            else [0.0, 0.0, 0.0], dtype=torch.float32, device=self.device)

        self.gauss = None          # GaussianState, set by `load`
        self.n_active = 0          # its active count, as a host int
        self.env = None            # EnvMapState of the checkpoint, or None
        self.step = 0
        self.best_psnr = 0.0
        self.eval_infer = False
        # num_rendered, max_per_tile, instances_dropped of the last render.
        self.last_counts = None
        # Mean metrics per split of the last `evaluate`.
        self.last_eval = {}

    def log(self, msg: str):
        if self.verbose:
            print(f"[fourdgs] {msg}", flush=True)

    def load(self, path: str) -> dict:
        """Load a `.pkl` checkpoint written by this package or by the JAX
        package onto the evaluator's device. Returns the checkpoint's
        `extra` dict."""
        if path.endswith(".pth"):
            raise NotImplementedError(
                "reference .pth checkpoints need models/torch_import.py, "
                "which is not ported yet (ROADMAP.md, Queue 1 item 8)")
        self.gauss, self.env, self.step, extra = ckpt_lib.load_checkpoint(
            path, device=self.device)
        self.n_active = int(self.gauss.n_active)
        self.best_psnr = extra.get("best_psnr", 0.0)
        return extra

    @torch.no_grad()
    def _render_eval(self, cam: CameraArrays, intr: torch.Tensor,
                     mark: Callable[[str], None] | None = None):
        """One eval render (`_make_eval_render.eval_fn`, trainer.py:431-505):
        (colour clipped to [0, 1], depth, alpha, num_rendered,
        max_per_tile, instances_dropped)."""
        if self.gauss is None:
            raise RuntimeError("no checkpoint loaded: call load(path) first")
        opts, pipe = self.opts, self.cfg.pipeline
        act = activate(self.gauss.params, self.n_active)
        extra = {}
        means3d, opacity, active = act.means3d, act.opacity, act.active
        # Reference oracle paths (`arguments/__init__.py:72-73`,
        # `gaussian_renderer/__init__.py:73-147`): precompute colour /
        # conditional covariance outside the fused preprocess. For 4D the
        # python path precomputes the conditional covariance and mean
        # offset, folds the temporal marginal into opacity, and prefilters
        # gaussians with marginal <= 0.05 (masked through `active`).
        delta_mean = None
        if pipe.compute_cov3D_python:
            if opts.gaussian_dim == 4 and opts.rot_4d:
                sxyzt = torch.cat([act.scales, act.scales_t[..., None]],
                                  dim=-1)
                cov3, delta_mean, marginal, _ = gm.condition_cov4d_columnar(
                    sxyzt, act.rotations, act.rotations_r, act.t,
                    cam.timestamp)
                means3d = means3d + delta_mean
                extra["cov3d_precomp"] = cov3
            else:
                extra["cov3d_precomp"] = gm.cov3d_columnar(
                    act.scales, act.rotations)
                if opts.gaussian_dim == 4:
                    marginal = gm.marginal_t_separable(
                        act.t, act.scales_t, cam.timestamp)
            if opts.gaussian_dim == 4:
                opacity = opacity * marginal
                active = active & (marginal > 0.05)
        if pipe.convert_SHs_python:
            # The reference python SH path evaluates at the SHIFTED means
            # (`gaussian_renderer/__init__.py:100-104`), unlike its CUDA
            # path (forward.cu:480-487, unshifted).
            if (delta_mean is None and opts.gaussian_dim == 4
                    and opts.rot_4d):
                sxyzt = torch.cat([act.scales, act.scales_t[..., None]],
                                  dim=-1)
                _, delta_mean, _, _ = gm.condition_cov4d_columnar(
                    sxyzt, act.rotations, act.rotations_r, act.t,
                    cam.timestamp)
            shifted = (act.means3d + delta_mean
                       if delta_mean is not None
                       and not pipe.compute_cov3D_python else means3d)
            dirs = shifted - cam.campos
            dirs = dirs / torch.clamp(
                torch.sqrt(torch.sum(dirs * dirs, dim=-1, keepdim=True)),
                min=1e-12)
            if opts.gaussian_dim == 3 or opts.force_sh_3d:
                rgb = shlib.sh_to_rgb(shlib.eval_sh3d(act.sh, dirs))
            else:
                rgb = shlib.sh_to_rgb(shlib.eval_sh4d(
                    act.sh, dirs, act.t - cam.timestamp, opts.time_duration))
            extra["colors_precomp"] = rgb
        out = render(
            means3d=means3d, t=act.t, scales=act.scales,
            scales_t=act.scales_t, rotations=act.rotations,
            rotations_r=act.rotations_r, opacity=opacity, sh=act.sh,
            active=active, camera=cam, bg=self.bg, opts=opts,
            infer=(self.eval_infer and not extra), mark=mark, **extra)
        color = out.color
        if self.env is not None:
            color = envmap_lib.composite_sky(
                color, out.alpha, self.env.texture, cam.viewmatrix, intr)
        color = torch.clamp(color, 0.0, 1.0)
        if mark:
            mark("sky_clip")
        return (color, out.depth, out.alpha, out.num_rendered,
                out.max_per_tile, out.instances_dropped)

    def render_arrays(self, arrays: CameraArrays, intr: torch.Tensor,
                      mark: Callable[[str], None] | None = None):
        """Render raw CameraArrays (the live viewer's MiniCam path,
        reference `scene/cameras.py:91-103`): (color, depth, alpha) on the
        device. `mark` as in `render`, plus "sky_clip"."""
        color, depth, alpha, num_rendered, max_per_tile, dropped = \
            self._render_eval(arrays, intr, mark)
        self.last_counts = dict(num_rendered=num_rendered,
                                max_per_tile=int(max_per_tile),
                                instances_dropped=dropped)
        return color, depth, alpha

    def render_view(self, cam: Camera,
                    mark: Callable[[str], None] | None = None):
        """Render one scene camera: (color, depth, alpha) on the device."""
        intr = torch.as_tensor(camera_intrinsics(cam), device=self.device)
        return self.render_arrays(cam.arrays(self.device), intr, mark)

    def evaluate(self, max_cameras: Optional[int] = None,
                 with_msssim: bool = False, train_views: int = 0,
                 save_panels: bool = False) -> float:
        """PSNR/SSIM(/MS-SSIM) over the test split plus an optional sample
        of train views (reference training_report, `train.py:302-342`,
        which evaluates the full test set + train views 5,10,15,20,25).
        With `save_panels`, writes gt|render|alpha|depth-cmap grids for the
        first 5 views of each split into model_path/eval (reference
        `train.py:320-325`). Returns the mean test PSNR; `last_eval` keeps
        the means of every split evaluated."""
        white = self.cfg.model.white_background
        self.last_eval = {}

        def run(cams, tag):
            psnrs, ssims, msssims = [], [], []
            for i, cam in enumerate(cams):
                color, depth, alpha = self.render_view(cam)
                gt = torch.as_tensor(fetch_gt(cam, white)[0],
                                     device=self.device)
                if save_panels and i < 5 and self.cfg.model.model_path:
                    self._save_eval_panel(tag, i, cam, gt, color, depth,
                                          alpha)
                psnrs.append(float(loss_lib.psnr(color, gt)))
                ssims.append(float(loss_lib.ssim(color, gt)))
                if with_msssim:
                    msssims.append(float(loss_lib.msssim(color[None],
                                                         gt[None])))
            if not psnrs:
                return 0.0
            means = dict(psnr=float(np.mean(psnrs)),
                         ssim=float(np.mean(ssims)))
            msg = (f"eval[{tag}]: psnr {means['psnr']:.3f} "
                   f"ssim {means['ssim']:.4f}")
            if msssims:
                means["msssim"] = float(np.mean(msssims))
                msg += f" ms-ssim {means['msssim']:.4f}"
            self.log(msg + f" ({len(cams)} cams)")
            self.last_eval[tag] = means
            return means["psnr"]

        cams = self.scene.test_cameras
        if max_cameras:
            cams = cams[:max_cameras]
        mean_psnr = run(cams, "test")
        if train_views:
            # Reference samples train views idx % n for idx in 5..25 step 5
            # (`train.py:304`).
            n = len(self.scene.train_cameras)
            idxs = [idx % n for idx in range(5, 5 * (train_views + 1), 5)]
            run([self.scene.train_cameras[i] for i in idxs], "train")
        return mean_psnr

    def _save_eval_panel(self, tag: str, idx: int, cam: Camera, gt, color,
                         depth, alpha):
        """2x2 gt|render / alpha|depth-colormap grid PNG (the reference's
        tensorboard image grid, `train.py:320-325`, as files)."""
        from PIL import Image

        from ..utils.image import easy_cmap
        panels = [torch.clamp(gt, 0, 1), torch.clamp(color, 0, 1),
                  torch.clamp(alpha, 0, 1)[..., None].expand(-1, -1, 3),
                  easy_cmap(depth)]
        top = torch.cat(panels[:2], dim=1)
        bot = torch.cat(panels[2:], dim=1)
        grid = (torch.cat([top, bot], dim=0) * 255).to(torch.uint8)
        out = os.path.join(self.cfg.model.model_path, "eval")
        os.makedirs(out, exist_ok=True)
        name = cam.image_name or str(idx)
        Image.fromarray(grid.cpu().numpy()).save(
            os.path.join(out, f"it{self.step:06d}_{tag}_{name}.png"))
