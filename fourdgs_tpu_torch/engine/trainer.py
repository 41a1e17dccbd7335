"""The training loop: the initial cloud, camera batches, the train step,
density control at the reference cadence, evaluation, checkpoints and
resume.

PyTorch counterpart of the training half of `fourdgs_tpu/engine/
trainer.py` (reference `training()`, `train.py:37-252`), built on the
port's `Evaluator`, which holds the scene, the render options, the eval
renderer and `evaluate`. The JAX trainer renders inside static instance
and cloud capacities and regrows them on overflow; here the instance list
and the cloud take their true size, so `instances_dropped` is 0 by
construction and there is no budget to probe, grow or shrink.
"""

from __future__ import annotations

import json
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..config import TrainConfig, sh_degree_t
from ..data.pointcloud import write_ply
from ..data.scene import SceneInfo
from ..models import densify as dz
from ..models import envmap as envmap_lib
from ..models.gaussians import (AdamState, GaussianParams, GaussianState,
                                init_from_pcd)
from ..ops.sh import num_sh_channels
from ..utils.metrics_log import MetricsLogger
from ..utils.tb_writer import TBWriter
from . import checkpoint as ckpt_lib
from .evaluator import Evaluator, camera_intrinsics, fetch_gt
from .step import StepConfig, train_step


def active_rows(state: GaussianState) -> GaussianState:
    """The state's first n_active rows: a JAX checkpoint's padding rows
    dropped (they are inactive, so training is the same without them)."""
    n = int(state.n_active)

    def cut(tree):
        return type(tree)(*(x[:n] for x in tree))

    return state._replace(
        params=cut(state.params),
        adam=state.adam._replace(mu=cut(state.adam.mu),
                                 nu=cut(state.adam.nu)),
        **{f: getattr(state, f)[:n] for f in GaussianState._fields[3:]})


class Trainer(Evaluator):
    """Trains a scene from a config (`cfg` as `load_config` gives it) on
    `device`; `scene` is read from `cfg.model.source_path` unless given.

    Under an open process group (`parallel/multihost.py:initialize`, one
    rank per device), every rank builds the same Trainer and draws the
    same batches; the cloud starts as rank 0's on every rank, and the
    step runs data-parallel over the group's ranks (`parallel/mesh.py`),
    a camera's strips spread over them, and so do a view's strips where
    they divide (JAX `fourdgs_tpu/engine/trainer.py:547-561`). That needs
    cfg.data_axis 0 or the world size and batch_size·strips divisible by
    the world (the JAX trainer's rule, `:403-405`); a group of more than
    one rank that breaks it raises ValueError, as each rank would
    otherwise train a replica of its own. Only rank 0 writes:
    checkpoints, metrics.jsonl, TensorBoard events, panels and its log
    lines. Without a group, strips render as the full frame, which they
    equal."""

    def __init__(self, cfg: TrainConfig, scene: Optional[SceneInfo] = None,
                 device="cuda", verbose: bool = True):
        world = dist.get_world_size() if dist.is_initialized() else 1
        n_dev = min(cfg.data_axis or world, world)
        if n_dev != world or (cfg.batch_size * cfg.strips) % world:
            raise ValueError(
                f"{world} ranks train data-parallel only with data_axis 0 "
                f"or {world} and batch_size*strips divisible by {world}; "
                f"got data_axis {cfg.data_axis}, batch_size*strips "
                f"{cfg.batch_size * cfg.strips}")
        self.is_writer = world == 1 or dist.get_rank() == 0
        super().__init__(cfg, scene=scene, device=device,
                         verbose=verbose and self.is_writer)
        opt = cfg.optimization
        self.spatial_lr_scale = float(self.scene.radius)
        sh_channels = num_sh_channels(cfg.model.sh_degree, sh_degree_t(cfg),
                                      cfg.gaussian_dim, cfg.force_sh_3d)
        pcd = self.scene.point_cloud
        self.gauss = init_from_pcd(
            pcd.points, pcd.colors, sh_channels=sh_channels,
            time_duration=tuple(self.time_duration), times=pcd.times,
            seed=cfg.seed, device=self.device)
        self.n_active = int(self.gauss.n_active)
        self.env = (envmap_lib.init_envmap(cfg.pipeline.env_map_res,
                                           device=self.device)
                    if cfg.pipeline.env_map_res > 0 else None)
        # Batch order (numpy, as the JAX trainer draws it) and split noise.
        self.rng = np.random.default_rng(cfg.seed)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(cfg.seed)

        self.step_cfg = StepConfig(
            lambda_dssim=opt.lambda_dssim,
            lambda_opa_mask=opt.lambda_opa_mask,
            lambda_rigid=opt.lambda_rigid,
            lambda_motion=opt.lambda_motion,
            position_lr_init=opt.position_lr_init,
            position_lr_final=opt.position_lr_final,
            position_lr_delay_mult=opt.position_lr_delay_mult,
            position_lr_max_steps=opt.position_lr_max_steps,
            position_t_lr_init=opt.position_t_lr_init,
            feature_lr=opt.feature_lr,
            opacity_lr=opt.opacity_lr,
            scaling_lr=opt.scaling_lr,
            rotation_lr=opt.rotation_lr,
            spatial_lr_scale=self.spatial_lr_scale,
            sh_increase_interval=opt.sh_increase_interval,
            sh_degree=cfg.model.sh_degree,
            sh_degree_t=sh_degree_t(cfg),
            env_map_res=cfg.pipeline.env_map_res,
            env_optimize_from=cfg.pipeline.env_optimize_from,
            env_optimize_until=cfg.pipeline.env_optimize_until,
            iterations=opt.iterations)
        self.densify_cfg = dz.DensifyConfig(
            grad_threshold=opt.densify_grad_threshold,
            min_opacity=opt.thresh_opa_prune,
            percent_dense=opt.percent_dense)

        self._io_pool = ThreadPoolExecutor(max_workers=8)
        # One worker, so that queued writes to one path land in order.
        self._ckpt_pool = ThreadPoolExecutor(max_workers=1)
        self._saves = []
        self._gt_cache = None      # (images, alphas) on the device
        self.metrics_log = MetricsLogger(cfg.model.model_path
                                         if self.is_writer else None)
        # TensorBoard event file in the model dir (the reference's
        # SummaryWriter(args.model_path), `train.py:255-263`): the step
        # scalars here, the evaluation scalars, histogram and panels in
        # `Evaluator.evaluate`.
        if cfg.model.model_path and self.is_writer:
            self.tb = TBWriter(cfg.model.model_path)
            self._dump_scene_artifacts()
        if cfg.model.loaded_pth:
            self._load_initial_cloud(cfg.model.loaded_pth)
        if cfg.start_checkpoint:
            self.load(cfg.start_checkpoint)
        if dist.is_initialized():
            self._join_mesh()

    def _join_mesh(self):
        """Rank 0's cloud and env map on every rank, and the data axis over
        the group's ranks."""
        from ..parallel import make_mesh, replicate

        self.mesh = make_mesh()
        state = [x for tree in (self.gauss.params, self.gauss.adam.mu,
                                self.gauss.adam.nu) for x in tree]
        state += [self.gauss.adam.count] + list(self.gauss[2:])
        if self.env is not None:
            state += list(self.env)
        replicate(self.mesh, state)
        self.n_active = int(self.gauss.n_active)
        self.log(f"data-parallel train step over {self.mesh.size} ranks"
                 + (f" ({self.cfg.strips} strips/frame)"
                    if self.cfg.strips > 1 else ""))

    def close(self):
        """Join the checkpoint writes, stop both worker pools and close
        metrics.jsonl and the TensorBoard event file."""
        try:
            self.wait_for_saves()
        finally:
            self._io_pool.shutdown(cancel_futures=True)
            self._ckpt_pool.shutdown()
            self.metrics_log.close()
            if self.tb is not None:
                self.tb.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _set_cloud(self, state: GaussianState):
        self.gauss = active_rows(state)
        self.n_active = int(self.gauss.n_active)

    def _load_initial_cloud(self, path: str):
        """Parameters from a saved cloud (reference --loaded_pth →
        create_from_pth, `gaussian_model.py:302-329`): a gaussian PLY, a
        reference torch checkpoint or a checkpoint; the optimizer starts
        fresh."""
        if path.endswith(".pth"):
            from ..models.torch_import import import_reference_pth
            dur = self.cfg.time_duration[1] - self.cfg.time_duration[0]
            self._set_cloud(import_reference_pth(
                path, duration=dur, with_optimizer=False,
                device=self.device)[0])
        elif path.endswith(".ply"):
            from ..models.ply_io import import_gaussians_ply
            self._set_cloud(import_gaussians_ply(path, device=self.device))
        else:
            gauss = ckpt_lib.load_checkpoint(path, device=self.device)[0]
            zeros = lambda: GaussianParams(*(  # noqa: E731
                torch.zeros_like(x) for x in gauss.params))
            self._set_cloud(gauss._replace(adam=AdamState(
                zeros(), zeros(), torch.zeros((), dtype=torch.int64,
                                              device=self.device))))
        self.log(f"initialized cloud from {path} ({self.n_active} gaussians)")

    def _dump_scene_artifacts(self):
        """input.ply + cameras.json into the model dir (reference
        Scene.__init__, `scene/__init__.py:55-72`)."""
        out = self.cfg.model.model_path
        os.makedirs(out, exist_ok=True)
        pcd = self.scene.point_cloud
        if pcd is not None:
            write_ply(os.path.join(out, "input.ply"), pcd.points,
                      pcd.colors * 255.0, times=pcd.times)
        cams = []
        for i, c in enumerate(self.scene.train_cameras):
            c2w = np.linalg.inv(c.viewmatrix)
            intr = camera_intrinsics(c)
            cams.append({
                "id": i, "img_name": c.image_name,
                "width": c.width, "height": c.height,
                "position": c2w[:3, 3].tolist(),
                "rotation": c2w[:3, :3].tolist(),
                "fx": float(intr[0]), "fy": float(intr[1]),
                "timestamp": c.timestamp,
            })
        with open(os.path.join(out, "cameras.json"), "w") as f:
            json.dump(cams, f)

    # ------------------------------------------------------------------ IO
    def save(self, path: str, sync: bool = True):
        """Checkpoint to `path` (rank 0 only under a process group). The
        device → host copy happens here; with sync=False pickling and the
        disk write run on a background worker (in submission order) that
        `wait_for_saves` joins."""
        if not self.is_writer:
            return
        fut = ckpt_lib.save_checkpoint(
            path, self.gauss, self.env, self.step,
            extra={"best_psnr": self.best_psnr,
                   # batch order and split noise → bit-exact resume
                   "np_rng_state": self.rng.bit_generator.state,
                   "torch_rng_state":
                       self.generator.get_state().numpy().copy()},
            io_pool=None if sync else self._ckpt_pool)
        if fut is not None:
            self._saves.append(fut)

    def wait_for_saves(self):
        """Join the queued background checkpoint writes; a failed write
        raises here."""
        saves, self._saves = self._saves, []
        for fut in saves:
            fut.result()

    def load(self, path: str) -> dict:
        """Resume from a `.pkl` checkpoint of this package or of the JAX
        package's trainer: params, Adam, statistics, env map, step,
        best_psnr and the batch-order state; the split noise's generator
        state where this package wrote it (a JAX checkpoint's `jax_key`
        has no counterpart and is ignored). A reference `.pth` gives
        params, Adam, statistics, iteration and the env map's texture
        (`Evaluator._load_reference_pth`)."""
        extra = super().load(path)
        self._set_cloud(self.gauss)
        if "np_rng_state" in extra:
            self.rng.bit_generator.state = extra["np_rng_state"]
        if "torch_rng_state" in extra:
            self.generator.set_state(torch.from_numpy(
                np.asarray(extra["torch_rng_state"], np.uint8)))
        return extra

    # ---------------------------------------------------------- batching
    def _batch_arrays(self, idx: List[int]):
        """(cameras, gt, alpha, intrinsics (B, 4)) of train cameras `idx`;
        with the GT cache, gt is the index list and alpha None. With
        cfg.strips > 1 under a process group, the step cuts each camera
        into its strips itself (the JAX trainer expands them here,
        `trainer.py:333-344`)."""
        cams = [self.scene.train_cameras[i] for i in idx]
        if self._gt_cache is not None:
            gt, alpha = idx, None
        else:
            white = self.cfg.model.white_background
            gts = list(self._io_pool.map(lambda c: fetch_gt(c, white), cams))
            gt = torch.as_tensor(np.stack([g[0] for g in gts]),
                                 device=self.device)
            alpha = torch.as_tensor(np.stack([g[1] for g in gts]),
                                    device=self.device)
        intr = torch.as_tensor(np.stack([camera_intrinsics(c) for c in cams]),
                               device=self.device)
        return [c.arrays(self.device) for c in cams], gt, alpha, intr

    def _maybe_build_gt_cache(self):
        """The train images on the device once (fetch_gt's composited,
        masked f32 outputs), so that a step gathers its batch there
        instead of decoding and uploading images. Skipped when frames
        differ in size or the set exceeds cfg.gt_cache_mb (0 disables)."""
        if self._gt_cache is not None or self.cfg.gt_cache_mb <= 0:
            return
        cams = self.scene.train_cameras
        if not cams:
            return
        w, h = cams[0].width, cams[0].height
        if any(c.width != w or c.height != h for c in cams):
            return
        total_mb = len(cams) * h * w * 16 / 1e6   # f32 rgb + alpha
        if total_mb > self.cfg.gt_cache_mb:
            return
        white = self.cfg.model.white_background
        gts = list(self._io_pool.map(lambda c: fetch_gt(c, white), cams))
        self._gt_cache = tuple(
            torch.as_tensor(np.stack([g[k] for g in gts]), device=self.device)
            for k in (0, 1))
        self.log(f"GT cache: {len(cams)} frames ({total_mb:.0f} MB) on "
                 f"{self.device}")

    def _epoch_batches(self):
        n = len(self.scene.train_cameras)
        b = self.cfg.batch_size
        order = self.rng.permutation(n)
        for i in range(0, n - b + 1, b):   # drop_last=True (train.py:80)
            yield [int(j) for j in order[i: i + b]]

    def _batch_stream(self):
        """Endless epoch-shuffled batches with one batch of lookahead (the
        reference DataLoader's prefetch, `train.py:80`), so that the
        batch-order state advances as the JAX trainer's does."""
        pending = None
        while True:
            for batch_idx in self._epoch_batches():
                fut = self._io_pool.submit(self._batch_arrays, batch_idx)
                if pending is not None:
                    yield pending.result()
                pending = fut

    # ------------------------------------------------------------ events
    def _densify_event(self, iteration: int) -> dz.DensifyInfo:
        """Clone, split and prune (`trainer.py:702-751`, without
        capacities); the size threshold is on after the first opacity
        reset."""
        opt = self.cfg.optimization
        noise = dz.split_noise(self.gauss.params.xyz.shape[0],
                               self.densify_cfg.split_n, self.cfg.rot_4d,
                               self.cfg.gaussian_dim, self.generator,
                               self.device)
        self.gauss, info = dz.densify_and_prune(
            self.gauss, noise, self.spatial_lr_scale, cfg=self.densify_cfg,
            rot_4d=self.cfg.rot_4d, gaussian_dim=self.cfg.gaussian_dim,
            use_size_threshold=iteration > opt.opacity_reset_interval)
        self.n_active = info.n_active
        self.log(f"densify at it {iteration}: {info.n_cloned} cloned, "
                 f"{info.n_split} split, {info.n_pruned} pruned → "
                 f"{info.n_active} gaussians")
        return info

    # ------------------------------------------------------------- train
    def train(self, num_iterations: Optional[int] = None, on_step=None):
        """Train from `self.step` to `num_iterations` (default the
        config's iterations): the reference loop and cadences
        (`trainer.py:754-912`). `on_step(it, StepMetrics)` is called after
        each step. Returns the final state."""
        opt = self.cfg.optimization
        total = num_iterations or opt.iterations
        test_iters = set(self.cfg.test_iterations)
        if self.cfg.exhaust_test:
            test_iters |= set(range(self.cfg.eval_interval, total + 1,
                                    self.cfg.eval_interval))
        # checkpoint_iterations: an extra save list (both write chkpnt{it},
        # as the reference Scene.save, `scene/__init__.py:91-92`).
        save_iters = (set(self.cfg.save_iterations)
                      | set(self.cfg.checkpoint_iterations))
        model_path = self.cfg.model.model_path
        debug = self.cfg.pipeline.debug

        self._maybe_build_gt_cache()
        t_start = time.perf_counter()
        ema_loss = 0.0
        stream = self._batch_stream()
        it = first = self.step
        while it < total:
            it += 1
            cams, gt, alpha, intr = next(stream)
            if alpha is None:             # GT cache: gt holds the indices
                idx = torch.as_tensor(gt, device=self.device)
                gt, alpha = self._gt_cache[0][idx], self._gt_cache[1][idx]
            self.gauss, self.env, metrics = train_step(
                self.gauss, it, cams, gt, alpha, self.bg, self.step_cfg,
                self.opts, env=self.env, intrinsics=intr,
                strips=self.cfg.strips if self.mesh else 1, mesh=self.mesh)
            self.step = it

            # Densification (train.py:231-244). The active count is a host
            # int here at every step, so the point limit is read each time.
            in_window = it < opt.densify_until_iter and (
                opt.densify_until_num_points < 0
                or self.n_active < opt.densify_until_num_points)
            if in_window and (it > opt.densify_from_iter
                              and it % opt.densification_interval == 0):
                self._densify_event(it)
            if in_window and (it % opt.opacity_reset_interval == 0
                              or (self.cfg.model.white_background
                                  and it == opt.densify_from_iter)):
                self.gauss = dz.reset_opacity(self.gauss)

            loss = float(metrics.loss)
            if not np.isfinite(loss) and self.is_writer and (debug or (
                    self.cfg.debug_from >= 0 and it >= self.cfg.debug_from)):
                self._dump_debug_snapshot(it, cams, gt, alpha, intr)
            ema_loss = 0.4 * loss + 0.6 * ema_loss if it > 1 else loss
            if it % 50 == 0 or it == 1:
                dt = time.perf_counter() - t_start
                self.log(f"it {it}/{total} loss {ema_loss:.4f} "
                         f"psnr {float(metrics.psnr):.2f} "
                         f"pts {self.n_active} "
                         f"({(it - first) / max(dt, 1e-9):.2f} it/s)")
            if it % 10 == 0 or it == 1:
                self.metrics_log.log(
                    it, loss=loss, ema_loss=ema_loss, l1=metrics.l1,
                    ssim_loss=metrics.ssim_loss, psnr=metrics.psnr,
                    total_points=metrics.n_active,
                    num_rendered=metrics.num_rendered, rigid=metrics.rigid,
                    motion=metrics.motion)
                if self.tb is not None:
                    self._tb_step_scalars(it, loss, metrics, t_start)
            if on_step is not None:
                on_step(it, metrics)

            if it in test_iters and self.scene.test_cameras:
                psnr = self.evaluate(with_msssim=True, train_views=5,
                                     save_panels=True)
                if psnr >= self.best_psnr:
                    self.best_psnr = psnr
                    if model_path:
                        self.save(os.path.join(model_path,
                                               "chkpnt_best.pkl"),
                                  sync=False)
            if it in save_iters and model_path:
                self.save(os.path.join(model_path, f"chkpnt{it}.pkl"),
                          sync=False)
        self.wait_for_saves()
        return self.gauss

    def _tb_step_scalars(self, it: int, loss: float, metrics, t_start):
        """The reference's step scalars (tag names of `train.py:277-298`);
        iter_time is the mean ms per iteration since `train` started."""
        add = self.tb.add_scalar
        add("train_loss_patches/l1_loss", float(metrics.l1), it)
        add("train_loss_patches/ssim_loss", float(metrics.ssim_loss), it)
        add("train_loss_patches/total_loss", loss, it)
        add("total_points", int(metrics.n_active), it)
        add("iter_time", (time.perf_counter() - t_start) / max(it, 1)
            * 1000.0, it)
        if float(metrics.rigid) > 0:
            add("train_loss_patches/rigid_loss", float(metrics.rigid), it)

    def evaluate(self, max_cameras: Optional[int] = None,
                 with_msssim: bool = False, train_views: int = 0,
                 save_panels: bool = False) -> float:
        """`Evaluator.evaluate`, with the mean test PSNR logged to
        metrics.jsonl; panels from rank 0 only."""
        psnr = super().evaluate(max_cameras, with_msssim, train_views,
                                save_panels and self.is_writer)
        self.metrics_log.log(self.step, eval_psnr=psnr)
        return psnr

    def _dump_debug_snapshot(self, it, cams, gt, alpha, intr):
        """Non-finite-loss input dump (reference snapshot_fw.dump,
        `diff_gaussian_rasterization.py:122-129`)."""
        out = self.cfg.model.model_path or "."
        path = os.path.join(out, f"snapshot_it{it}.npz")
        host = lambda x: x.detach().cpu().numpy()  # noqa: E731
        np.savez(path,
                 **{f"cam_{f}": np.stack([host(getattr(c, f)) for c in cams])
                    for f in cams[0]._fields},
                 gt=host(gt), alpha=host(alpha), intr=host(intr),
                 **{f"param_{f}": host(getattr(self.gauss.params, f))
                    for f in GaussianParams._fields},
                 n_active=self.n_active)
        self.log(f"non-finite loss at it {it}; inputs dumped to {path}")
