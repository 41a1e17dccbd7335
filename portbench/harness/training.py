"""Drives the program's training loop, `Trainer.train`, through one run of
a training cell: the check steps that the reference follows, the warm-up,
and the measured window; in a traced run a second window with CUDA events
at the step's stage marks and a third under the profiler.

Everything the program is handed (the scene, the state at the traffic's
start iteration) comes from `scene.make_data`; the window is timed from
`on_step`, which the Trainer calls after each whole step.
"""

from __future__ import annotations

import os
import shutil
import time
from typing import NamedTuple

import numpy as np
import torch

from harness.scene import Data, ground_truth
from reference.gs4d import ADAM_B1, LEAVES

# Stage of each of train_step's marks (the interval that ends at it).
STEP_STAGES = {"preprocess": "render", "binning": "render", "blend": "render",
               "loss": "loss", "knn": "knn",
               "blend_backward_start": "backward",
               "blend_backward": "backward", "backward": "backward",
               "update": "update", "end": "metrics"}


class StopWindow(Exception):
    """Raised from `on_step` to leave `Trainer.train` when a window ends."""


class CheckReadings(NamedTuple):
    """What the program produced in the check steps: each step's loss, the
    first step's gradient norm per leaf (from Adam's first moment) and the
    norm of each leaf's change over the check steps."""
    losses: list
    grad_norms: dict
    change_norms: dict
    batches: list           # the train-frame indices of each check step


class RunResult(NamedTuple):
    setup_s: float
    window_s: float
    steps: int
    memory_window: int      # peak allocated bytes over the window
    memory_run: int         # peak allocated bytes of the run so far
    finite: bool            # the state after the window is finite
    check: CheckReadings
    step_s: list            # traced: per-step host seconds, synchronised
    stages: list            # traced: per-step {stage: ms}
    profile: object         # traced: harness.trace.Profile
    kernel_args: list       # traced: K1's and K2's inputs of check step 1


def program_config(config: dict, seed: int, model_dir: str):
    """The program's TrainConfig from the configuration's YAML content, its
    seed (the batch order's) from the run's."""
    from fourdgs_tpu_torch.config import load_config

    raw = config["config"]
    groups = {"ModelParams": "model", "PipelineParams": "pipeline",
              "OptimizationParams": "optimization"}
    over = {groups.get(k, k): v for k, v in raw.items()}
    cfg = load_config(overrides=over)
    cfg.model.model_path = model_dir
    cfg.seed = int(seed) % (1 << 31)
    return cfg


def program_scene(data: Data, cfg):
    """The SceneInfo the scene loader would give for `data`'s train split:
    Blender frames with their images in memory, N3V frames as lazy
    cameras on their PNG files. No test split (this traffic never
    evaluates); the initial point cloud is a 4-point placeholder, since
    the run's state is installed in its place."""
    from fourdgs_tpu_torch.data.cameras import Camera
    from fourdgs_tpu_torch.data.pointcloud import PointCloud
    from fourdgs_tpu_torch.data.scene import SceneInfo, nerfpp_norm

    cams = []
    for i, fr in enumerate(data.frames):
        p = fr.pose
        kw = dict(uid=i, rot=p.rot, trans=p.trans, fovx=p.fovx, fovy=p.fovy,
                  width=p.width, height=p.height, timestamp=p.timestamp,
                  image_name=fr.name, cx=p.cx, cy=p.cy, fl_x=p.fl_x,
                  fl_y=p.fl_y)
        if fr.image >= 0:
            cams.append(Camera(image=data.images[fr.image],
                               alpha_mask=data.alphas[fr.image], **kw))
        else:
            cams.append(Camera(image_path=fr.path, meta_only=True, **kw))
    translate, radius = nerfpp_norm(cams)
    pts = np.eye(4, 3, dtype=np.float32)
    pcd = PointCloud(points=pts, colors=np.full((4, 3), 0.5, np.float32),
                     normals=np.zeros((4, 3), np.float32))
    return SceneInfo(point_cloud=pcd, train_cameras=cams, test_cameras=[],
                     translate=translate, radius=radius, ply_path="")


def install_state(trainer, data: Data, traffic: dict, device):
    """The run's state at the traffic's start iteration in the Trainer's
    place, as a resumed checkpoint would set it: the gaussians with Adam
    moments zero at count `adam_count`, the environment map at its last
    optimised step."""
    from fourdgs_tpu_torch.models.envmap import EnvMapState
    from fourdgs_tpu_torch.models.gaussians import (AdamState, GaussianParams,
                                                    GaussianState)

    params = GaussianParams(**data.params)
    p = params.xyz.shape[0]
    zeros = lambda: GaussianParams(*(torch.zeros_like(x)  # noqa: E731
                                     for x in params))
    acc = lambda: torch.zeros(p, dtype=torch.float32,  # noqa: E731
                              device=device)
    trainer._set_cloud(GaussianState(
        params=params,
        adam=AdamState(zeros(), zeros(), torch.tensor(
            traffic["adam_count"], dtype=torch.int64, device=device)),
        n_active=torch.tensor(p, device=device),
        xyz_grad_accum=acc(), t_grad_accum=acc(), denom=acc(),
        max_radii2d=acc()))
    if data.env is not None:
        z = torch.zeros_like(data.env)
        trainer.env = EnvMapState(data.env.clone(), z, z.clone(), torch.tensor(
            trainer.cfg.pipeline.env_optimize_until, dtype=torch.int64,
            device=device))
    trainer.step = traffic["start_iteration"]


class StageMarks:
    """CUDA events (on the CPU, host clock readings) at train_step's marks,
    summed by stage per step; "blend_backward" is the time from the first
    blend backward to the end of the backward."""

    def __init__(self, cuda: bool):
        self.cuda = cuda
        self.events = []
        self.steps = []

    def mark(self, name="end"):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
        else:
            ev = time.perf_counter()
        self.events.append((name, ev))

    def _ms(self, a, b):
        return a.elapsed_time(b) if self.cuda else (b - a) * 1e3

    def close_step(self):
        """The finished step's ms by stage (the device has passed every
        event: the caller synchronised)."""
        out = dict.fromkeys(dict.fromkeys(STEP_STAGES.values()), 0.0)
        for (_, a), (name, b) in zip(self.events, self.events[1:]):
            out[STEP_STAGES[name]] += self._ms(a, b)
        names = [n for n, _ in self.events]
        if "blend_backward_start" in names and "backward" in names:
            i = names.index("blend_backward_start")
            j = names.index("backward")
            out["blend_backward"] = self._ms(self.events[i][1],
                                             self.events[j][1])
        self.steps.append(out)
        self.events = []


def run_cell(config: dict, traffic: dict, data: Data, seed: int,
             seconds: float, trace: bool, device, work_dir: str,
             t_process: float, log=lambda line: None
             ) -> tuple[dict, RunResult]:
    """One run: build the Trainer on `data`, take the check steps, warm up,
    measure `seconds`; with `trace`, in its place a window of stage marks
    (at least `seconds` and the traffic's marks_min_steps steps, so that
    the step time's 95th percentile has ten steps beyond it) and one of
    profile_steps steps under the profiler. Returns (the state the run
    started from, as host tensors; what was measured and read).
    `data.params` is emptied. `log` takes the set-up's milestones."""
    from fourdgs_tpu_torch.engine import trainer as trainer_mod
    from fourdgs_tpu_torch.ops import blend

    model_dir = os.path.join(work_dir, "model")
    shutil.rmtree(model_dir, ignore_errors=True)
    cfg = program_config(config, seed, model_dir)
    trainer = trainer_mod.Trainer(cfg, scene=program_scene(data, cfg),
                                  device=device, verbose=False)
    install_state(trainer, data, traffic, device)
    log(f"trainer built at {time.perf_counter() - t_process:.3f} s")
    p0 = trainer.gauss.params
    # The reference starts from a host copy; the device holds no second
    # copy of the state through the window.
    p0_host = {k: v.cpu() for k, v in data.params.items()}
    data.params.clear()

    batches = []
    epoch_batches = trainer._epoch_batches

    def recorded_batches():
        for idx in epoch_batches():
            batches.append(list(idx))
            yield idx
    trainer._epoch_batches = recorded_batches

    kernel_args = []
    if trace:
        def keep(args, out):
            kernel_args.append(args)
        blend.blend_forward.observer = keep
        blend.blend_backward.observer = keep

    n_check = traffic["check_steps"]
    n_warm = traffic["warmup_steps"]
    n_prof = traffic["profile_steps"]
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    marks = StageMarks(cuda)
    step_train = trainer_mod.train_step

    def marked_step(*a, **kw):
        marks.mark("start")
        return step_train(*a, mark=marks.mark, **kw)
    st = dict(phase="check", losses=[], t0=0.0, steps=0, step_s=[],
              profile=None, p0=p0)
    del p0
    readings = {}

    def on_step(it, metrics):
        k = it - traffic["start_iteration"]
        if st["phase"] == "check":
            st["losses"].append(float(metrics.loss))
            if k == 1:
                blend.blend_forward.observer = None
                blend.blend_backward.observer = None
                mu = trainer.gauss.adam.mu
                readings["grad"] = {
                    f: float(torch.linalg.vector_norm(getattr(mu, f)))
                    / (1.0 - ADAM_B1) for f in LEAVES}
            if k == n_check:
                readings["change"] = {
                    f: float(torch.linalg.vector_norm(
                        getattr(trainer.gauss.params, f)
                        - getattr(st["p0"], f)))
                    for f in LEAVES}
                st["p0"] = None
                st["phase"] = "warmup"
                log(f"check steps done at "
                    f"{time.perf_counter() - t_process:.3f} s")
        if st["phase"] == "warmup" and k == n_check + n_warm:
            sync()
            readings["memory_run"] = (torch.cuda.max_memory_allocated()
                                      if cuda else 0)
            if cuda:
                torch.cuda.reset_peak_memory_stats()
            st["setup_s"] = time.perf_counter() - t_process
            st["t0"] = st["t_last"] = time.perf_counter()
            if trace:
                st["phase"] = "marks"
                trainer_mod.train_step = marked_step
            else:
                st["phase"] = "window"
            return
        if st["phase"] == "window":
            st["steps"] += 1
            if time.perf_counter() - st["t0"] >= seconds:
                sync()
                st["window_s"] = time.perf_counter() - st["t0"]
                raise StopWindow
            return
        if st["phase"] == "marks":
            sync()
            now = time.perf_counter()
            st["step_s"].append(now - st["t_last"])
            st["t_last"] = now
            marks.mark()
            marks.close_step()
            st["steps"] += 1
            if (now - st["t0"] >= seconds
                    and st["steps"] >= traffic["marks_min_steps"]):
                st["window_s"] = now - st["t0"]
                trainer_mod.train_step = step_train
                from harness.trace import Profiler
                st["profile"] = Profiler(cuda)
                st["phase"], st["prof_steps"] = "profile", 0
                st["profile"].start()
            return
        if st["phase"] == "profile":
            st["prof_steps"] += 1
            st["steps"] += 1
            if st["prof_steps"] == n_prof:
                sync()
                st["profile"].stop(n_prof)
                raise StopWindow

    try:
        trainer.train(num_iterations=cfg.optimization.iterations,
                      on_step=on_step)
    except StopWindow:
        pass
    finally:
        trainer_mod.train_step = step_train
        blend.blend_forward.observer = None
        blend.blend_backward.observer = None
    if st["phase"] != ("profile" if trace else "window"):
        raise RuntimeError("the training loop ended before the window")
    sync()
    memory_window = torch.cuda.max_memory_allocated() if cuda else 0
    finite = all(bool(torch.isfinite(x).all()) for x in trainer.gauss.params)
    trainer.close()
    del trainer
    return p0_host, RunResult(
        setup_s=st["setup_s"], window_s=st["window_s"],
        steps=st["steps"], memory_window=memory_window,
        memory_run=max(readings["memory_run"], memory_window), finite=finite,
        check=CheckReadings(st["losses"][:n_check], readings["grad"],
                            readings["change"], batches[:n_check]),
        step_s=st["step_s"], stages=marks.steps, profile=st["profile"],
        kernel_args=kernel_args)


def reference_inputs(config: dict, data: Data, batches: list, device,
                     dtype):
    """Per check step, [(camera tensors, ground truth)] of its frames,
    worked out by the reference from the run's data."""
    from reference.gs4d import camera_tensors

    white = config["config"]["ModelParams"]["white_background"]
    out = []
    for idx in batches:
        step = []
        for i in idx:
            fr = data.frames[i]
            gt, _ = ground_truth(data, fr, white)
            step.append((camera_tensors(fr.pose, device, dtype),
                         torch.as_tensor(gt, device=device).to(dtype)))
        out.append(step)
    return out


def run_reference(config: dict, traffic: dict, data: Data, p0_host: dict,
                  batches: list, device, dtype=torch.float32) -> dict:
    """The reference's readings of the check steps, at `dtype`."""
    from reference.gs4d import scene_radius, train_steps

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = config["config"]
    white = cfg["ModelParams"]["white_background"]
    bg = torch.full((3,), 1.0 if white else 0.0, device=device, dtype=dtype)
    params = {k: v.to(device).to(dtype) for k, v in p0_host.items()}
    env = None if data.env is None else data.env.to(dtype)
    radius = scene_radius([fr.pose for fr in data.frames])
    return train_steps(params, reference_inputs(config, data, batches, device,
                                                dtype),
                       cfg, traffic["start_iteration"], traffic["adam_count"],
                       radius, bg, env=env)

