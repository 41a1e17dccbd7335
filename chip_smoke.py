#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (fourdgs_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds every CUDA kernel of fourdgs_tpu_torch/csrc/ with nvcc (into
build/kernels/, one nvcc per source, all started together), holds each
kernel against its plain PyTorch version on the card, then serves renders
of the full-width model, takes training steps on it and evaluates a
checkpoint of it from files on disk, trains the lego config end to end,
generates the configs/synth datasets and trains both synth configs
through the port's entry points, renders and trains with each frame as
strips and takes data-parallel steps over a process group of one rank,
and times them:

  1. device   the card's name and power limit (nvidia-smi); no CUDA → exit 1
  2. build    nvcc of every kernel; seconds and ptxas report
  3. kernel   the forward blend kernel K1 vs its plain version on small
              scenes: random, saturated and more than 256 instances deep,
              empty tiles, partial tiles (48x40), thin tilted
              gaussians with opacities near 1/255 where the warp cull's
              margins decide (cull_edges, 48x40), and two strip windows
              (a partial last tile row; the principal point above the
              window); accum within 1e-5 abs,
              T_final within 1e-6 abs, n_contrib equal on >= 99.99% of
              pixels. The packed inference blend K3 vs its plain version
              (the same bounds) and within 1.5e-2 of K1. The backward
              blend kernel K2 vs its plain version on
              the same scenes with random image cotangents (seed 2): the
              per-gaussian gradients within the scale-normalised atol 2e-4
              (|k - p| / max(|p|.max(), 1e-3), per record column; its
              atomics sum in another order on every run)
  4. serve    100k 4D gaussians (rot_4d, 48x3 SH) at 800x800, the workload
              of bench.py, weights from seed 0: GaussianRenderer answers 4
              requests; no dropped instance, finite outputs, one kernel
              launch per request, colour within 1e-4 of the plain blend;
              median ms per frame, its split into the renderer's stages
              (CUDA events at its stage marks), the device's busy share
              from a torch.profiler trace of 8 frames
  5. dynerf   300k gaussians at 1352x1014 (bench.py --dynerf), one view,
              the same checks
  6. train    the lego optimisation (configs/dnerf/lego.yaml: batch 2,
              lambda_dssim 0.2, rigid loss on, its learning rates) on the
              same 100k cloud at 800x800, Adam state zero, two identity-
              pose cameras at t = 0.3 and 0.6, random targets from numpy
              seed 0, steps 5000-5004 (full SH degree): 5 train_steps with
              exactly 2 K1 and 2 K2 launches each, no dropped instance,
              finite loss, gradients and state; K2 held to its plain
              version on the first step's own inputs (atol 2e-4 as
              above); median step ms, its split from CUDA events, and the
              device's busy share from a torch.profiler trace of 2 steps
  7. eval     the evaluation path from files on disk, as a user runs it:
              the 100k cloud saved as a checkpoint, a YAML with
              configs/dnerf/lego.yaml's keys (resolution 1), a
              Blender-format scene of 4 test and 2 train views at 800x800
              whose PNGs are exact (K1) renders of the cloud; then
              `fourdgs_tpu_torch.render_cli` with --fast (the packed
              inference blend K3: 1 K3 and 0 K1 launches per view) and
              without (1 K1, 0 K3): PNGs, metrics.json, PSNR >= 35 / 45 dB
              against the 8-bit ground truth, each fast view within 1.5e-2
              of the exact one, K3 held to its plain version on the first
              view's inputs; per-view and staged ms, K3 and K1 ms, the
              device's busy share from a trace of the 4 views
  8. eval_env one 1352x1014 view of the 300k cloud through Evaluator with a
              500x500 environment map in the checkpoint and the packed
              path: one K3 launch, the sky composite within 1e-6 of a plain
              recomputation, K3 vs plain, K3 ms and bound
  9. viewer   a ViewerServer on a free local port answers one SIBR-format
              request through Evaluator.render_arrays and K3: the bytes
              equal the render's 8-bit image
 10. train_lego the lego config (configs/dnerf/lego.yaml, resolution 2:
              400x400, batch 2, rigid loss, rot_4d) trained end to end
              through `fourdgs_tpu_torch.train.main`, its only changes the
              scene and output paths and LEGO_TRAIN_CUTS as --override:
              300 iterations, densify events at 200 and 300 (the second
              with the size threshold), an opacity reset at 200, evaluation
              and checkpoint at 300; from a Blender-format scene it writes
              (16 train and 4 val 800x800 RGBA K1 renders of the bench
              cloud at the origin, no points3d.ply: lego's 100k random
              points); finite loss and no dropped instance on every step,
              n_active changes at each event, exactly 2 K2 per step and 2
              K1 per step plus one per evaluation view, K1 and K2 held to
              their plain versions on the two cameras of the first step
              after the first event (the tolerances above), test PSNR
              above that of an evaluate() before training; then
              render_cli on chkpnt300.pkl with --fast and without
              (launches as in eval), each val view fast against exact
              (1.5e-2 as in eval) and K3 against its plain version on the
              first; step ms before and after the first event, ms per
              event, evaluate ms
 11. train_synth_quality  configs/synth/quality.yaml, the north-star
              scenario: the ground-truth oracle's frames on the card equal
              to the CPU's with TF32 allowed by the caller (2 poses at
              48x48, points_scale 0.05, white and black, 1e-5); its
              dataset generated on the card through
              `python -m fourdgs_tpu_torch.gen_synth_dataset` (120 train
              and 20 test views at 400x400, 4,670 points, seed 0; seconds
              and ms per frame), then the first 1000 of its 10k iterations
              through `fourdgs_tpu_torch.train.main`, every schedule kept
              (SYNTH_QUALITY_CUTS: the white-background opacity reset at
              500, densify events at 600-1000), evaluations at 500 and
              1000; a finite loss on every step, held-out PSNR >= 26 dB at
              1000, the TensorBoard event file holding the reference's
              tags at the JAX trainer's cadence, launches as in
              train_lego, K1 and K2 held to their plain versions on the
              cameras of step 601, chkpnt1000.pkl through render_cli
              (--fast and exact), every test view fast against exact and
              K3 against its plain version on view 0; steps/s, step ms
              before and after the first event and in stages, ms per
              event, n_active after each, evaluate seconds, PSNR and SSIM
 12. train_synth_dynerf  configs/synth/dynerf_quality.yaml: the DyNeRF
              dataset generated on the card (15 cameras, camera 0 held out,
              400x400; cut to 12 frames per camera and 4 test frames), 200
              iterations as the config is (lazy dataloader, batch 4, the
              128x128 env map trained from 0, opacity-mask, rigid and
              motion losses; SYNTH_DYNERF_CUTS: one densify event at 200);
              a finite loss on every step, held-out PSNR up, the env
              texture moved, rigid and motion terms in metrics.jsonl, the
              GT cache on the device where the JAX trainer's rule puts it,
              K1 and K2 held to their plain versions on the four cameras
              of step 101; step ms and knn's share of a staged step
 13. strips   one frame as horizontal strips (parallel/strips.py: each
              strip rendered as its window of the frame, one kernel
              launch per strip) and the data-parallel step
              (parallel/mesh.py), in a world-size-1 NCCL group of this
              process (strips render as strips where a mesh holds them;
              with no mesh, as the full frame): a. the eval phase's
              800x800 checkpoint through Evaluator with cfg.strips 2 and
              4 (400- and 200-row strips) and the 1352x1014 env-map one
              with 2 and 3 (507 and 338 rows), exact and --fast: the
              joined frame within 2e-5 of the full frame of the same
              path, exactly n K1 (exact) or n K3 (fast) launches per view
              and one with no mesh, fast within 1.5e-2 of exact, ms per
              view beside the full frame's; b. configs/synth/
              quality.yaml on train_synth_quality's dataset with
              --override strips=2 (200-row strips), 200 iterations:
              exactly 2·2 K1 and 2·2 K2 per step, finite loss, held-out
              PSNR up, K1 and K2 held to their plain versions on the four
              strips of step 101, and that step run again as full frames
              (tests/test_parallel.py:117-127's bounds); c. 3 lego steps
              at 800x800 through the sharded step, each held to train_step on the
              same state (1e-6 in each leaf's relative L2 norm, or
              3x train_step's own run-to-run spread), all-reduce
              ms per step from CUDA events
 14. kernels  what the warp-private walks of K1, K2 and K3 visit on these
              inputs (the share of (warp, instance) pairs that passes the
              cull, K2's shuffles and atomics per camera, counted by the
              plain versions), then one
              JSON line per the port's kernel table: launches on the main
              paths, error, time, plain time and the card's bound for the
              work these inputs need

The last line is {"ok": true, "device": {...}}; any failed check exits
non-zero before it. Imports torch, numpy and the port only.
"""

from __future__ import annotations

import json
import os
import shutil
import socket
import subprocess
import sys
import threading
import time
import types

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from fourdgs_tpu_torch import cuda_build, render_cli  # noqa: E402
from fourdgs_tpu_torch.config import load_config  # noqa: E402
from fourdgs_tpu_torch.data.cameras import Camera  # noqa: E402
from fourdgs_tpu_torch.data.scene import (  # noqa: E402
    SceneInfo, load_image_composited)
from fourdgs_tpu_torch.engine import step as train  # noqa: E402
from fourdgs_tpu_torch.engine.checkpoint import save_checkpoint  # noqa: E402
from fourdgs_tpu_torch.engine.evaluator import (  # noqa: E402
    Evaluator, camera_intrinsics)
from fourdgs_tpu_torch.models import envmap, gaussians  # noqa: E402
from fourdgs_tpu_torch.models.gaussians import from_jax_params  # noqa: E402
from fourdgs_tpu_torch.ops import blend  # noqa: E402
from fourdgs_tpu_torch.ops import preprocess as pre  # noqa: E402
from fourdgs_tpu_torch.parallel import multihost  # noqa: E402
from fourdgs_tpu_torch.parallel.strips import strip_windows  # noqa: E402
from fourdgs_tpu_torch.render import (  # noqa: E402
    GaussianRenderer, blend_inputs, render)
from fourdgs_tpu_torch.utils import losses  # noqa: E402
from fourdgs_tpu_torch.utils.tb_writer import read_tags  # noqa: E402
from fourdgs_tpu_torch.viewer import ViewerServer  # noqa: E402

# Published H100 SXM peaks (NVIDIA data sheet, dense, at 700 W).
PEAK_F32_OPS = 67e12        # f32 operations/s outside the tensor cores
PEAK_BYTES = 3.35e12        # HBM bytes/s
# f32 operations of the blend kernels per (pixel, instance) pair, by how
# far the pair goes (the classes of the plain versions' pair counts). All
# three kernels (csrc/blend_forward.cu, blend_backward.cu, blend_infer.cu)
# cull by warp, skip expf under a per-instance threshold and, in K1 and
# K3, share the power's column terms between a thread's two pixels. The
# rule of their counts: a pair is charged what the cheapest scheme now
# known computes for it, and a test that only skips work is charged as if
# its margin were zero, so that no count exceeds what the kernels do.
# Per (warp, instance) pair that a warp tests, `cull_keep` on one lane: the
# four offsets (4), the two nearest (4), two edge minima (12 each), their
# choice and the bound (4), the largest offsets (2) and magnitude (9), the
# conic's sign and determinant (5), margin and test (3).
OPS_CULL = 55
# Per evaluated pair of a (warp, instance) pair that passes the cull, in
# K1 and K3: the column terms, shared by two pixels (4 / 2), the row terms
# (3), power (4), the power test and the threshold test (2).
OPS_KEPT_FORWARD = 11
# The same in K2, one pixel per thread: column (4), row (3), power (4),
# the two tests (2).
OPS_KEPT_BACKWARD = 13
# alpha >= 1/255 (the only pairs an exact threshold test lets through):
# expf (two range-reduction multiply-adds, one ex2 and one scaling
# multiply: 6), opa·e, the clamp, the alpha test (3).
OPS_EXP = 9
# Then, in K1 and K3: 1 − alpha, T·(1 − alpha), the 1e-4 test.
OPS_ALPHA_OK = 3
# K1's used pair: w = alpha·T (1); 6 feature multiply-adds (12).
OPS_USED = 13
# K3's used pair: w (1) and 4 feature multiply-adds (8).
OPS_INFER_USED = 9
# K2's used pair after that: 1 − alpha, T / (1 − alpha), w; gdot (6 mul,
# 5 add); dalpha (4); sigma (2); dpower (1); the x, y sums (2 × 3) and
# their gradients (2); the conic gradients (3 + 2 + 3); dopa (1); 4
# feature gradients. A negation is an operand modifier, not an operation.
OPS_BWD_USED = 42
# The per-gaussian sums: NUM_GRAD adds per used pair, less NUM_GRAD per
# (tile, instance) pair with a used pixel, whose sum the atomics on the
# output add.

TOL_ACCUM, TOL_T, MIN_NCON_SHARE = 1e-5, 1e-6, 0.9999
TOL_COLOR = 1e-4
TOL_GRAD = 2e-4     # scale-normalised, tests/test_pallas_blend.py:67-71
# K3 on bf16-rounded opacity, rgb and depth against the exact K1; depth
# scaled by its largest value (tests/test_pallas_blend.py:270-289).
TOL_INFER = 1.5e-2

# The lego optimisation, configs/dnerf/lego.yaml (OptimizationParams; the
# scene radius that scales the position learning rate comes from a
# dataset's cameras and is 1 here).
LEGO = train.StepConfig(
    lambda_dssim=0.2, lambda_opa_mask=0.0, lambda_rigid=1.0,
    lambda_motion=0.0, position_lr_init=0.00016, position_lr_final=1.6e-06,
    position_lr_delay_mult=0.01, position_lr_max_steps=30000,
    position_t_lr_init=-1.0, feature_lr=0.0025, opacity_lr=0.05,
    scaling_lr=0.005, rotation_lr=0.001, spatial_lr_scale=1.0,
    sh_increase_interval=1000, sh_degree=3, sh_degree_t=2,
    iterations=30000)
FIRST_STEP = 5000   # SH annealed to its full 48 channels


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(ok: bool, msg: str):
    if not ok:
        raise RuntimeError(f"chip smoke check failed: {msg}")


def zero_launches():
    blend.blend_forward.launches = blend.blend_backward.launches = 0
    blend.blend_infer.launches = 0


def read_launches():
    return dict(k1=blend.blend_forward.launches,
                k2=blend.blend_backward.launches,
                k3=blend.blend_infer.launches)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# --------------------------------------------------------------------------
# Inputs, made in numpy from a seed
# --------------------------------------------------------------------------

def bench_scene(p: int, seed: int = 0, scale_mu: float = -4.2) -> dict:
    """The activated cloud of bench.py:build_inputs, same draws in the
    same order."""
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-1.5, 1.5, (p, 3)).astype(np.float32)
    xyz[:, 2] = rng.uniform(2.0, 8.0, p)
    quat = rng.normal(size=(p, 4)).astype(np.float32)
    quat /= np.linalg.norm(quat, axis=1, keepdims=True)
    quat_r = rng.normal(size=(p, 4)).astype(np.float32)
    quat_r /= np.linalg.norm(quat_r, axis=1, keepdims=True)
    return dict(
        means3d=xyz,
        t=rng.random(p).astype(np.float32),
        scales=np.exp(rng.normal(scale_mu, 0.5, (p, 3))).astype(np.float32),
        scales_t=np.exp(rng.normal(-1.0, 0.3, p)).astype(np.float32),
        rotations=quat,
        rotations_r=quat_r,
        opacity=rng.uniform(0.3, 0.95, p).astype(np.float32),
        sh=rng.normal(0, 0.2, (p, 48, 3)).astype(np.float32),
        active=np.ones(p, bool),
    )


def small_scene(rng, p: int) -> dict:
    """A random cloud in front of the identity camera (tests/utils.py)."""
    xyz = rng.uniform(-1.0, 1.0, (p, 3))
    xyz[:, 2] = rng.uniform(2.0, 6.0, p)
    q = rng.normal(size=(p, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    qr = rng.normal(size=(p, 4))
    qr /= np.linalg.norm(qr, axis=1, keepdims=True)
    sh = rng.normal(0.0, 0.3, (p, 48, 3))
    sh[:, 0, :] = rng.uniform(-1.0, 1.5, (p, 3))
    f = np.float32
    return dict(
        means3d=xyz.astype(f), t=rng.uniform(0, 1, p).astype(f),
        scales=np.exp(rng.normal(np.log(0.35), 0.3, (p, 3))).astype(f),
        scales_t=np.exp(rng.normal(np.log(0.3), 0.3, p)).astype(f),
        rotations=q.astype(f), rotations_r=qr.astype(f),
        opacity=rng.uniform(0.3, 0.95, p).astype(f), sh=sh.astype(f),
        active=np.ones(p, bool))


def raw_params(scene: dict) -> dict:
    """Pre-activation parameters, keyed as the JAX GaussianParams."""
    op = scene["opacity"].astype(np.float64)
    return dict(
        xyz=scene["means3d"], t=scene["t"][:, None],
        scaling=np.log(scene["scales"]),
        scaling_t=np.log(scene["scales_t"])[:, None],
        rotation=scene["rotations"], rotation_r=scene["rotations_r"],
        f_dc=scene["sh"][:, :1], f_rest=scene["sh"][:, 1:],
        opacity=np.log(op / (1.0 - op)).astype(np.float32)[:, None])


def camera(width, height, timestamp, device):
    return Camera(uid=0, rot=np.eye(3), trans=np.zeros(3), fovx=1.0,
                  fovy=1.0, width=width, height=height,
                  timestamp=timestamp).arrays(device)


# --------------------------------------------------------------------------
# Kernel vs plain
# --------------------------------------------------------------------------

def kernel_args(rec, bins, opts):
    return (rec, bins.gauss_id, bins.tile_start, bins.tile_count,
            opts.tiles_x)


def errors(k, p):
    return dict(accum_err=float((k[0] - p[0]).abs().max()),
                t_final_err=float((k[1] - p[1]).abs().max()),
                n_contrib_equal=float((k[2] == p[2]).float().mean()))


def compare(rec, bins, opts):
    """Kernel and plain version on the same inputs. Returns the error
    report, both results, and the plain version's pair counts."""
    args = kernel_args(rec, bins, opts)
    k = blend.blend_forward(*args)
    pairs = {}
    p = blend.blend_forward_plain(*args, pair_counts=pairs)
    torch.cuda.synchronize()
    return errors(k, p), k, p, pairs


def check_report(report, label):
    check(report["accum_err"] <= TOL_ACCUM,
          f"{label}: accum error {report['accum_err']}")
    check(report["t_final_err"] <= TOL_T,
          f"{label}: T_final error {report['t_final_err']}")
    check(report["n_contrib_equal"] >= MIN_NCON_SHARE,
          f"{label}: n_contrib equal on {report['n_contrib_equal']}")


def compare_infer(packed, bins, opts):
    """K3 and its plain version on the same packed table: (error report,
    kernel result, the plain version's pair counts)."""
    args = kernel_args(packed, bins, opts)
    k = blend.blend_infer(*args)
    pairs = {}
    p = blend.blend_infer_plain(*args, pair_counts=pairs)
    torch.cuda.synchronize()
    for x in k:
        check(bool(torch.isfinite(x).all()), "K3 output not finite")
    return (dict(accum_err=float((k[0] - p[0]).abs().max()),
                 t_final_err=float((k[1] - p[1]).abs().max())), k, pairs)


def check_infer_report(report, label):
    check(report["accum_err"] <= TOL_ACCUM,
          f"{label}: K3 accum error {report['accum_err']}")
    check(report["t_final_err"] <= TOL_T,
          f"{label}: K3 T_final error {report['t_final_err']}")


def infer_vs_exact(k3, k1):
    """Largest differences of K3 (rounded records) from K1 (exact ones):
    rgb sums, the depth sum over max(1, its largest value), T_final."""
    depth_scale = max(1.0, float(k1[0][:, 3].abs().max()))
    return dict(
        rgb=float((k3[0][:, 0:3] - k1[0][:, 0:3]).abs().max()),
        depth_scaled=float((k3[0][:, 3] - k1[0][:, 3]).abs().max())
        / depth_scale,
        t_final=float((k3[1] - k1[1]).abs().max()))


def check_infer_vs_exact(diff, label):
    check(max(diff.values()) <= TOL_INFER,
          f"{label}: K3 differs from K1 by {diff}")


def grad_error(k, p):
    """Largest scale-normalised difference of two (P, 12) gradient tables
    over the record columns: |k - p| / max(|p|.max(), 1e-3)."""
    scale = torch.clamp(p.abs().amax(dim=0), min=1e-3)
    return float(((k - p).abs() / scale).max())


def backward_args(rec, bins, fwd, dcot, opts):
    return (rec, bins.gauss_id, bins.tile_start, fwd[1], fwd[2], dcot,
            opts.tiles_x)


def random_cotangents(rng, t_final, bg, opts):
    """K2's per-pixel inputs for random image cotangents, through the
    same assembly as Blend's backward."""
    h, w = opts.height, opts.width
    dev = t_final.device
    imgs = [torch.as_tensor(rng.normal(size=s).astype(np.float32),
                            device=dev)
            for s in ((h, w, 3), (h, w), (h, w, 2), (h, w))]
    return blend.blend_cotangents(*imgs, t_final, bg, opts)[0]


def compare_backward(args):
    """K2 and its plain version on the same inputs: (error, kernel result,
    the plain version's pair counts)."""
    k = blend.blend_backward(*args)
    pairs = {}
    p = blend.blend_backward_plain(*args, pair_counts=pairs)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(k).all()), "K2 gradients not finite")
    return grad_error(k, p), k, pairs


def kernel_cases(device):
    rng = np.random.default_rng(1)
    cot_rng = np.random.default_rng(2)
    cases = {}

    s = small_scene(rng, 200)
    cases["random_64x64"] = (s, 64, 64)

    p = 700
    s = small_scene(rng, p)
    s["means3d"][:, :2] = rng.uniform(-0.25, 0.25, (p, 2))
    s["opacity"][s["means3d"][:, 2] < 3.0] = 0.99
    cases["saturated_48x40"] = (s, 48, 40)

    p = 48
    s = small_scene(rng, p)
    s["means3d"][:, :2] = rng.uniform(0.9, 1.6, (p, 2))
    s["means3d"][:, 2] = rng.uniform(2.0, 3.0, p)
    s["scales"] *= 0.2
    cases["empty_tiles_64x64"] = (s, 64, 64)

    cases["partial_tiles_48x40"] = (small_scene(rng, 120), 48, 40)

    # Thin gaussians tilted by their random rotations, three in four with
    # an opacity within a few percent of 1/255 (t at the camera's time, so
    # that the temporal marginal is 1): the threshold power is near 0 and
    # the pairs are those where the margins of the warp cull and of the expf
    # test decide, on f32 records (K1, K2) and bf16-rounded ones (K3).
    p = 400
    s = small_scene(rng, p)
    s["scales"] *= 0.5
    s["scales"][:, 0] *= 0.05
    s["t"][:] = 0.5
    opa = (1.0 / 255.0) * np.exp(rng.normal(0.0, 0.02, p))
    opa[::4] = rng.uniform(0.3, 0.95, p)[::4]
    s["opacity"] = opa.astype(np.float32)
    cases["cull_edges_48x40"] = (s, 48, 40)

    # Strip windows (parallel/strips.py), rendered with the frame's camera:
    # strip 1 of a 40x40 frame in 2 (rows 16-39: a partial last tile
    # row) and strip 3 of a 48x40 frame in 4 (rows 32-47: the principal
    # point 8 rows above the window). Each instance list holds only the
    # window's tiles.
    cases["strip_partial_24x40"] = (small_scene(rng, 200), 40, 40, 2, 1)
    cases["strip_offcentre_16x40"] = (small_scene(rng, 200), 48, 40, 4, 3)

    for name, (scene, h, w, *strip) in cases.items():
        opts = pre.RenderOptions(height=h, width=w)
        if strip:
            opts = strip_windows(opts, strip[0])[strip[1]]
        act = {k: torch.as_tensor(v, device=device) for k, v in scene.items()}
        proc, bins, rec = blend_inputs(
            **act, camera=camera(w, h, 0.5, device), opts=opts)
        report, k, _, _ = compare(rec, bins, opts)
        k3_report, k3, k3_pairs = compare_infer(
            blend.pack_records_infer(proc), bins, opts)
        k3_diff = infer_vs_exact(k3, k)
        dcot = random_cotangents(cot_rng, k[1],
                                 torch.full((3,), 0.3, device=device), opts)
        k2_err, _, pairs = compare_backward(
            backward_args(rec, bins, k, dcot, opts))
        counts = bins.tile_count
        report.update(case=name, height=opts.height, row0=opts.row0,
                      num_rendered=bins.num_rendered,
                      max_per_tile=int(bins.max_per_tile),
                      empty_tiles=int((counts == 0).sum()),
                      launches=blend.blend_forward.launches,
                      k2_grad_err=k2_err, k2_pairs=pairs,
                      k2_launches=blend.blend_backward.launches,
                      k3_accum_err=k3_report["accum_err"],
                      k3_t_final_err=k3_report["t_final_err"],
                      k3_vs_k1=k3_diff, k3_cull=cull_report(k3_pairs),
                      k3_launches=blend.blend_infer.launches)
        emit({"phase": "kernel_vs_plain", **report})
        check_report(report, name)
        check_infer_report(k3_report, name)
        check_infer_vs_exact(k3_diff, name)
        check(k2_err <= TOL_GRAD, f"{name}: K2 gradient error {k2_err}")
        check(pairs["used"] > 0, f"{name}: K2 used no pair")
        if name.startswith("saturated"):
            check(report["max_per_tile"] > 256, "saturated case too shallow")
            check(float(k[1].min()) < 1e-3, "saturated case not saturated")
        if name.startswith("empty"):
            check(report["empty_tiles"] > 0, "no empty tile")
        if name.startswith("cull_edges"):
            check(0 < k3_pairs["warp_kept"] < k3_pairs["warp_live"]
                  and k3_pairs["used"] > 0, f"{name}: the cull decides "
                  f"nothing here ({cull_report(k3_pairs)})")
    check(blend.blend_forward.launches >= len(cases), "K1 never launched")
    check(blend.blend_backward.launches >= len(cases), "K2 never launched")
    check(blend.blend_infer.launches >= len(cases), "K3 never launched")


# --------------------------------------------------------------------------
# Serving at full width
# --------------------------------------------------------------------------

def bound_ms(ops, nbytes):
    """(ms, what bounds, operations): the larger of the operations against
    the f32 peak and the bytes against the memory peak."""
    ops_s, bytes_s = ops / PEAK_F32_OPS, nbytes / PEAK_BYTES
    return max(ops_s, bytes_s) * 1e3, ("operations" if ops_s >= bytes_s
                                       else "bytes"), ops


def forward_bytes(bins, num_gaussians, rec_bytes, out_planes):
    """Bytes a forward blend must move: the record table, the ids, the
    tiles' ranges and the output planes, each once."""
    tiles = bins.tile_start.numel()
    return (num_gaussians * rec_bytes + bins.num_rendered * 4 + tiles * 8
            + tiles * blend.PIX * out_planes * 4)


def walk_ops(pairs, ops_used):
    """f32 operations of K1's and K3's warp-private walk on these inputs
    (the plain version's counts): the cull of every (warp, instance) pair
    a warp tests, the falloff of the evaluated pairs in those that pass,
    expf and the transmittance test where alpha >= 1/255, and
    `ops_used` for each used pair."""
    return (pairs["warp_live"] * OPS_CULL
            + pairs["kept_evaluated"] * OPS_KEPT_FORWARD
            + pairs["alpha_ok"] * (OPS_EXP + OPS_ALPHA_OK)
            + pairs["used"] * ops_used)


def forward_bound_ms(pairs, bins, num_gaussians):
    """Least time for K1 on these inputs: its walk's operations against
    the f32 peak, or the bytes (48-byte records; 6 features, T_final and
    n_contrib out), whichever is larger."""
    return bound_ms(walk_ops(pairs, OPS_USED),
                    forward_bytes(bins, num_gaussians, blend.REC * 4, 8))


def infer_bound_ms(pairs, bins, num_gaussians):
    """Least time for K3 on these inputs: its walk's operations (K1's, with
    4 features composited) against the f32 peak, or the bytes (32-byte
    records; 4 features and T_final out), whichever is larger."""
    return bound_ms(walk_ops(pairs, OPS_INFER_USED),
                    forward_bytes(bins, num_gaussians, blend.REC_INFER * 4,
                                  blend.NUM_FEAT_INFER + 1))


def backward_bound_ms(pairs, args):
    """Least time for K2 on these inputs: the cull, the falloff of the
    evaluated pairs in the (warp, instance) pairs that pass, expf and the
    gradient terms of the used pairs and their per-gaussian sums (the
    plain version's counts) against the f32 peak; or the bytes (records,
    ids, tile starts, T_final, n_contrib, the cotangents and the (P, 12)
    output each once, plus a 40-byte row per (tile, instance) pair the
    atomics add) against the memory peak, whichever is larger."""
    rec, gauss_id, tile_start, t_final, _, dcot, _ = args
    ops = (pairs["warp_live"] * OPS_CULL
           + pairs["kept_evaluated"] * OPS_KEPT_BACKWARD
           + pairs["used"] * (OPS_EXP + OPS_BWD_USED)
           + (pairs["used"] - pairs["tile_active"]) * blend.NUM_GRAD)
    nbytes = (2 * rec.numel() * 4 + gauss_id.numel() * 4
              + tile_start.numel() * 4 + t_final.numel() * 8
              + dcot.numel() * 4 + pairs["tile_active"] * blend.NUM_GRAD * 4)
    return bound_ms(ops, nbytes)


def cull_report(pairs):
    """What the plain version counted of a warp-private walk: the (warp,
    instance) pairs its warps test, the share that passes the cull, and
    the share of those with a used pixel."""
    return dict(warp_live=pairs["warp_live"],
                kept_share=pairs["warp_kept"] / max(pairs["warp_live"], 1),
                active_share_of_kept=pairs["warp_active"]
                / max(pairs["warp_kept"], 1))


def backward_traffic(pairs):
    """K2's cross-lane and atomic traffic on these inputs, from the plain
    version's counts: a 16-shuffle sum and 10 shared-memory adds per
    (warp, instance) pair with a used pixel, three vector atomics on the
    output per (tile, instance) pair with one; and what one shuffle tree
    and one scalar atomic per value and warp would take."""
    return dict(
        shuffles=pairs["warp_active"] * 16,
        shared_adds=pairs["warp_active"] * blend.NUM_GRAD,
        output_vector_atomics=pairs["tile_active"] * 3,
        tree_shuffles=pairs["warp_active"] * 5 * blend.NUM_GRAD,
        scalar_atomics=pairs["warp_active"] * blend.NUM_GRAD)


def time_call(fn, reps):
    """Mean ms of `fn()` over `reps` calls between CUDA events, after one
    call that warms up."""
    fn()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def time_kernel(rec, bins, opts, reps=20):
    """Mean ms of K1 over `reps` launches on the same inputs."""
    args = kernel_args(rec, bins, opts)
    return time_call(lambda: blend.launch_forward(*args), reps)


def time_plain(rec, bins, opts):
    args = kernel_args(rec, bins, opts)
    return time_call(lambda: blend.blend_forward_plain(*args), 1)


def staged(fn):
    """Run `fn(mark)` with a CUDA event at the start, at each of its stage
    marks and at the end: (total ms, [(mark name, ms since the previous
    event)], the last interval named "end")."""
    events, names = [], []

    def mark(stage="end"):
        events.append(torch.cuda.Event(enable_timing=True))
        events[-1].record()
        names.append(stage)

    mark("start")
    fn(mark)
    mark()
    torch.cuda.synchronize()
    return (events[0].elapsed_time(events[-1]),
            [(n, a.elapsed_time(b))
             for n, a, b in zip(names[1:], events, events[1:])])


def staged_frame(renderer, cam):
    """One served frame in stages: (total, activation + preprocess,
    binning, record build + K1 + assembly, clip) in ms."""
    total, parts = staged(lambda mark: renderer(cam, mark=mark))
    return (total, *(ms for _, ms in parts))


def profile(fn, n, label):
    """Device time per call from a torch.profiler trace of `n` calls of
    `fn(i)`: the sum of the CUDA kernels' times, and the five kernels that
    take most of it (ms per call)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as trace

    with trace(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
        for i in range(n):
            fn(i)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    check(len(kernels) > 0, "profiler recorded no CUDA kernel")
    kernels.sort(key=lambda e: -e.self_device_time_total)
    per_call = lambda us: us / 1e3 / n  # noqa: E731
    return {f"device_ms_per_{label}": per_call(
                sum(e.self_device_time_total for e in kernels)),
            f"kernels_per_{label}": sum(e.count for e in kernels) / n,
            "top_kernels_ms": [[e.key[:70],
                                per_call(e.self_device_time_total)]
                               for e in kernels[:8]]}


def serve(label, p, h, w, time_duration, scale_mu, timestamps, timed,
          device):
    """Serve `timestamps` requests of the bench cloud through
    GaussianRenderer, check each against the plain blend, and time it."""
    t0 = time.perf_counter()
    scene = bench_scene(p, seed=0, scale_mu=scale_mu)
    model = from_jax_params(raw_params(scene), p, device=device)
    opts = pre.RenderOptions(height=h, width=w, gaussian_dim=4, rot_4d=True,
                             time_duration=time_duration)
    renderer = GaussianRenderer(model, opts, bg=(0.0, 0.0, 0.0))
    cams = [camera(w, h, ts, device) for ts in timestamps]
    renderer(cams[0])                                    # warm-up
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    # The main path: counts zeroed just before, read just after.
    zero_launches()
    responses = [renderer(cam) for cam in cams]
    torch.cuda.synchronize()
    counts = read_launches()
    launches = counts["k1"]
    check(counts == dict(k1=len(cams), k2=0, k3=0),
          f"{label}: launches {counts} for {len(cams)} requests")

    per_request = []
    act = model.activate()._asdict()
    for ts, cam, (color, depth, alpha, nr, mpt, dropped) in zip(
            timestamps, cams, responses):
        check(dropped == 0, f"{label} t={ts}: {dropped} instances dropped")
        check(tuple(color.shape) == (h, w, 3), f"{label}: color shape")
        for name, x in (("color", color), ("depth", depth),
                        ("alpha", alpha)):
            check(bool(torch.isfinite(x).all()), f"{label}: {name} not finite")
        _, bins, rec = blend_inputs(**act, camera=cam, opts=opts)
        check(bins.num_rendered == nr, f"{label}: num_rendered differs")
        report, k, pl, pairs = compare(rec, bins, opts)
        check_report(report, f"{label} t={ts}")
        plain_color = torch.clamp(
            blend.assemble_outputs(pl[0], pl[1], renderer.bg, opts)[0],
            0.0, 1.0)
        color_err = float((color - plain_color).abs().max())
        check(color_err <= TOL_COLOR, f"{label} t={ts}: color error "
              f"{color_err} vs the plain blend")
        kernel_ms = time_kernel(rec, bins, opts)
        plain_ms = time_plain(rec, bins, opts)
        bound, bound_by, ops = forward_bound_ms(pairs, bins, p)
        row = dict(timestamp=ts, num_rendered=nr, max_per_tile=int(mpt),
                   instances_dropped=dropped, color_err_vs_plain=color_err,
                   kernel_ms=kernel_ms, plain_ms=plain_ms,
                   bound_ms=bound, bound_by=bound_by, pairs=pairs,
                   cull=cull_report(pairs), operations=ops, **report)
        per_request.append(row)
        emit({"phase": label, "request": row})

    # Timed frames: the renderer end to end (host clock, synchronised),
    # and the same work in stages (CUDA events).
    wall = []
    for i in range(timed):
        t1 = time.perf_counter()
        renderer(cams[i % len(cams)])
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t1) * 1e3)
    stages = np.array([staged_frame(renderer, cams[i % len(cams)])
                       for i in range(timed)])
    med = np.median(stages, axis=0)
    trace = profile(lambda i: renderer(cams[i % len(cams)]), 8, "frame")
    frame_ms = float(np.median(wall))
    summary = dict(
        phase=label, gaussians=p, height=h, width=w, frames_timed=timed,
        frame_ms_median=frame_ms, frames_per_s=1e3 / frame_ms,
        staged_ms_median=dict(total=float(med[0]), preprocess=float(med[1]),
                              binning=float(med[2]),
                              records_k1_assembly=float(med[3]),
                              clip=float(med[4])),
        device_busy_share=trace["device_ms_per_frame"] / frame_ms,
        trace=trace, launches_main_path=launches, setup_s=setup_s)
    emit(summary)
    return per_request, launches


# Stage of each of train_step's marks (the interval that ends at it); the
# first blend backward of a step starts right after the loss backward.
STEP_STAGES = {"preprocess": "activate_preprocess_binning",
               "binning": "activate_preprocess_binning",
               "blend": "records_k1_assembly", "loss": "loss", "knn": "knn",
               "blend_backward_start": "preprocess_backward",
               "blend_backward": "k2_blend_backward",
               "backward": "preprocess_backward", "update": "stats_adam",
               "end": "metrics"}


def step_split(parts):
    """Sum the intervals of one staged step by stage."""
    out = dict.fromkeys(list(dict.fromkeys(STEP_STAGES.values()))
                        + ["loss_backward"], 0.0)
    first = True
    for name, ms in parts:
        stage = STEP_STAGES[name]
        if name == "blend_backward_start" and first:
            stage, first = "loss_backward", False
        out[stage] += ms
    return out


def train_phase(device, p=100_000, hw=800, steps=5):
    """The lego training step at full width: 5 train_steps on the main
    path, K2 held to its plain version on the first step's inputs, then
    timed and staged steps and a profiler trace."""
    t0 = time.perf_counter()
    scene = bench_scene(p, seed=0)
    params = gaussians.GaussianParams(**{
        k: torch.as_tensor(np.asarray(v, np.float32), device=device)
        for k, v in raw_params(scene).items()})
    state = gaussians.new_state(params, p)
    opts = pre.RenderOptions(height=hw, width=hw, gaussian_dim=4,
                             rot_4d=True, time_duration=1.0)
    cams = [camera(hw, hw, ts, device) for ts in (0.3, 0.6)]
    rng = np.random.default_rng(0)
    gt = torch.as_tensor(rng.random((2, hw, hw, 3)).astype(np.float32),
                         device=device)
    mask = torch.ones((2, hw, hw), device=device)
    bg = torch.zeros(3, device=device)

    def run(st, i, mark=None):
        return train.train_step(st, FIRST_STEP + i, cams, gt, mask, bg,
                                LEGO, opts, mark=mark)

    run(state, 0)                                        # warm-up
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    # K2's inputs and result in the first step, for the plain version.
    captured = []

    def capture(args, out):
        captured.append((tuple(a.detach() if torch.is_tensor(a) else a
                               for a in args), out.clone()))

    # The main path: counts zeroed just before, read just after.
    zero_launches()
    wall, metrics, st = [], [], state
    try:
        for i in range(steps):
            blend.blend_backward.observer = capture if i == 0 else None
            t1 = time.perf_counter()
            st, _, m = run(st, i)
            torch.cuda.synchronize()
            wall.append((time.perf_counter() - t1) * 1e3)
            metrics.append(m)
    finally:
        blend.blend_backward.observer = None
    launches = read_launches()
    check(launches == dict(k1=2 * steps, k2=2 * steps, k3=0),
          f"train: {launches} launches for {steps} steps of 2 cameras")

    for i, m in enumerate(metrics):
        check(bool(torch.isfinite(m.loss)), f"train step {i}: loss not finite")
        check(m.instances_dropped == 0, f"train step {i}: instances dropped")
    for name, tree in (("params", st.params), ("gradients (Adam mu)",
                                               st.adam.mu),
                       ("Adam nu", st.adam.nu)):
        check(all(bool(torch.isfinite(x).all()) for x in tree),
              f"train: {name} not finite")
    check(all(bool(torch.isfinite(x).all()) for x in
              (st.xyz_grad_accum, st.t_grad_accum)),
          "train: densification statistics not finite")
    check(bool((st.denom > 0).any()), "train: no gaussian visible")

    # K2 against its plain version on the first step's own inputs.
    check(len(captured) == 2, f"train: captured {len(captured)} K2 calls")
    k2_rows = []
    for cam_i, (args, k) in enumerate(captured):
        pairs = {}
        pl = blend.blend_backward_plain(*args, pair_counts=pairs)
        err = grad_error(k, pl)
        abs_err = float((k - pl).abs().max())
        check(err <= TOL_GRAD, f"train camera {cam_i}: K2 gradient error "
              f"{err} vs the plain version")
        bound, bound_by, ops = backward_bound_ms(pairs, args)
        k2_rows.append(dict(
            camera=cam_i, grad_err=err, abs_err=abs_err, pairs=pairs,
            cull=cull_report(pairs), traffic=backward_traffic(pairs),
            operations=ops, bound_ms=bound, bound_by=bound_by,
            ms=time_call(lambda: blend.launch_backward(*args), 20),
            plain_ms=time_call(lambda: blend.blend_backward_plain(*args), 1),
            instances=int(args[1].numel()),
            max_n_contrib=int(args[4].max())))
        emit({"phase": "train_k2_vs_plain", **k2_rows[-1]})

    # Staged steps (CUDA events at train_step's marks) and a trace.
    splits = []
    for i in range(3):
        total, parts = staged(lambda mark: run(st, steps + i, mark))
        splits.append(dict(total=total, **step_split(parts)))
    trace = profile(lambda i: run(st, steps + 3 + i), 2, "step")
    step_ms = float(np.median(wall))
    first = metrics[0]
    emit(dict(
        phase="train_800x800", gaussians=p, height=hw, width=hw, batch=2,
        steps=steps, first_step=FIRST_STEP, step_ms=wall,
        step_ms_median=step_ms, rays_per_s=2 * hw * hw * 1e3 / step_ms,
        loss=[float(m.loss) for m in metrics],
        l1=float(first.l1), ssim_loss=float(first.ssim_loss),
        psnr=float(first.psnr), rigid=float(first.rigid),
        num_rendered=first.num_rendered,
        max_per_tile=int(first.max_per_tile),
        staged_ms_median={k: float(np.median([s[k] for s in splits]))
                          for k in splits[0]},
        device_busy_share=trace["device_ms_per_step"] / step_ms,
        trace=trace, launches_main_path=launches, setup_s=setup_s))
    return k2_rows, launches


# --------------------------------------------------------------------------
# Evaluation from a config and a scene on disk (kernel K3)
# --------------------------------------------------------------------------

def lookat_camera(uid, angle_deg, timestamp, hw, name="",
                  centre=(0.0, 0.0, 5.0)):
    """A camera on a circle of radius 5 around `centre` (the bench cloud's
    centre unless given), looking at it; angle 0 looks down +z (the
    identity pose for the bench cloud). COLMAP axes: x right, y down, z
    forward."""
    centre = np.asarray(centre, np.float64)
    a = np.deg2rad(angle_deg)
    pos = centre + 5.0 * np.array([np.sin(a), 0.0, -np.cos(a)])
    fwd = (centre - pos) / np.linalg.norm(centre - pos)
    right = np.cross([0.0, 1.0, 0.0], fwd)
    right /= np.linalg.norm(right)
    rot = np.stack([right, np.cross(fwd, right), fwd], axis=1)  # cam→world
    return Camera(uid=uid, rot=rot, trans=-rot.T @ pos, fovx=1.0, fovy=1.0,
                  width=hw, height=hw, timestamp=timestamp, image_name=name)


def blender_frame(cam, file_path):
    """The camera as a frame of a Blender-format transforms file: the
    camera→world matrix in OpenGL axes (y up, z backward)."""
    c2w = np.linalg.inv(cam.viewmatrix.astype(np.float64))
    c2w[:3, 1:3] *= -1
    return {"file_path": file_path, "time": cam.timestamp,
            "transform_matrix": c2w.tolist()}


def write_eval_scene(root, p, hw, device):
    """Checkpoint, YAML and Blender-format scene of the evaluation phase
    under `root`. The PNGs are exact (K1) renders of the checkpoint's own
    cloud, rounded to 8 bits. Returns the YAML's path."""
    import yaml
    from PIL import Image

    shutil.rmtree(root, ignore_errors=True)
    source, model_dir = os.path.join(root, "scene"), os.path.join(root, "model")
    scene = bench_scene(p, seed=0)
    params = gaussians.GaussianParams(**{
        k: torch.as_tensor(np.asarray(v, np.float32), device=device)
        for k, v in raw_params(scene).items()})
    save_checkpoint(os.path.join(model_dir, "chkpnt30000.pkl"),
                    gaussians.new_state(params, p), None, 30000)

    with open(os.path.join(ROOT, "configs", "dnerf", "lego.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg["num_pts"] = p
    cfg["ModelParams"].update(source_path=source, model_path=model_dir,
                              resolution=1)
    cfg_path = os.path.join(root, "lego_eval.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f)

    renderer = GaussianRenderer(gaussians.GaussianModel(params, p),
                                pre.RenderOptions(height=hw, width=hw,
                                                  gaussian_dim=4, rot_4d=True,
                                                  time_duration=1.0))
    splits = {"test": [(-20.0, 0.1), (-7.0, 0.4), (7.0, 0.7), (20.0, 0.95)],
              "train": [(-30.0, 0.0), (30.0, 1.0)]}
    for split, views in splits.items():
        os.makedirs(os.path.join(source, split))
        frames = []
        for i, (angle, ts) in enumerate(views):
            cam = lookat_camera(i, angle, ts, hw)
            color = renderer(cam.arrays(device))[0]
            rgb8 = (color * 255.0 + 0.5).to(torch.uint8).cpu().numpy()
            Image.fromarray(rgb8).save(
                os.path.join(source, split, f"r_{i:03d}.png"))
            frames.append(blender_frame(cam, f"{split}/r_{i:03d}"))
        with open(os.path.join(source, f"transforms_{split}.json"),
                  "w") as f:
            json.dump({"camera_angle_x": 1.0, "frames": frames}, f)
    return cfg_path


def read_png(path):
    from PIL import Image
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def cli_args(cfg_path, out_dir, device):
    return ["--config", cfg_path, "--load_iteration", "-1", "--out", out_dir,
            "--device", str(device)]


def run_cli(cfg_path, out_dir, fast, views, device):
    """One run of the port's render_cli on the test split, the launch
    counts zeroed just before and read just after: (metrics.json's
    contents, the counts)."""
    argv = cli_args(cfg_path, out_dir, device)
    zero_launches()
    rc = render_cli.main(argv + (["--fast"] if fast else []))
    torch.cuda.synchronize()
    launches = read_launches()
    label = "render_cli --fast" if fast else "render_cli"
    check(rc == 0, f"{label}: exit code {rc}")
    want = dict(k1=0, k2=0, k3=views) if fast else dict(k1=views, k2=0, k3=0)
    check(launches == want, f"{label}: launches {launches}, expected {want}")
    with open(os.path.join(out_dir, "metrics.json")) as f:
        summary = json.load(f)
    check(len(summary["views"]) == views, f"{label}: views in metrics.json")
    for i, view in enumerate(summary["views"]):
        check(view["instances_dropped"] == 0, f"{label}: instances dropped")
        for name in (f"{i:05d}.png", f"{i:05d}_depth.png"):
            check(os.path.exists(os.path.join(out_dir, name)),
                  f"{label}: {name} missing")
    for key in ("ssim", "msssim"):
        check(np.isfinite(summary[key]) and 0.0 < summary[key] <= 1.0,
              f"{label}: {key} {summary[key]}")
    return summary, launches


def infer_inputs(evaluator, cam):
    """(packed table, bins, (P, 12) table) of one view: what the packed
    and the exact blend read on this view's inputs."""
    act = gaussians.activate(evaluator.gauss.params, evaluator.n_active)
    proc, bins, packed = blend_inputs(
        **act._asdict(), camera=cam.arrays(evaluator.device),
        opts=evaluator.opts, infer=True)
    return packed, bins, blend.build_records(proc)


def k3_row(packed, bins, rec, opts, num_gaussians, label):
    """K3 held to its plain version and timed on one view's inputs, with
    K1's time on the same view beside it."""
    report, k3, pairs = compare_infer(packed, bins, opts)
    check_infer_report(report, label)
    k1 = blend.launch_forward(*kernel_args(rec, bins, opts))
    diff = infer_vs_exact(k3, k1)
    check_infer_vs_exact(diff, label)
    args = kernel_args(packed, bins, opts)
    bound, bound_by, ops = infer_bound_ms(pairs, bins, num_gaussians)
    return dict(
        num_rendered=bins.num_rendered, max_per_tile=int(bins.max_per_tile),
        pairs=pairs, cull=cull_report(pairs), operations=ops,
        bound_ms=bound, bound_by=bound_by,
        ms=time_call(lambda: blend.launch_infer(*args), 20),
        k1_ms=time_kernel(rec, bins, opts),
        plain_ms=time_call(lambda: blend.blend_infer_plain(*args), 1),
        k3_vs_k1=diff, **report)


def fast_vs_exact(evaluator, cam, label):
    """One view rendered by `evaluator` exact (K1) and fast (K3), held to
    TOL_INFER: (the differences, the fast colour)."""
    evaluator.eval_infer = False
    color_e, depth_e, alpha_e = evaluator.render_view(cam)
    evaluator.eval_infer = True
    color_f, depth_f, alpha_f = evaluator.render_view(cam)
    diff = dict(
        color=float((color_f - color_e).abs().max()),
        alpha=float((alpha_f - alpha_e).abs().max()),
        depth_scaled=float((depth_f - depth_e).abs().max())
        / max(1.0, float(depth_e.abs().max())))
    check(max(diff.values()) <= TOL_INFER,
          f"{label}: fast differs from exact by {diff}")
    return diff, color_f


def eval_phase(device, p=100_000, hw=800):
    """The evaluation path at full width, from files on disk through
    render_cli, with and without the packed inference blend."""
    t0 = time.perf_counter()
    root = os.path.join(ROOT, "build", f"eval_{hw}x{hw}")
    cfg_path = write_eval_scene(root, p, hw, device)
    setup_s = time.perf_counter() - t0
    views = 4

    # One view through the tool first, so that neither counted run pays
    # the process's first allocations and kernel loads.
    check(render_cli.main(cli_args(cfg_path, os.path.join(root, "warm_up"),
                                   device) + ["--fast", "--max_views", "1"])
          == 0, "render_cli warm-up failed")
    fast, launches = run_cli(cfg_path, os.path.join(root, "renders_fast"),
                             True, views, device)
    exact, exact_launches = run_cli(
        cfg_path, os.path.join(root, "renders_exact"), False, views, device)
    check(fast["psnr"] >= 35.0, f"eval --fast: psnr {fast['psnr']}")
    check(exact["psnr"] >= 45.0, f"eval: psnr {exact['psnr']}")

    # The same views through an Evaluator of our own: the fast view
    # against the exact one, and the PNG against the render.
    evaluator = Evaluator(load_config(cfg_path), device=device, verbose=False)
    evaluator.load(os.path.join(root, "model", "chkpnt30000.pkl"))
    cams = evaluator.scene.test_cameras
    view_diffs = []
    for i, cam in enumerate(cams):
        diff, color_f = fast_vs_exact(evaluator, cam, f"eval view {i}")
        png = read_png(os.path.join(root, "renders_fast", f"{i:05d}.png"))
        png_err = float(np.abs(png / 255.0
                               - color_f.cpu().numpy()).max())
        check(png.shape == (hw, hw, 3) and png_err <= 1.0 / 255.0 + 1e-6,
              f"eval view {i}: PNG differs from the render by {png_err}")
        view_diffs.append(dict(view=i, png_err=png_err, **diff))

    # K3 against its plain version on the first view's own inputs.
    packed, bins, rec = infer_inputs(evaluator, cams[0])
    row = k3_row(packed, bins, rec, evaluator.opts, p, "eval view 0")
    check(row["num_rendered"] == fast["views"][0]["num_rendered"],
          "eval view 0: num_rendered differs from render_cli's")
    emit({"phase": f"eval_{hw}x{hw}_k3_vs_plain", **row})

    # One view in stages, as render_cli handles it, and a trace of the 4.
    white = evaluator.cfg.model.white_background

    def view(cam, mark=None):
        gt = torch.as_tensor(
            load_image_composited(cam.image_path, white)[0], device=device)
        if mark:
            mark("load_image")
        color, _, _ = evaluator.render_view(cam, mark)
        out = (float(losses.psnr(color, gt)), float(losses.ssim(color, gt)),
               float(losses.msssim(color[None], gt[None])))
        if mark:
            mark("metrics")
        return out

    view(cams[0])                                        # warm-up
    stages = [dict(total=total, **dict(parts)) for total, parts in
              (staged(lambda mark: view(cams[i % views], mark))
               for i in range(8))]
    wall = []
    for i in range(8):
        t1 = time.perf_counter()
        view(cams[i % views])
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t1) * 1e3)
    trace = profile(lambda i: view(cams[i]), views, "view")
    view_ms = float(np.median(wall))
    emit(dict(
        phase=f"eval_{hw}x{hw}", entry="files: yaml, transforms json, png, "
        "pkl checkpoint -> fourdgs_tpu_torch.render_cli", gaussians=p,
        height=hw, width=hw, views=views,
        fast=dict(psnr=fast["psnr"], ssim=fast["ssim"],
                  msssim=fast["msssim"],
                  render_ms=[v["render_ms"] for v in fast["views"]],
                  launches=launches),
        exact=dict(psnr=exact["psnr"], ssim=exact["ssim"],
                   msssim=exact["msssim"],
                   render_ms=[v["render_ms"] for v in exact["views"]],
                   launches=exact_launches),
        fast_vs_exact=view_diffs,
        view_ms_median=view_ms,
        staged_ms_median={k: float(np.median([s[k] for s in stages]))
                          for k in stages[0]},
        device_busy_share=trace["device_ms_per_view"] / view_ms,
        trace=trace, setup_s=setup_s))
    return evaluator, row, launches["k3"]


def env_evaluator(device, p, h, w, res):
    """An Evaluator of the DyNeRF-shape cloud with an environment map in
    its checkpoint, set to the packed blend, and its one camera."""
    root = os.path.join(ROOT, "build", f"eval_{w}x{h}_env")
    shutil.rmtree(root, ignore_errors=True)
    scene = bench_scene(p, seed=0, scale_mu=-4.9)
    params = gaussians.GaussianParams(**{
        k: torch.as_tensor(np.asarray(v, np.float32), device=device)
        for k, v in raw_params(scene).items()})
    tex = np.random.default_rng(0).random((res, res, 3)).astype(np.float32)
    env = envmap.init_envmap(res, device=device)._replace(
        texture=torch.as_tensor(tex, device=device))
    path = os.path.join(root, "chkpnt30000.pkl")
    save_checkpoint(path, gaussians.new_state(params, p), env, 30000)

    # configs/dynerf/flame_salmon.yaml's model settings.
    cfg = load_config(None, overrides=dict(
        gaussian_dim=4, rot_4d=True, time_duration=[0.0, 10.0], num_pts=p,
        pipeline=dict(env_map_res=res, eval_shfs_4d=True)))
    cam = Camera(uid=0, rot=np.eye(3), trans=np.zeros(3), fovx=1.0, fovy=1.0,
                 width=w, height=h, timestamp=0.5)
    evaluator = Evaluator(cfg, scene=SceneInfo(
        point_cloud=None, train_cameras=[cam], test_cameras=[cam],
        translate=np.zeros(3), radius=1.0, ply_path=""), device=device,
        verbose=False)
    evaluator.eval_infer = True
    evaluator.load(path)
    check(evaluator.env is not None
          and tuple(evaluator.env.texture.shape) == (res, res, 3),
          "eval_env: the checkpoint's environment map was not loaded")
    return evaluator, cam


def eval_env_phase(device, p=300_000, h=1014, w=1352, res=500):
    """One view of the DyNeRF-shape cloud through Evaluator with an
    environment map in the checkpoint and the packed blend: (K3 launches,
    the evaluator, its camera)."""
    evaluator, cam = env_evaluator(device, p, h, w, res)
    evaluator.render_view(cam)                           # warm-up
    torch.cuda.synchronize()

    zero_launches()
    t1 = time.perf_counter()
    color, depth, alpha = evaluator.render_view(cam)
    torch.cuda.synchronize()
    view_ms = (time.perf_counter() - t1) * 1e3
    launches = read_launches()
    check(launches == dict(k1=0, k2=0, k3=1), f"eval_env: {launches}")
    check(evaluator.last_counts["instances_dropped"] == 0,
          "eval_env: instances dropped")
    check(tuple(color.shape) == (h, w, 3), "eval_env: color shape")
    for name, x in (("color", color), ("depth", depth), ("alpha", alpha)):
        check(bool(torch.isfinite(x).all()), f"eval_env: {name} not finite")

    # The sky composite against a plain recomputation.
    arrays = cam.arrays(device)
    act = gaussians.activate(evaluator.gauss.params, evaluator.n_active)
    out = render(**act._asdict(), camera=arrays, bg=evaluator.bg,
                 opts=evaluator.opts, infer=True)
    intr = torch.as_tensor(camera_intrinsics(cam), device=device)
    origin, dirs = envmap.camera_rays(arrays.viewmatrix, intr, h, w)
    sky = envmap.sample_sky(evaluator.env.texture, origin, dirs)
    want = torch.clamp(out.color + (1.0 - out.alpha)[..., None] * sky,
                       0.0, 1.0)
    sky_err = float((color - want).abs().max())
    check(sky_err <= 1e-6, f"eval_env: sky composite error {sky_err}")
    check(float(sky.max()) > 0.5 and float((1.0 - out.alpha).max()) > 0.5,
          "eval_env: the sky is not visible in this view")

    packed, bins, rec = infer_inputs(evaluator, cam)
    row = k3_row(packed, bins, rec, evaluator.opts, p, "eval_env")
    emit(dict(phase=f"eval_{w}x{h}_env", gaussians=p, height=h, width=w,
              env_map_res=res, view_ms=view_ms, sky_err=sky_err,
              launches=launches, k3=row))
    return launches["k3"], evaluator, cam


def viewer_phase(evaluator):
    """One SIBR-format request over a local socket, answered by
    Evaluator.render_arrays through K3."""
    from fourdgs_tpu_torch.data.cameras import camera_from_matrices

    w, h = evaluator.opts.width, evaluator.opts.height
    cam = evaluator.scene.test_cameras[1]
    evaluator.eval_infer = True
    # The wire format holds row-vector (transposed) matrices with SIBR's
    # y/z flips, which viewer.decode_camera undoes.
    view = cam.viewmatrix.T.copy()
    view[:, 1:3] *= -1
    proj = cam.full_proj.T.copy()
    proj[:, 1] *= -1
    message = {"resolution_x": w, "resolution_y": h, "train": False,
               "fov_x": cam.fovx, "fov_y": cam.fovy, "z_near": 0.01,
               "z_far": 100.0, "shs_python": False,
               "rot_scale_python": False, "keep_alive": False,
               "scaling_modifier": 1.0, "view_matrix": view.flatten().tolist(),
               "view_projection_matrix": proj.flatten().tolist()}
    timestamp = 0.4
    server = ViewerServer(port=0)
    port = server.listener.getsockname()[1]
    result = {}

    def client():
        with socket.create_connection(("127.0.0.1", port), timeout=60) as c:
            payload = json.dumps(message).encode()
            c.sendall(len(payload).to_bytes(4, "little") + payload)
            buf = b""
            while len(buf) < h * w * 3:
                chunk = c.recv(h * w * 3 - len(buf))
                if not chunk:
                    break
                buf += chunk
            result["bytes"] = buf

    thread = threading.Thread(target=client)
    render_fn = render_cli.viewer_render_fn(evaluator, timestamp)
    zero_launches()
    t1 = time.perf_counter()
    thread.start()
    try:
        deadline = time.monotonic() + 60.0
        while "bytes" not in result and time.monotonic() < deadline:
            server.poll(render_fn, verify="ok")
            time.sleep(0.001)
        thread.join(timeout=60)
    finally:
        server.close()
    request_ms = (time.perf_counter() - t1) * 1e3
    launches = read_launches()
    check(not thread.is_alive() and "bytes" in result,
          "viewer: the request was never served")
    check(launches == dict(k1=0, k2=0, k3=1), f"viewer: {launches}")

    arrays = camera_from_matrices(w, h, cam.fovx, cam.fovy, cam.viewmatrix,
                                  cam.full_proj, timestamp=timestamp,
                                  device=evaluator.device)
    intr = torch.as_tensor(camera_intrinsics(cam), device=evaluator.device)
    color, _, _ = evaluator.render_arrays(arrays, intr)
    want = render_cli.to_u8(color)
    check(len(result["bytes"]) == want.size, "viewer: short response")
    got = np.frombuffer(result["bytes"], np.uint8).reshape(h, w, 3)
    check(bool((got == want).all()),
          "viewer: the bytes differ from the render's 8-bit image")
    check(int(want.max()) > 0, "viewer: the served image is black")
    emit(dict(phase="viewer", height=h, width=w, request_ms=request_ms,
              launches=launches, bytes=len(result["bytes"])))
    return launches["k3"]


# --------------------------------------------------------------------------
# Training the lego config end to end (K1, K2), then render_cli (K1, K3)
# --------------------------------------------------------------------------

# The only changes to configs/dnerf/lego.yaml (besides the scene and output
# paths), as `--override`s: the YAML wins over flags. Densify events at 200
# and 300 (the second with the size threshold on), an opacity reset at 200,
# one evaluation and checkpoint at 300.
LEGO_TRAIN_CUTS = ["optimization.iterations=300",
                   "optimization.densify_from_iter=100",
                   "optimization.densification_interval=100",
                   "optimization.densify_until_iter=301",
                   "optimization.opacity_reset_interval=200",
                   "test_iterations=[300]", "save_iterations=[300]",
                   "exhaust_test=false"]


def write_lego_scene(source, p, hw, device):
    """A Blender-format scene named like DNeRF's lego under `source` (a
    path ending in "lego" reads transforms_val.json as its test split): 16
    train and 4 val views of the bench cloud moved to the origin, on a
    circle around it, at timestamps over [0, 1]; hw x hw RGBA PNGs of exact
    (K1) renders, straight colour and the render's alpha. No
    points3d.ply: the trainer starts from lego's 100k random points in
    [-1.3, 1.3]^3."""
    from PIL import Image

    shutil.rmtree(source, ignore_errors=True)
    scene = bench_scene(p, seed=0)
    scene["means3d"][:, 2] -= 5.0
    renderer = GaussianRenderer(
        from_jax_params(raw_params(scene), p, device=device),
        pre.RenderOptions(height=hw, width=hw, gaussian_dim=4, rot_4d=True,
                          time_duration=1.0))
    splits = {"train": [(360.0 * i / 16, i / 15) for i in range(16)],
              "val": [(360.0 * (i + 0.5) / 4, ts)
                      for i, ts in enumerate((0.1, 0.4, 0.7, 0.95))]}
    for split, views in splits.items():
        os.makedirs(os.path.join(source, split))
        frames = []
        for i, (angle, ts) in enumerate(views):
            cam = lookat_camera(i, angle, ts, hw, centre=(0.0, 0.0, 0.0))
            color, _, alpha = renderer(cam.arrays(device))[:3]
            straight = color / torch.clamp(alpha, min=1e-6)[..., None]
            rgba = torch.cat([torch.clamp(straight, 0.0, 1.0),
                              alpha[..., None]], dim=-1)
            Image.fromarray((rgba * 255.0 + 0.5).to(torch.uint8).cpu()
                            .numpy(), "RGBA").save(
                os.path.join(source, split, f"r_{i:03d}.png"))
            frames.append(blender_frame(cam, f"{split}/r_{i:03d}"))
        with open(os.path.join(source, f"transforms_{split}.json"),
                  "w") as f:
            json.dump({"camera_angle_x": 1.0, "frames": frames}, f)


def observed_trainer(trainer_cls, check_step, made):
    """`trainer_cls` recording what the phase checks (each instance is
    appended to `made`): the test PSNR of an
    evaluate() before training, each step's loss, dropped instances, active
    count and host ms (synchronised), each densify event's counts and ms,
    each evaluate's ms and PSNR, the views rendered (one K1 each), and K1's
    and K2's inputs and results on the cameras of training step
    `check_step` (None: none)."""

    class Observed(trainer_cls):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.obs = dict(initial=self.n_active, steps=[], events=[],
                            evaluations=[], views=0, k1=[], k2=[])
            self._rendering_view = False
            made.append(self)

        def render_view(self, cam, mark=None):
            self.obs["views"] += 1
            self._rendering_view = True
            try:
                return super().render_view(cam, mark)
            finally:
                self._rendering_view = False

        def evaluate(self, *args, **kwargs):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            psnr = super().evaluate(*args, **kwargs)
            torch.cuda.synchronize()
            self.obs["evaluations"].append(dict(
                step=self.step, ms=(time.perf_counter() - t1) * 1e3,
                psnr=psnr, splits=dict(self.last_eval)))
            return psnr

        def _densify_event(self, iteration):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            info = super()._densify_event(iteration)
            torch.cuda.synchronize()
            self.obs["events"].append(dict(
                it=iteration, ms=(time.perf_counter() - t1) * 1e3,
                **info._asdict()))
            return info

        def train(self, num_iterations=None, on_step=None):
            self.evaluate()                  # the PSNR before training

            def observer(key):
                def observe(args, out):
                    # During training step it, self.step is still it - 1.
                    if (self._rendering_view or check_step is None
                            or self.step != check_step - 1):
                        return
                    self.obs[key].append((
                        tuple(a.detach() if torch.is_tensor(a) else a
                              for a in args),
                        tuple(x.clone() for x in out)
                        if isinstance(out, tuple) else out.clone()))
                return observe

            last = [time.perf_counter()]

            def record(it, m):
                torch.cuda.synchronize()
                now = time.perf_counter()
                self.obs["steps"].append(dict(
                    it=it, ms=(now - last[0]) * 1e3, loss=float(m.loss),
                    dropped=m.instances_dropped, n_active=self.n_active))
                last[0] = now

            blend.blend_forward.observer = observer("k1")
            blend.blend_backward.observer = observer("k2")
            try:
                return super().train(num_iterations, on_step=record)
            finally:
                blend.blend_forward.observer = None
                blend.blend_backward.observer = None

    return Observed


def step_kernel_rows(obs, check_step, n_active, batch, label):
    """K1 and K2 held to their plain versions on the `batch` cameras of
    training step `check_step` that `observed_trainer` captured, the cloud
    `n_active` gaussians: (K1 rows, K2 rows) with error, ms, plain ms and
    bound."""
    for key in ("k1", "k2"):
        check(len(obs[key]) == batch, f"{label}: captured {len(obs[key])} "
              f"{key.upper()} calls of step {check_step}")
    k1_rows = []
    for cam_i, (args, k) in enumerate(obs["k1"]):
        check(args[0].shape[0] == n_active,
              f"{label}: K1's step did not see the grown cloud")
        pairs = {}
        report = errors(k, blend.blend_forward_plain(*args,
                                                     pair_counts=pairs))
        check_report(report, f"{label} camera {cam_i}: K1")
        bins = types.SimpleNamespace(tile_start=args[2],
                                     num_rendered=args[1].numel())
        bound, bound_by, ops = forward_bound_ms(pairs, bins,
                                                args[0].shape[0])
        k1_rows.append(dict(
            camera=cam_i, step=check_step, gaussians=args[0].shape[0],
            instances=int(args[1].numel()), bound_ms=bound,
            bound_by=bound_by, operations=ops,
            ms=time_call(lambda: blend.launch_forward(*args), 20),
            plain_ms=time_call(lambda: blend.blend_forward_plain(*args), 1),
            **report))
    k2_rows = []
    for cam_i, (args, k) in enumerate(obs["k2"]):
        check(args[0].shape[0] == n_active,
              f"{label}: K2's step did not see the grown cloud")
        pairs = {}
        pl = blend.blend_backward_plain(*args, pair_counts=pairs)
        err = grad_error(k, pl)
        check(err <= TOL_GRAD, f"{label} camera {cam_i}: K2 gradient "
              f"error {err} vs the plain version")
        bound, bound_by, ops = backward_bound_ms(pairs, args)
        k2_rows.append(dict(
            camera=cam_i, step=check_step, gaussians=args[0].shape[0],
            grad_err=err, abs_err=float((k - pl).abs().max()),
            instances=int(args[1].numel()), bound_ms=bound,
            bound_by=bound_by, operations=ops,
            ms=time_call(lambda: blend.launch_backward(*args), 20),
            plain_ms=time_call(lambda: blend.blend_backward_plain(*args),
                               1)))
    return k1_rows, k2_rows


def render_checkpoint(root, config_yaml, source, model_dir, checkpoint,
                      views, trainer_psnr, label, device):
    """The latest chkpnt<it>.pkl of `model_dir` (`checkpoint`) through
    render_cli on its test split, --fast (1 K3 per view) and exact (1 K1
    per view), the exact PSNR equal to the trainer's; then every test view
    fast against exact (TOL_INFER) and K3 against its plain version on the
    first view's inputs."""
    import yaml

    with open(config_yaml) as f:
        cfg = yaml.safe_load(f)
    cfg["ModelParams"].update(source_path=source, model_path=model_dir)
    cfg_path = os.path.join(root, "render.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f)
    fast, fast_launches = run_cli(cfg_path, os.path.join(root, "renders_fast"),
                                  True, views, device)
    exact, exact_launches = run_cli(
        cfg_path, os.path.join(root, "renders_exact"), False, views, device)
    check(abs(exact["psnr"] - trainer_psnr) < 1e-3,
          f"{label}: render_cli PSNR {exact['psnr']} vs the trainer's "
          f"{trainer_psnr}")

    evaluator = Evaluator(load_config(cfg_path), device=device, verbose=False)
    evaluator.load(os.path.join(model_dir, checkpoint))
    cams = evaluator.scene.test_cameras
    view_diffs = [dict(view=i, **fast_vs_exact(evaluator, cam,
                                               f"{label} view {i}")[0])
                  for i, cam in enumerate(cams)]
    packed, bins, rec = infer_inputs(evaluator, cams[0])
    k3 = k3_row(packed, bins, rec, evaluator.opts, evaluator.n_active,
                f"{label} view 0")
    return dict(
        render_cli=dict(
            fast=dict(psnr=fast["psnr"], ssim=fast["ssim"],
                      msssim=fast["msssim"], launches=fast_launches,
                      render_ms=[v["render_ms"] for v in fast["views"]]),
            exact=dict(psnr=exact["psnr"], ssim=exact["ssim"],
                       msssim=exact["msssim"], launches=exact_launches,
                       render_ms=[v["render_ms"] for v in exact["views"]])),
        fast_vs_exact=view_diffs,
        k3={key: k3[key] for key in ("num_rendered", "accum_err",
                                     "t_final_err", "k3_vs_k1", "ms",
                                     "k1_ms", "plain_ms", "bound_ms")})


def run_training(argv, check_step, label):
    """The main path of a training phase: `fourdgs_tpu_torch.train.main`
    on `argv` with `observed_trainer` swapped in, the launch counts zeroed
    just before and read just after: (the trainer, the counts, seconds)."""
    from fourdgs_tpu_torch import train as train_cli
    from fourdgs_tpu_torch.engine import trainer as trainer_mod

    base, made = trainer_mod.Trainer, []
    trainer_mod.Trainer = observed_trainer(base, check_step, made)
    zero_launches()
    t1 = time.perf_counter()
    try:
        rc = train_cli.main(argv)
        torch.cuda.synchronize()
    finally:
        trainer_mod.Trainer = base
    train_s = time.perf_counter() - t1
    launches = read_launches()
    check(rc == 0, f"{label}: exit code {rc}")
    check(len(made) == 1, f"{label}: no Trainer made")
    return made[0], launches, train_s


def check_training(obs, launches, iterations, batch, event_its, label):
    """A finite loss and no dropped instance on every step, the densify
    events where expected, and exactly `batch` K2 per step and `batch` K1
    per step plus one per evaluation view."""
    steps = obs["steps"]
    check(len(steps) == iterations, f"{label}: {len(steps)} steps")
    for st in steps:
        check(np.isfinite(st["loss"]), f"{label} it {st['it']}: loss "
              f"{st['loss']}")
        check(st["dropped"] == 0, f"{label} it {st['it']}: instances "
              "dropped")
    its = [e["it"] for e in obs["events"]]
    check(its == event_its, f"{label}: densify events at {its}")
    want = dict(k1=batch * iterations + obs["views"],
                k2=batch * iterations, k3=0)
    check(launches == want, f"{label}: launches {launches}, expected "
          f"{want} ({obs['views']} evaluation views)")


def median_step_ms(steps, lo, hi):
    return float(np.median([st["ms"] for st in steps
                            if lo <= st["it"] < hi]))


def train_lego_phase(device, p=100_000, hw=800, iterations=300, extra=()):
    """The lego config trained end to end on the card from a scene on
    disk through `fourdgs_tpu_torch.train.main` (K1 forward, K2 backward),
    then its checkpoint rendered by render_cli with and without --fast.
    `p` and `hw`: the scene's cloud and image size; `extra`: more
    --override items (a rehearsal's smaller cloud). Returns the training's
    launch counts and render_cli --fast's K3 launches."""
    t0 = time.perf_counter()
    root = os.path.join(ROOT, "build", "train_lego")
    shutil.rmtree(root, ignore_errors=True)
    source, model_dir = os.path.join(root, "lego"), os.path.join(root, "model")
    write_lego_scene(source, p, hw, device)
    lego_yaml = os.path.join(ROOT, "configs", "dnerf", "lego.yaml")
    argv = ["--config", lego_yaml, "--device", str(device), "--quiet",
            "--override", f"model.source_path={source}",
            f"model.model_path={model_dir}"] + LEGO_TRAIN_CUTS + list(extra)
    first_event = 200
    setup_s = time.perf_counter() - t0

    trainer, launches, train_s = run_training(argv, first_event + 1,
                                              "train_lego")
    obs = trainer.obs

    check_training(obs, launches, iterations, 2, [200, 300], "train_lego")
    steps, events = obs["steps"], obs["events"]
    sizes = [obs["initial"]] + [e["n_active"] for e in events]
    check(all(a != b for a, b in zip(sizes, sizes[1:])),
          f"train_lego: n_active {sizes} unchanged at an event")
    before, after = obs["evaluations"][0], obs["evaluations"][-1]
    check(before["step"] == 0 and after["step"] == iterations
          and after["psnr"] > before["psnr"],
          f"train_lego: test PSNR {before['psnr']} -> {after['psnr']}")

    # K1 and K2 against their plain versions on the first step of the
    # grown cloud; the checkpoint through render_cli on the 4 val views
    # (lego's test split).
    k1_rows, k2_rows = step_kernel_rows(obs, first_event + 1,
                                        events[0]["n_active"], 2,
                                        "train_lego")
    renders = render_checkpoint(root, lego_yaml, source, model_dir,
                                f"chkpnt{iterations}.pkl", 4, after["psnr"],
                                "train_lego", device)

    emit(dict(
        phase="train_lego_densify", config="configs/dnerf/lego.yaml",
        cuts=LEGO_TRAIN_CUTS + [f"scene: 16 train + 4 val {hw}x{hw} K1 "
                                "renders of the bench cloud, no "
                                "points3d.ply"],
        height=trainer.opts.height, width=trainer.opts.width,
        iterations=iterations, n_active_initial=obs["initial"],
        events=events,
        step_ms_median_before_first_event=median_step_ms(steps, 2, 200),
        step_ms_median_after_first_event=median_step_ms(steps, 202, 300),
        steps_per_s=iterations / train_s, train_s=train_s,
        evaluate=[dict(step=e["step"], ms=e["ms"], psnr=e["psnr"])
                  for e in obs["evaluations"]],
        psnr_before=before["psnr"], psnr_after=after["psnr"],
        loss_first=steps[0]["loss"], loss_last=steps[-1]["loss"],
        k1=k1_rows, k2=k2_rows, launches=launches,
        evaluation_views=obs["views"], **renders,
        setup_s=setup_s, seconds=time.perf_counter() - t0))
    return launches, renders["render_cli"]["fast"]["launches"]["k3"]


# --------------------------------------------------------------------------
# The configs/synth scenarios: datasets generated on the card, trained as
# the configs are
# --------------------------------------------------------------------------

# The only changes to configs/synth/quality.yaml (besides the scene and
# output paths): the first 1000 of its 10k iterations, every schedule kept.
SYNTH_QUALITY_CUTS = ["optimization.iterations=1000",
                      "test_iterations=[500,1000]", "save_iterations=[1000]"]
# configs/synth/dynerf_quality.yaml: 200 iterations, one densify event at
# 200; the dataset cut to 12 frames per camera and 4 test frames.
SYNTH_DYNERF_CUTS = ["optimization.iterations=200",
                     "optimization.densify_from_iter=100",
                     "optimization.densification_interval=100",
                     "optimization.densify_until_iter=201",
                     "test_iterations=[200]", "save_iterations=[200]"]
SYNTH_DYNERF_DATA = ["--n_frames", "12", "--n_test", "4"]
# The TensorBoard scalars the trainer writes at step 1 and every 10 steps
# (the rigid loss's only where it is on).
TB_STEP_TAGS = ("train_loss_patches/l1_loss", "train_loss_patches/ssim_loss",
                "train_loss_patches/total_loss", "total_points", "iter_time")
PSNR_SYNTH_QUALITY_1000 = 26.0   # JAX record at 1000: 29.13 dB
# The ground-truth oracle on the card against the CPU, as
# tests/test_torch_synth.py holds the CPU's against JAX.
TOL_ORACLE = 1e-5


def oracle_card_vs_cpu(device):
    """`synth.render_frames` on the card with TF32 allowed by the caller
    (the generator turns it off itself) against the CPU, on the tests'
    frames: 2 poses at 48x48, points_scale 0.05, white and black
    backgrounds. The largest colour or alpha difference, held to
    TOL_ORACLE."""
    from fourdgs_tpu_torch.data import synth

    scene = synth.make_scene(points_scale=0.05, seed=0)
    eyes, times = synth.sample_train_poses(2, 0)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        err = 0.0
        for white in (True, False):
            card, cpu = (list(synth.render_frames(
                scene, eyes, times, 48, 48, white_background=white,
                device=dev)) for dev in (device, "cpu"))
            for (c1, a1), (c2, a2) in zip(card, cpu, strict=True):
                err = max(err, float(np.abs(c1 - c2).max()),
                          float(np.abs(a1 - a2).max()))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    check(err <= TOL_ORACLE, f"synth oracle: card vs CPU {err} > "
          f"{TOL_ORACLE}")
    return err


def generate(argv, label):
    """`python -m fourdgs_tpu_torch.gen_synth_dataset` on `argv` into a
    fresh directory: (seconds, frames, ms per frame)."""
    from fourdgs_tpu_torch import gen_synth_dataset

    out = argv[argv.index("--out") + 1]
    shutil.rmtree(out, ignore_errors=True)
    t1 = time.perf_counter()
    check(gen_synth_dataset.main(argv) == 0, f"{label}: generator failed")
    seconds = time.perf_counter() - t1
    frames = 0
    for split in ("train", "test"):
        with open(os.path.join(out, f"transforms_{split}.json")) as f:
            frames += len(json.load(f)["frames"])
    return seconds, frames, seconds / frames * 1e3


def staged_train_steps(trainer, n=3):
    """`n` training steps from the trainer's state on its first batch, in
    stages (CUDA events at train_step's marks): the medians by stage, ms.
    Not on the main path: run after its counts are read."""
    idx = list(range(trainer.cfg.batch_size))
    cams, gt, alpha, intr = trainer._batch_arrays(idx)
    if alpha is None:                      # the GT cache holds the images
        sel = torch.as_tensor(idx, device=trainer.device)
        gt, alpha = trainer._gt_cache[0][sel], trainer._gt_cache[1][sel]
    splits = []
    for _ in range(n):
        total, parts = staged(lambda mark: train.train_step(
            trainer.gauss, trainer.step + 1, cams, gt, alpha, trainer.bg,
            trainer.step_cfg, trainer.opts, env=trainer.env,
            intrinsics=intr, mark=mark))
        splits.append(dict(total=total, **step_split(parts)))
    return {k: float(np.median([sp[k] for sp in splits]))
            for k in splits[0]}


def train_synth_quality_phase(device, size=400, n_train=120, n_test=20,
                              points_scale=1.0, extra=()):
    """configs/synth/quality.yaml, the north-star scenario: its dataset
    generated on the card (`python -m fourdgs_tpu_torch.gen_synth_dataset`
    at full size), then its first 1000 iterations trained through
    `fourdgs_tpu_torch.train.main` with every schedule kept (the
    white-background opacity reset at 500, densify events at 600-1000),
    evaluated at 500 and 1000 with TensorBoard events; K1 and K2 held to
    their plain versions on the cameras of step 601; chkpnt1000.pkl
    through render_cli. The arguments cut the scene for a rehearsal.
    Returns the training's launch counts, render_cli --fast's K3 launches
    and the median step ms before the first densify event."""
    t0 = time.perf_counter()
    oracle_err = oracle_card_vs_cpu(device)
    root = os.path.join(ROOT, "build", "synth_quality")
    shutil.rmtree(root, ignore_errors=True)
    source, model_dir = os.path.join(root, "data"), os.path.join(root, "model")
    gen_s, frames, frame_ms = generate(
        ["--out", source, "--n_train", str(n_train), "--n_test", str(n_test),
         "--size", str(size), "--points_scale", str(points_scale),
         "--seed", "0", "--device", str(device)], "train_synth_quality")
    config = os.path.join(ROOT, "configs", "synth", "quality.yaml")
    argv = ["--config", config, "--device", str(device), "--quiet",
            "--override", f"model.source_path={source}",
            f"model.model_path={model_dir}"] + SYNTH_QUALITY_CUTS + list(extra)
    iterations, check_step = 1000, 601

    trainer, launches, train_s = run_training(argv, check_step,
                                              "train_synth_quality")
    obs = trainer.obs
    check_training(obs, launches, iterations, 2, [600, 700, 800, 900, 1000],
                   "train_synth_quality")
    evals = {e["step"]: e for e in obs["evaluations"]}
    check(500 in evals and 1000 in evals,
          f"train_synth_quality: evaluations at {sorted(evals)}")
    psnr_1000 = evals[1000]["psnr"]
    check(psnr_1000 >= PSNR_SYNTH_QUALITY_1000,
          f"train_synth_quality: held-out PSNR {psnr_1000} at 1000 < "
          f"{PSNR_SYNTH_QUALITY_1000}")

    # TensorBoard: the step scalars at 1 and every 10, the evaluation's
    # scalars, histogram and panels at 500 and 1000.
    (events_file,) = [os.path.join(model_dir, f) for f in
                      os.listdir(model_dir) if f.startswith("events.out")]
    tags = read_tags(events_file)
    for tag in TB_STEP_TAGS:
        check(tags.get(tag) == [1] + list(range(10, iterations + 1, 10)),
              f"train_synth_quality: TensorBoard {tag} at {tags.get(tag)}")
    eval_tags = ["scene/opacity_histogram"] + [
        f"{split}/loss_viewpoint - {m}" for split in ("test", "train")
        for m in ("psnr", "ssim")] + [
        f"{split}_view_{i}/gt_vs_render" for split in ("test", "train")
        for i in range(min(5, n_test if split == "test" else 5))]
    for tag in eval_tags:
        check({500, 1000} <= set(tags.get(tag, ())),
              f"train_synth_quality: TensorBoard {tag} at {tags.get(tag)}")

    first_event = obs["events"][0]
    k1_rows, k2_rows = step_kernel_rows(obs, check_step,
                                        first_event["n_active"], 2,
                                        "train_synth_quality")
    renders = render_checkpoint(
        root, config, source, model_dir, f"chkpnt{iterations}.pkl", n_test,
        psnr_1000, "train_synth_quality", device)
    stages = staged_train_steps(trainer)
    steps = obs["steps"]
    emit(dict(
        phase="train_synth_quality", config="configs/synth/quality.yaml",
        cuts=SYNTH_QUALITY_CUTS + list(extra),
        dataset=dict(frames=frames, width=size, height=size,
                     points_scale=points_scale, seconds=gen_s,
                     ms_per_frame=frame_ms),
        oracle_card_vs_cpu_max_abs=oracle_err,
        iterations=iterations, n_active_initial=obs["initial"],
        events=obs["events"],
        n_active_after_events=[e["n_active"] for e in obs["events"]],
        ms_per_densify_event=[e["ms"] for e in obs["events"]],
        step_ms_median_before_first_event=median_step_ms(steps, 2, 600),
        step_ms_median_after_first_event=median_step_ms(steps, 602,
                                                        iterations + 1),
        staged_step_ms_median=stages,
        steps_per_s=iterations / train_s, train_s=train_s,
        evaluate=[dict(step=e["step"], seconds=e["ms"] / 1e3,
                       psnr=e["psnr"], splits=e["splits"])
                  for e in obs["evaluations"]],
        psnr_ssim_at=dict((str(it), evals[it]["splits"]["test"])
                          for it in (0, 500, 1000) if it in evals),
        tensorboard=dict(file=os.path.basename(events_file),
                         tags=sorted(tags)),
        k1=k1_rows, k2=k2_rows, launches=launches,
        evaluation_views=obs["views"], **renders,
        seconds=time.perf_counter() - t0))
    return (launches, renders["render_cli"]["fast"]["launches"]["k3"],
            median_step_ms(steps, 2, 600))


def gt_cache_expected(trainer):
    """The JAX trainer's rule (fourdgs_tpu/engine/trainer.py:356-372) for
    holding the train images on the device: frames of one size, at most
    cfg.gt_cache_mb of f32 rgb + alpha; the dataloader flag plays no part."""
    cams = trainer.scene.train_cameras
    same = all((c.width, c.height) == (cams[0].width, cams[0].height)
               for c in cams)
    mb = len(cams) * cams[0].height * cams[0].width * 16 / 1e6
    return bool(cams) and same and 0 < trainer.cfg.gt_cache_mb and \
        mb <= trainer.cfg.gt_cache_mb, mb


def train_synth_dynerf_phase(device, size=400, n_cams=15, data=(),
                             extra=()):
    """configs/synth/dynerf_quality.yaml: the DyNeRF-modality dataset
    generated on the card (a rig of 15 cameras, camera 0 held out, RGBA
    frames over a procedural sky), then 200 iterations trained as the
    config is (the lazy dataloader, batch 4, the 128x128 env map trained
    from 0, the opacity-mask, rigid and motion losses together), one
    densify event at 200 and an evaluation at 200; K1 and K2 held to their
    plain versions on the four cameras of step 101. `data` and `extra`: a
    rehearsal's cuts. Returns the training's launch counts."""
    t0 = time.perf_counter()
    root = os.path.join(ROOT, "build", "synth_dynerf")
    shutil.rmtree(root, ignore_errors=True)
    source, model_dir = os.path.join(root, "data"), os.path.join(root, "model")
    gen_s, frames, frame_ms = generate(
        ["--dynerf", "--out", source, "--n_cams", str(n_cams),
         "--size", str(size), "--device", str(device),
         *SYNTH_DYNERF_DATA, *data], "train_synth_dynerf")
    config = os.path.join(ROOT, "configs", "synth", "dynerf_quality.yaml")
    argv = ["--config", config, "--device", str(device), "--quiet",
            "--override", f"model.source_path={source}",
            f"model.model_path={model_dir}"] + SYNTH_DYNERF_CUTS + list(extra)
    # Step 101: inside the run, a step with no event before it.
    iterations, check_step = 200, 101

    trainer, launches, train_s = run_training(argv, check_step,
                                              "train_synth_dynerf")
    obs = trainer.obs
    check(trainer.cfg.model.dataloader and trainer.cfg.batch_size == 4
          and trainer.cfg.pipeline.env_map_res == 128,
          "train_synth_dynerf: not the config's dataloader, batch, env map")
    check_training(obs, launches, iterations, 4, [200], "train_synth_dynerf")
    before, after = obs["evaluations"][0], obs["evaluations"][-1]
    check(before["step"] == 0 and after["step"] == iterations
          and after["psnr"] > before["psnr"],
          f"train_synth_dynerf: test PSNR {before['psnr']} -> "
          f"{after['psnr']}")
    env_moved = float(trainer.env.texture.abs().max())
    check(env_moved > 0, "train_synth_dynerf: the env texture did not move")
    with open(os.path.join(model_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    # Both terms positive on every logged step, and at the last one above
    # the 1e-12 floor of their zero-safe norms (the velocities start at 0).
    terms = [(r["rigid"], r["motion"]) for r in rows if "loss" in r]
    check(terms and all(rg > 0 and mo > 0 for rg, mo in terms)
          and min(terms[-1]) > 1e-11,
          f"train_synth_dynerf: rigid and motion terms {terms[0]} -> "
          f"{terms[-1]} in metrics.jsonl")
    cached, cache_mb = gt_cache_expected(trainer)
    check((trainer._gt_cache is not None) == cached,
          f"train_synth_dynerf: GT cache {trainer._gt_cache is not None}, "
          f"the JAX trainer's rule says {cached}")
    k1_rows, k2_rows = step_kernel_rows(obs, check_step, obs["initial"], 4,
                                        "train_synth_dynerf")
    stages = staged_train_steps(trainer)
    steps = obs["steps"]
    emit(dict(
        phase="train_synth_dynerf",
        config="configs/synth/dynerf_quality.yaml",
        cuts=SYNTH_DYNERF_CUTS + SYNTH_DYNERF_DATA + list(data) + list(extra),
        dataset=dict(frames=frames, width=size, height=size, cameras=n_cams,
                     seconds=gen_s, ms_per_frame=frame_ms),
        train_frames=len(trainer.scene.train_cameras),
        gt_cache=dict(on_device=trainer._gt_cache is not None, mb=cache_mb),
        iterations=iterations, batch=4, n_active_initial=obs["initial"],
        events=obs["events"],
        step_ms_median=median_step_ms(steps, 2, iterations + 1),
        staged_step_ms_median=stages,
        knn_share=stages["knn"] / stages["total"],
        steps_per_s=iterations / train_s, train_s=train_s,
        evaluate=[dict(step=e["step"], seconds=e["ms"] / 1e3,
                       psnr=e["psnr"], splits=e["splits"])
                  for e in obs["evaluations"]],
        psnr_before=before["psnr"], psnr_after=after["psnr"],
        env_texture_max_abs=env_moved,
        rigid_motion_first_last=[terms[0], terms[-1]],
        k1=k1_rows, k2=k2_rows, launches=launches, evaluation_views=obs["views"],
        seconds=time.perf_counter() - t0))
    return launches

# --------------------------------------------------------------------------
# Strips: one frame as horizontal strips, and the data-parallel step
# --------------------------------------------------------------------------

# The joined strips against the full frame (tests/test_strips.py:42-45).
# A strip renders as its window of the frame (parallel/strips.py), whose
# rows are the full frame's bit for bit on the CPU.
TOL_STRIPS = 2e-5
STRIP_TIMED = 5


def view_ms(evaluator, cam, reps=STRIP_TIMED):
    """Median ms of `reps` views of `cam` (host clock, synchronised)."""
    wall = []
    for _ in range(reps):
        t1 = time.perf_counter()
        evaluator.render_view(cam)
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t1) * 1e3)
    return float(np.median(wall))


def strip_views(evaluator, mesh, cams, counts, label):
    """Each view of `cams` through `evaluator` with cfg.strips = n for each
    n of `counts`, its strips on `mesh`, exact (K1) and fast (K3): the
    joined frame within TOL_STRIPS of the full frame of the same path, n
    launches of the path's kernel and none of the other, no dropped
    instance, fast within TOL_INFER of exact; ms per view beside the full
    frame's on cams[0], and the launches of a view with no mesh (one: the
    full frame). Returns the rows and the main path's K1 and K3
    launches."""
    rows, k1, k3 = [], 0, 0
    for n in counts:
        for fast in (False, True):
            evaluator.eval_infer = fast
            path = "k3" if fast else "k1"
            err = 0.0
            for cam in cams:
                evaluator.cfg.strips, evaluator.mesh = 1, None
                full = evaluator.render_view(cam)
                evaluator.cfg.strips, evaluator.mesh = n, mesh
                torch.cuda.synchronize()
                zero_launches()
                joined = evaluator.render_view(cam)
                torch.cuda.synchronize()
                launches = read_launches()
                want = {"k1": 0, "k2": 0, "k3": 0, path: n}
                check(launches == want, f"{label} strips={n}: launches "
                      f"{launches}, expected {want}")
                k1, k3 = k1 + launches["k1"], k3 + launches["k3"]
                check(evaluator.last_counts["instances_dropped"] == 0,
                      f"{label} strips={n}: instances dropped")
                for a, b in zip(joined, full):
                    check(a.shape == b.shape, f"{label}: joined shape")
                    err = max(err, float((a - b).abs().max()))
            check(err <= TOL_STRIPS, f"{label} strips={n} fast={fast}: "
                  f"joined strips differ from the full frame by {err}")
            strip_ms = view_ms(evaluator, cams[0])
            evaluator.mesh = None
            torch.cuda.synchronize()
            zero_launches()
            evaluator.render_view(cams[0])
            torch.cuda.synchronize()
            alone = read_launches()
            check(alone == {"k1": 0, "k2": 0, "k3": 0, path: 1},
                  f"{label} strips={n} with no mesh: launches {alone}, "
                  "expected the full frame's one")
            evaluator.cfg.strips = 1
            full_ms = view_ms(evaluator, cams[0])
            rows.append(dict(strips=n, fast=fast, views=len(cams),
                             strip_rows=evaluator.opts.height // n,
                             max_abs_vs_full=err, view_ms=strip_ms,
                             full_frame_view_ms=full_ms,
                             no_mesh_launches=alone[path]))
        evaluator.cfg.strips, evaluator.mesh = n, mesh
        diffs = [fast_vs_exact(evaluator, cam, f"{label} strips={n}")[0]
                 for cam in cams]
        rows[-1]["fast_vs_exact"] = diffs
    evaluator.cfg.strips, evaluator.eval_infer = 1, False
    evaluator.mesh = None
    return rows, k1, k3


def strips_eval_phase(evaluator_800, env_evaluator_1352, env_cam, mesh):
    """a. Strip views on `mesh` of the eval phase's 100k checkpoint at
    800x800 (2 and 4 strips: 400 and 200 rows) and of the 300k 1352x1014
    env-map checkpoint (2 and 3 strips: 507 and 338 rows)."""
    fast_env = env_evaluator_1352.eval_infer
    rows_800, k1_a, k3_a = strip_views(
        evaluator_800, mesh, evaluator_800.scene.test_cameras, (2, 4),
        "strips_eval_800x800")
    rows_env, k1_b, k3_b = strip_views(
        env_evaluator_1352, mesh, [env_cam], (2, 3),
        "strips_eval_1352x1014_env")
    env_evaluator_1352.eval_infer = fast_env
    emit(dict(phase="strips_eval", tolerance_vs_full=TOL_STRIPS,
              eval_800x800=rows_800, eval_1352x1014_env=rows_env,
              launches=dict(k1=k1_a + k1_b, k3=k3_a + k3_b)))
    return k1_a + k1_b, k3_a + k3_b


def capture_train_step(check_step, made):
    """A stand-in for engine.trainer's `train_step` that runs it and
    records the inputs and outputs of training step `check_step` in
    `made`."""
    def recording(state, step, *args, **kwargs):
        out = train.train_step(state, step, *args, **kwargs)
        if step == check_step:
            made.append((state, step, args, kwargs, out))
        return out
    return recording


def rerun_full_frame(captured, label):
    """The captured strip step run again with strips=1 and no mesh on the
    same state and inputs: loss rtol 1e-5, PSNR rtol 1e-4, xyz atol 1e-5,
    xyz_grad_accum atol 1e-5 rtol 1e-4, max_radii2d atol 1e-4 against
    the strip step (tests/test_parallel.py:117-127)."""
    state, step, args, kwargs, (new, _, m) = captured
    full, _, fm = train.train_step(state, step, *args,
                                   **dict(kwargs, strips=1, mesh=None))
    torch.cuda.synchronize()

    def close(a, b, atol, rtol=0.0):
        return float(((a - b).abs() - atol - rtol * b.abs()).max()) <= 0.0

    out = dict(
        loss=[float(m.loss), float(fm.loss)],
        psnr=[float(m.psnr), float(fm.psnr)],
        xyz_max_abs=float((new.params.xyz - full.params.xyz).abs().max()),
        xyz_grad_accum_max_abs=float(
            (new.xyz_grad_accum - full.xyz_grad_accum).abs().max()),
        max_radii2d_max_abs=float(
            (new.max_radii2d - full.max_radii2d).abs().max()))
    check(abs(float(m.loss) - float(fm.loss)) <= 1e-5 * abs(float(fm.loss))
          and abs(float(m.psnr) - float(fm.psnr))
          <= 1e-4 * abs(float(fm.psnr))
          and close(new.params.xyz, full.params.xyz, 1e-5)
          and close(new.xyz_grad_accum, full.xyz_grad_accum, 1e-5, 1e-4)
          and close(new.max_radii2d, full.max_radii2d, 1e-4),
          f"{label}: the strip step against the full frame: {out}")
    return out


SYNTH_STRIPS_CUTS = ["optimization.iterations=200", "test_iterations=[200]",
                     "save_iterations=[]", "strips=2"]


def train_synth_strips_phase(device, quality_step_ms, extra=()):
    """b. configs/synth/quality.yaml on train_synth_quality's dataset with
    strips=2 (200-row strips, 12.5 tile rows) for 200 iterations through
    `fourdgs_tpu_torch.train.main`, under the open process group of one
    rank (so that a mesh holds the strips; with no group the Trainer
    trains the full frames): exactly 2·2 K1 and 2·2 K2 per step, a
    finite loss, held-out PSNR up; K1 and K2 held to their plain versions
    on the four strips of step 101, and that step run again as full
    frames. Returns the launch counts."""
    from fourdgs_tpu_torch.engine import trainer as trainer_mod

    t0 = time.perf_counter()
    root = os.path.join(ROOT, "build", "synth_quality")
    source = os.path.join(root, "data")
    model_dir = os.path.join(root, "model_strips")
    shutil.rmtree(model_dir, ignore_errors=True)
    config = os.path.join(ROOT, "configs", "synth", "quality.yaml")
    argv = ["--config", config, "--device", str(device), "--quiet",
            "--override", f"model.source_path={source}",
            f"model.model_path={model_dir}"] + SYNTH_STRIPS_CUTS + list(extra)
    iterations, check_step, n = 200, 101, 2
    captured = []
    base_step = trainer_mod.train_step
    trainer_mod.train_step = capture_train_step(check_step, captured)
    try:
        trainer, launches, train_s = run_training(argv, check_step,
                                                  "train_synth_strips")
    finally:
        trainer_mod.train_step = base_step
    obs = trainer.obs
    check(trainer.cfg.strips == n and trainer.mesh is not None,
          "train_synth_strips: strips not set or no mesh")
    steps = obs["steps"]
    check(len(steps) == iterations, f"train_synth_strips: {len(steps)} "
          "steps")
    for st in steps:
        check(np.isfinite(st["loss"]) and st["dropped"] == 0,
              f"train_synth_strips it {st['it']}: loss {st['loss']}, "
              f"dropped {st['dropped']}")
    check(not obs["events"], "train_synth_strips: a densify event")
    batch = trainer.cfg.batch_size
    want = dict(k1=batch * n * iterations + n * obs["views"],
                k2=batch * n * iterations, k3=0)
    check(launches == want, f"train_synth_strips: launches {launches}, "
          f"expected {want} ({obs['views']} evaluation views)")
    before, after = obs["evaluations"][0], obs["evaluations"][-1]
    check(before["step"] == 0 and after["step"] == iterations
          and after["psnr"] > before["psnr"],
          f"train_synth_strips: test PSNR {before['psnr']} -> "
          f"{after['psnr']}")
    k1_rows, k2_rows = step_kernel_rows(obs, check_step, obs["initial"],
                                        batch * n, "train_synth_strips")
    check(len(captured) == 1, "train_synth_strips: step not captured")
    full_frame = rerun_full_frame(captured[0], "train_synth_strips")
    emit(dict(
        phase="train_synth_quality_strips",
        config="configs/synth/quality.yaml",
        cuts=SYNTH_STRIPS_CUTS + list(extra), strips=n,
        strip_rows=trainer.opts.height // n, iterations=iterations,
        step_ms_median=median_step_ms(steps, 2, iterations + 1),
        full_frame_step_ms_median=quality_step_ms,
        steps_per_s=iterations / train_s, train_s=train_s,
        psnr_before=before["psnr"], psnr_after=after["psnr"],
        loss_first=steps[0]["loss"], loss_last=steps[-1]["loss"],
        step_vs_full_frame=full_frame, k1=k1_rows, k2=k2_rows,
        launches=launches, evaluation_views=obs["views"],
        seconds=time.perf_counter() - t0))
    return launches


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


# |a − b| / |b| (L2) per leaf, or three times that of two train_steps on
# the same inputs where that is larger.
TOL_DP = 1e-6


def data_parallel_phase(device, mesh, p=100_000, hw=800, steps=3):
    """c. The data-parallel step (parallel/mesh.py) on one card: on
    `mesh`, a world-size-1 NCCL group, 3 lego steps at 800x800 (batch 2)
    through the sharded step, each held to train_step on the same state and inputs:
    the loss within TOL_DP, and the gradients, statistics and (where the
    gradient is above 1e-3 of its leaf's largest) parameters within TOL_DP
    in the relative L2 norm of each leaf, or 3x train_step's own
    run-to-run spread on the card, whichever is larger; all-reduce ms per
    step from CUDA events. Returns the launch counts."""
    import torch.distributed as dist

    from fourdgs_tpu_torch.parallel import make_sharded_train_step

    scene = bench_scene(p, seed=0)
    params = gaussians.GaussianParams(**{
        k: torch.as_tensor(np.asarray(v, np.float32), device=device)
        for k, v in raw_params(scene).items()})
    state = gaussians.new_state(params, p)
    opts = pre.RenderOptions(height=hw, width=hw, gaussian_dim=4,
                             rot_4d=True, time_duration=1.0)
    cams = [camera(hw, hw, ts, device) for ts in (0.3, 0.6)]
    rng = np.random.default_rng(0)
    gt = torch.as_tensor(rng.random((2, hw, hw, 3)).astype(np.float32),
                         device=device)
    mask = torch.ones((2, hw, hw), device=device)
    bg = torch.zeros(3, device=device)

    step_fn = make_sharded_train_step(opts, LEGO, mesh, batch_size=2)
    step_fn(state, FIRST_STEP, cams, gt, mask, bg)        # warm-up
    torch.cuda.synchronize()

    # The main path: counts zeroed just before, read just after.
    states, metrics, wall = [state], [], []
    zero_launches()
    for i in range(steps):
        t1 = time.perf_counter()
        new, _, m = step_fn(states[-1], FIRST_STEP + i, cams, gt, mask,
                            bg)
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t1) * 1e3)
        states.append(new)
        metrics.append(m)
    launches = read_launches()
    check(launches == dict(k1=2 * steps, k2=2 * steps, k3=0),
          f"data_parallel: launches {launches}")

    def leaves(st, ref, prev):
        """Each leaf the step writes, by name: Adam's first moments
        (the gradients), the statistics, and the parameters where the
        gradient of the step `ref` is above 1e-3 of its leaf's largest
        (Adam moves the others by ±lr whatever their size)."""
        out = {f"grad_{f}": x for f, x in zip(st.params._fields,
                                               st.adam.mu)}
        out.update({f: getattr(st, f) for f in (
            "xyz_grad_accum", "t_grad_accum", "denom", "max_radii2d")})
        for f, x, mw, m0 in zip(st.params._fields, st.params,
                                ref.adam.mu, prev.adam.mu):
            g = (mw - 0.9 * m0).abs()        # 0.1 x the gradient
            out[f"param_{f}"] = torch.where(
                g > 1e-3 * float(g.max()), x, 0.0)
        return out

    def rel(a, b):
        """|a − b| / |b| in the L2 norm: stable under the card's
        atomic-order noise, where the largest single difference (a
        sum that cancels) is not."""
        return float(torch.linalg.vector_norm((a - b).double())) / max(
            float(torch.linalg.vector_norm(b.double())), 1e-30)

    def rel_max(a, b):
        return float((a - b).abs().max()) / max(float(b.abs().max()),
                                                1e-30)

    # train_step twice per step: the card's own run-to-run spread
    # (K2's atomics and the preprocess backward's scatter-adds sum in
    # another order on every run) is the floor of the comparison.
    compared = []
    for i, dm in enumerate(metrics):
        want, _, wm = train.train_step(states[i], FIRST_STEP + i, cams,
                                       gt, mask, bg, LEGO, opts)
        again = train.train_step(states[i], FIRST_STEP + i, cams, gt,
                                 mask, bg, LEGO, opts)[0]
        w, a, d = (leaves(x, want, states[i]) for x in (
            want, again, states[i + 1]))
        err = {k: rel(d[k], w[k]) for k in w}
        spread = {k: rel(a[k], w[k]) for k in w}
        bad = {k: (err[k], spread[k]) for k in w
               if err[k] > max(TOL_DP, 3.0 * spread[k])}
        loss = abs(float(dm.loss) - float(wm.loss)) / abs(float(wm.loss))
        worst = max(err, key=err.get)
        compared.append(dict(
            step=FIRST_STEP + i, loss_rel=loss, l2_rel=err[worst],
            leaf=worst, spread_of_that_leaf=spread[worst],
            max_spread=max(spread.values()),
            max_abs_rel=max(rel_max(d[k], w[k]) for k in w),
            max_abs_rel_spread=max(rel_max(a[k], w[k]) for k in w)))
        check(loss <= TOL_DP and not bad,
              f"data_parallel step {i}: loss {loss}, beyond "
              f"max({TOL_DP}, 3 x train_step's spread): {bad}")

    splits = []
    for i in range(3):
        total, parts = staged(lambda mark: step_fn(
            states[-1], FIRST_STEP + steps + i, cams, gt, mask, bg,
            mark=mark))
        splits.append(dict(total=total, all_reduce=dict(parts)[
            "all_reduce"]))
    single = [staged(lambda mark: train.train_step(
        states[-1], FIRST_STEP + steps + i, cams, gt, mask, bg, LEGO,
        opts))[0] for i in range(3)]
    emit(dict(
        phase="data_parallel", backend=dist.get_backend(),
        world_size=mesh.size, gaussians=p, height=hw, width=hw, batch=2,
        steps=steps, step_ms=wall, compared=compared, tolerance=TOL_DP,
        all_reduce_ms_median=float(np.median(
            [s["all_reduce"] for s in splits])),
        step_ms_median_staged=float(np.median(
            [s["total"] for s in splits])),
        train_step_ms_median_staged=float(np.median(single)),
        all_reduce_floats=sum(x.numel() for x in state.params)
        + 2 * p * 3 + 7, launches=launches))
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    device = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. device
    card = card_line()
    print(card, flush=True)
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": card, "kind": kind,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    # 2. build
    t0 = time.perf_counter()
    builds = cuda_build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "kernels": [dict(name=b.name, path=os.path.relpath(b.path, ROOT),
                           flags=" ".join(b.flags), nvcc_seconds=b.seconds,
                           ptxas=[ln.strip() for ln in b.log.splitlines()
                                  if "registers" in ln or "smem" in ln])
                      for b in builds]})

    # 3. kernel vs plain
    kernel_cases(device)

    # 4. full-width serving, 100k gaussians at 800x800
    rows, launches = serve("serve_800x800", 100_000, 800, 800, 1.0, -4.2,
                           (0.1, 0.4, 0.7, 0.95), timed=12, device=device)
    # 5. the DyNeRF shape: 300k at 1352x1014 (partial tiles at full width)
    serve("dynerf_1352x1014", 300_000, 1014, 1352, 10.0, -4.9, (0.5,),
          timed=5, device=device)

    # 6. the lego training step at full width
    k2_rows, train_launches = train_phase(device)

    # 7. evaluation from files through render_cli (K3), 8. the DyNeRF
    # shape with an environment map, 9. the viewer socket
    evaluator, k3_row_800, eval_k3 = eval_phase(device)
    env_k3, env_eval, env_cam = eval_env_phase(device)
    viewer_k3 = viewer_phase(evaluator)

    # 10. the lego config trained end to end from a scene on disk
    lego_launches, lego_k3 = train_lego_phase(device)
    # 11. the configs/synth scenarios: datasets generated on the card, then
    # synth/quality.yaml's first 1000 iterations and dynerf_quality.yaml
    synth_launches, synth_k3, synth_step_ms = train_synth_quality_phase(
        device)
    dynerf_launches = train_synth_dynerf_phase(device)

    # 13. strips, in a process group of this process alone: a. strip
    # views, b. strip training, c. the data-parallel step on one card
    multihost.initialize(f"127.0.0.1:{free_port()}", 1, 0, device=device)
    try:
        mesh = multihost.global_mesh()
        strips_k1, strips_k3 = strips_eval_phase(evaluator, env_eval,
                                                 env_cam, mesh)
        del env_eval
        strips_launches = train_synth_strips_phase(device, synth_step_ms)
        dp_launches = data_parallel_phase(device, mesh)
    finally:
        torch.distributed.destroy_process_group()

    # 14. kernel summary: K1 at the 800x800 requests (means over the four),
    # K2 at the first training step's two cameras (means over the two), K3
    # at the first 800x800 evaluation view.
    mean = lambda rs, key: float(np.mean([r[key] for r in rs]))  # noqa: E731
    emit({"phase": "warp_walk",
          "blend_forward": [dict(timestamp=r["timestamp"], **r["cull"])
                            for r in rows],
          "blend_backward": [dict(camera=r["camera"], **r["cull"],
                                  **r["traffic"]) for r in k2_rows],
          "blend_infer": k3_row_800["cull"]})
    emit({"kernels": [{
        "name": "blend_forward",
        "route": "cuda",
        "source": "fourdgs_tpu_torch/csrc/blend_forward.cu",
        "replaces": "fourdgs_tpu/ops/pallas_blend.py:405",
        "launches": train_launches["k1"],
        "launches_by_path": {"serve_800x800": launches,
                             "train_800x800": train_launches["k1"],
                             "train_lego_densify": lego_launches["k1"],
                             "train_synth_quality": synth_launches["k1"],
                             "train_synth_dynerf": dynerf_launches["k1"],
                             "strips_eval": strips_k1,
                             "train_synth_quality_strips":
                                 strips_launches["k1"],
                             "data_parallel": dp_launches["k1"]},
        "max_abs_err": max(max(r["accum_err"], r["t_final_err"])
                           for r in rows),
        "ms": mean(rows, "kernel_ms"),
        "plain_ms": mean(rows, "plain_ms"),
        "bound_ms": mean(rows, "bound_ms"),
        "bound_by": rows[0]["bound_by"],
        "library_ms": None,
    }, {
        "name": "blend_backward",
        "route": "cuda",
        "source": "fourdgs_tpu_torch/csrc/blend_backward.cu",
        "replaces": "fourdgs_tpu/ops/pallas_blend.py:606",
        "launches": train_launches["k2"],
        "launches_by_path": {"train_800x800": train_launches["k2"],
                             "train_lego_densify": lego_launches["k2"],
                             "train_synth_quality": synth_launches["k2"],
                             "train_synth_dynerf": dynerf_launches["k2"],
                             "train_synth_quality_strips":
                                 strips_launches["k2"],
                             "data_parallel": dp_launches["k2"]},
        "max_abs_err": max(r["abs_err"] for r in k2_rows),
        # |k - p| / max(|p|.max(), 1e-3) per record column, held to 2e-4
        "max_scaled_err": max(r["grad_err"] for r in k2_rows),
        "ms": mean(k2_rows, "ms"),
        "plain_ms": mean(k2_rows, "plain_ms"),
        "bound_ms": mean(k2_rows, "bound_ms"),
        "bound_by": k2_rows[0]["bound_by"],
        "library_ms": None,
    }, {
        "name": "blend_infer",
        "route": "cuda",
        "source": "fourdgs_tpu_torch/csrc/blend_infer.cu",
        "replaces": "fourdgs_tpu/ops/pallas_blend.py:1122",
        "launches": eval_k3,
        "launches_by_path": {"eval_800x800": eval_k3,
                             "eval_1352x1014_env": env_k3,
                             "viewer": viewer_k3,
                             "train_lego_densify_render_cli": lego_k3,
                             "train_synth_quality_render_cli": synth_k3,
                             "strips_eval_fast": strips_k3},
        "max_abs_err": max(k3_row_800["accum_err"],
                           k3_row_800["t_final_err"]),
        "ms": k3_row_800["ms"],
        "plain_ms": k3_row_800["plain_ms"],
        "bound_ms": k3_row_800["bound_ms"],
        "bound_by": k3_row_800["bound_by"],
        "library_ms": None,
    }], "card": card})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
