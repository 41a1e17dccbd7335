#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (fourdgs_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds every CUDA kernel of fourdgs_tpu_torch/csrc/ with nvcc (into
build/kernels/, one nvcc per source, all started together), holds each
kernel against its plain PyTorch version on the card, then serves renders
of the full-width model, takes training steps on it and evaluates a
checkpoint of it from files on disk through the port's entry points, and
times them:

  1. device   the card's name and power limit (nvidia-smi); no CUDA → exit 1
  2. build    nvcc of every kernel; seconds and ptxas report
  3. kernel   the forward blend kernel K1 vs its plain version on small
              scenes: random, saturated and more than 256 instances deep,
              empty tiles, partial tiles (48x40); accum within 1e-5 abs,
              T_final within 1e-6 abs, n_contrib equal on >= 99.99% of
              pixels. The backward blend kernel K2 vs its plain version on
              the same scenes with random image cotangents (seed 2): the
              per-gaussian gradients within the scale-normalised atol 2e-4
              (|k - p| / max(|p|.max(), 1e-3), per record column)
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
 10. kernels  one JSON line per the port's kernel table: launches on the
              main paths, error, time, plain time and the card's bound for
              the pairs these inputs need

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
from fourdgs_tpu_torch.render import (  # noqa: E402
    GaussianRenderer, blend_inputs, render)
from fourdgs_tpu_torch.utils import losses  # noqa: E402
from fourdgs_tpu_torch.viewer import ViewerServer  # noqa: E402

# Published H100 SXM peaks (NVIDIA data sheet, dense, at 700 W).
PEAK_F32_OPS = 67e12        # f32 operations/s outside the tensor cores
PEAK_BYTES = 3.35e12        # HBM bytes/s
# f32 operations of csrc/blend_forward.cu per (pixel, instance) pair, by
# how far the pair goes (the classes of blend_forward_plain's pair counts).
# Every pair: dx, dy (2); power (9); the power test (1).
OPS_EVALUATED = 12
# power <= 0: CUDA's accurate expf (two range-reduction multiply-adds, one
# ex2 and one scaling multiply: 6); opa·e, the 0.99 clamp, the alpha test.
OPS_POWER_OK = 9
# alpha >= 1/255: 1 − alpha, T·(1 − alpha), the 1e-4 test.
OPS_ALPHA_OK = 3
# Used: w = alpha·T (1); 6 feature multiply-adds (12).
OPS_USED = 13
# csrc/blend_infer.cu composites 4 features: w (1) and 4 multiply-adds (8);
# the other classes cost what they cost in K1.
OPS_INFER_USED = 9
# f32 operations of csrc/blend_backward.cu, by the classes of
# blend_backward_plain's pair counts. Below the pixel's n_contrib: the
# falloff as in K1 (OPS_EVALUATED), and where power <= 0, expf and the
# alpha terms (OPS_POWER_OK).
# Used: 1 − alpha, T / (1 − alpha), w; gdot (6 mul, 5 add); dalpha (4);
# sigma (2); dpower (1); the x, y sums (2 × 3) and their gradients (2);
# the conic gradients (3 + 2 + 3); dopa (1); 4 feature gradients. A
# negation is an operand modifier, not an operation.
OPS_BWD_USED = 42
# The per-gaussian sums: NUM_GRAD adds per used pair, less NUM_GRAD per
# (warp, instance) pair with a used pixel, whose sum the atomics add.

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

    for name, (scene, h, w) in cases.items():
        opts = pre.RenderOptions(height=h, width=w)
        act = {k: torch.as_tensor(v, device=device) for k, v in scene.items()}
        proc, bins, rec = blend_inputs(
            **act, camera=camera(w, h, 0.5, device), opts=opts)
        report, k, _, _ = compare(rec, bins, opts)
        k3_report, k3, _ = compare_infer(blend.pack_records_infer(proc),
                                         bins, opts)
        k3_diff = infer_vs_exact(k3, k)
        dcot = random_cotangents(cot_rng, k[1],
                                 torch.full((3,), 0.3, device=device), opts)
        k2_err, _, pairs = compare_backward(
            backward_args(rec, bins, k, dcot, opts))
        counts = bins.tile_count
        report.update(case=name, num_rendered=bins.num_rendered,
                      max_per_tile=int(bins.max_per_tile),
                      empty_tiles=int((counts == 0).sum()),
                      launches=blend.blend_forward.launches,
                      k2_grad_err=k2_err, k2_pairs=pairs,
                      k2_launches=blend.blend_backward.launches,
                      k3_accum_err=k3_report["accum_err"],
                      k3_t_final_err=k3_report["t_final_err"],
                      k3_vs_k1=k3_diff,
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
    check(blend.blend_forward.launches >= len(cases), "K1 never launched")
    check(blend.blend_backward.launches >= len(cases), "K2 never launched")
    check(blend.blend_infer.launches >= len(cases), "K3 never launched")


# --------------------------------------------------------------------------
# Serving at full width
# --------------------------------------------------------------------------

def pair_bound_ms(pairs, bins, num_gaussians, ops_used=OPS_USED,
                  rec_bytes=blend.REC * 4, out_planes=8):
    """Least time for a forward blend on these inputs: the operations of
    the pairs they need, by class (the plain version's counts), against
    the f32 peak, or the bytes (record table, ids, ranges and the output
    planes, each once) against the memory peak, whichever is larger. The
    defaults are K1's: 48-byte records, 13 operations per used pair, 8
    output planes (6 features, T_final, n_contrib)."""
    ops = (pairs["evaluated"] * OPS_EVALUATED
           + pairs["power_ok"] * OPS_POWER_OK
           + pairs["alpha_ok"] * OPS_ALPHA_OK + pairs["used"] * ops_used)
    ops_s = ops / PEAK_F32_OPS
    tiles = bins.tile_start.numel()
    nbytes = (num_gaussians * rec_bytes + bins.num_rendered * 4
              + tiles * 8 + tiles * blend.PIX * out_planes * 4)
    bytes_s = nbytes / PEAK_BYTES
    return max(ops_s, bytes_s) * 1e3, ("operations" if ops_s >= bytes_s
                                       else "bytes"), ops


def infer_bound_ms(pairs, bins, num_gaussians):
    """`pair_bound_ms` for K3: 32-byte records, 9 operations per used
    pair, 5 output planes (4 features, T_final)."""
    return pair_bound_ms(pairs, bins, num_gaussians, OPS_INFER_USED,
                         blend.REC_INFER * 4, blend.NUM_FEAT_INFER + 1)


def backward_bound_ms(pairs, args):
    """Least time for K2 on these inputs: the operations of the pairs they
    need, by class (the plain version's counts), against the f32 peak, or
    the bytes (records, ids, tile starts, T_final, n_contrib, the
    cotangents and the (P, 12) output each once, plus 4 bytes per atomic)
    against the memory peak, whichever is larger."""
    rec, gauss_id, tile_start, t_final, _, dcot, _ = args
    ops = (pairs["evaluated"] * OPS_EVALUATED
           + pairs["power_ok"] * OPS_POWER_OK
           + pairs["used"] * OPS_BWD_USED
           + (pairs["used"] - pairs["warp_active"]) * blend.NUM_GRAD)
    ops_s = ops / PEAK_F32_OPS
    nbytes = (2 * rec.numel() * 4 + gauss_id.numel() * 4
              + tile_start.numel() * 4 + t_final.numel() * 8
              + dcot.numel() * 4 + pairs["warp_active"] * blend.NUM_GRAD * 4)
    bytes_s = nbytes / PEAK_BYTES
    return max(ops_s, bytes_s) * 1e3, ("operations" if ops_s >= bytes_s
                                       else "bytes"), ops


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
        bound_ms, bound_by, ops = pair_bound_ms(pairs, bins, p)
        row = dict(timestamp=ts, num_rendered=nr, max_per_tile=int(mpt),
                   instances_dropped=dropped, color_err_vs_plain=color_err,
                   kernel_ms=kernel_ms, plain_ms=plain_ms,
                   bound_ms=bound_ms, bound_by=bound_by, pairs=pairs,
                   operations=ops, **report)
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
            st, m = run(st, i)
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
        bound_ms, bound_by, ops = backward_bound_ms(pairs, args)
        k2_rows.append(dict(
            camera=cam_i, grad_err=err, abs_err=abs_err, pairs=pairs,
            operations=ops, bound_ms=bound_ms, bound_by=bound_by,
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

def lookat_camera(uid, angle_deg, timestamp, hw, name=""):
    """A camera on a circle of radius 5 around the bench cloud's centre
    (0, 0, 5), looking at it; angle 0 is the identity pose at the origin.
    COLMAP axes: x right, y down, z forward."""
    centre = np.array([0.0, 0.0, 5.0])
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
    bound_ms, bound_by, ops = infer_bound_ms(pairs, bins, num_gaussians)
    return dict(
        num_rendered=bins.num_rendered, max_per_tile=int(bins.max_per_tile),
        pairs=pairs, operations=ops, bound_ms=bound_ms, bound_by=bound_by,
        ms=time_call(lambda: blend.launch_infer(*args), 20),
        k1_ms=time_kernel(rec, bins, opts),
        plain_ms=time_call(lambda: blend.blend_infer_plain(*args), 1),
        k3_vs_k1=diff, **report)


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
              f"eval view {i}: fast differs from exact by {diff}")
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


def eval_env_phase(device, p=300_000, h=1014, w=1352, res=500):
    """One view of the DyNeRF-shape cloud through Evaluator with an
    environment map in the checkpoint and the packed blend."""
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
    return launches["k3"]


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
    env_k3 = eval_env_phase(device)
    viewer_k3 = viewer_phase(evaluator)

    # 10. kernel summary: K1 at the 800x800 requests (means over the four),
    # K2 at the first training step's two cameras (means over the two), K3
    # at the first 800x800 evaluation view.
    mean = lambda rs, key: float(np.mean([r[key] for r in rs]))  # noqa: E731
    emit({"kernels": [{
        "name": "blend_forward",
        "route": "cuda",
        "source": "fourdgs_tpu_torch/csrc/blend_forward.cu",
        "replaces": "fourdgs_tpu/ops/pallas_blend.py:405",
        "launches": train_launches["k1"],
        "launches_by_path": {"serve_800x800": launches,
                             "train_800x800": train_launches["k1"]},
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
                             "viewer": viewer_k3},
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
