#!/usr/bin/env python3
"""Time versions of the port's blend kernels in turns, on one card in one
process, at the shapes of chip_smoke.py's main paths.

    python3 scripts/torch_kernel_turns.py FORWARD[,...] BACKWARD[,...] \\
        [INFER[,...]]

Each name is a source `fourdgs_tpu_torch/csrc/<name>.cu` that exports
`blend_forward_launch` (first list), `blend_backward_launch` (second
list) or `blend_infer_launch` (third list) with the committed kernels'
arguments; any list may be empty (""). To compare a kernel with an
earlier commit's, put that commit's source beside the new one under
another name and leave it uncommitted:

    git show <commit>:fourdgs_tpu_torch/csrc/blend_infer.cu \\
        > fourdgs_tpu_torch/csrc/blend_infer_old.cu
    python3 scripts/torch_kernel_turns.py "" "" blend_infer_old,blend_infer

Every source is built with `-fmad=false`, as the committed kernels are,
and its registers, shared memory and spills are printed (ptxas). The
forward kernels run on the four 800x800 requests of the 100k cloud and on
the 1352x1014 view of the 300k cloud; the backward kernels on the inputs of
both cameras of the first lego training step (captured through
`blend_backward.observer`); the packed inference kernels on chip_smoke's
two evaluation views, the first 800x800 test view of the checkpoint it
writes to disk and the 1352x1014 view of the 300k cloud with an
environment map. Each version is first held to the plain version
(forward: largest differences of accum and T_final and the share of
equal n_contrib; backward: the scale-normalised gradient error; packed
inference: largest differences of accum and T_final, 0.0 when it is
bit-exact), then
all are timed in the order given and once more in reverse (old, new, new,
old), 20 launches between CUDA events after one warm-up launch. One JSON
line per view and per camera; times in ms, in the order measured.
"""

from __future__ import annotations

import ctypes
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from fourdgs_tpu_torch import cuda_build  # noqa: E402
from fourdgs_tpu_torch.config import load_config  # noqa: E402
from fourdgs_tpu_torch.engine import step as train  # noqa: E402
from fourdgs_tpu_torch.engine.evaluator import Evaluator  # noqa: E402
from fourdgs_tpu_torch.models import gaussians  # noqa: E402
from fourdgs_tpu_torch.ops import blend  # noqa: E402
from fourdgs_tpu_torch.ops import preprocess as pre  # noqa: E402
from fourdgs_tpu_torch.render import blend_inputs  # noqa: E402

_VOID, _INT = ctypes.c_void_p, ctypes.c_int
REPS = 20


def _stream():
    return torch.cuda.current_stream().cuda_stream


def forward_version(name):
    """`launch_forward` of ops/blend.py for the library `name`."""
    fn = cuda_build.load(name).blend_forward_launch
    fn.argtypes = [_VOID] * 4 + [_INT] * 2 + [_VOID] * 4
    fn.restype = _INT

    def run(rec, gauss_id, tile_start, tile_count, tiles_x):
        tiles = tile_start.shape[0]
        accum = torch.empty((tiles, blend.NUM_FEAT, blend.PIX),
                            device=rec.device)
        t_final = torch.empty((tiles, blend.PIX), device=rec.device)
        n_contrib = torch.empty((tiles, blend.PIX), dtype=torch.int32,
                                device=rec.device)
        err = fn(rec.data_ptr(), gauss_id.data_ptr(), tile_start.data_ptr(),
                 tile_count.data_ptr(), tiles, tiles_x, accum.data_ptr(),
                 t_final.data_ptr(), n_contrib.data_ptr(), _stream())
        if err != 0:
            raise RuntimeError(f"{name}: CUDA error {err}")
        return accum, t_final, n_contrib
    return run


def backward_version(name):
    """`launch_backward` of ops/blend.py for the library `name`."""
    fn = cuda_build.load(name).blend_backward_launch
    fn.argtypes = [_VOID] * 6 + [_INT] * 2 + [_VOID] * 2
    fn.restype = _INT

    def run(rec, gauss_id, tile_start, t_final, n_contrib, dcot, tiles_x):
        d_rec = torch.zeros_like(rec)
        err = fn(rec.data_ptr(), gauss_id.data_ptr(), tile_start.data_ptr(),
                 t_final.data_ptr(), n_contrib.data_ptr(), dcot.data_ptr(),
                 tile_start.shape[0], tiles_x, d_rec.data_ptr(), _stream())
        if err != 0:
            raise RuntimeError(f"{name}: CUDA error {err}")
        return d_rec
    return run


def infer_version(name):
    """`launch_infer` of ops/blend.py for the library `name`."""
    fn = cuda_build.load(name).blend_infer_launch
    fn.argtypes = [_VOID] * 4 + [_INT] * 2 + [_VOID] * 3
    fn.restype = _INT

    def run(packed, gauss_id, tile_start, tile_count, tiles_x):
        tiles = tile_start.shape[0]
        accum = torch.empty((tiles, blend.NUM_FEAT_INFER, blend.PIX),
                            device=packed.device)
        t_final = torch.empty((tiles, blend.PIX), device=packed.device)
        err = fn(packed.data_ptr(), gauss_id.data_ptr(),
                 tile_start.data_ptr(), tile_count.data_ptr(), tiles,
                 tiles_x, accum.data_ptr(), t_final.data_ptr(), _stream())
        if err != 0:
            raise RuntimeError(f"{name}: CUDA error {err}")
        return accum, t_final
    return run


def forward_views(device):
    """(label, K1's arguments) of chip_smoke's served requests."""
    views = []
    for p, h, w, duration, scale_mu, stamps in (
            (100_000, 800, 800, 1.0, -4.2, (0.1, 0.4, 0.7, 0.95)),
            (300_000, 1014, 1352, 10.0, -4.9, (0.5,))):
        model = gaussians.from_jax_params(
            cs.raw_params(cs.bench_scene(p, 0, scale_mu)), p, device=device)
        opts = pre.RenderOptions(height=h, width=w, gaussian_dim=4,
                                 rot_4d=True, time_duration=duration)
        act = model.activate()._asdict()
        for ts in stamps:
            _, bins, rec = blend_inputs(
                **act, camera=cs.camera(w, h, ts, device), opts=opts)
            views.append((f"{w}x{h} t={ts}", cs.kernel_args(rec, bins, opts)))
    return views


def backward_cameras(device, p=100_000, hw=800):
    """K2's arguments for both cameras of chip_smoke's first training
    step."""
    params = gaussians.GaussianParams(**{
        k: torch.as_tensor(np.asarray(v, np.float32), device=device)
        for k, v in cs.raw_params(cs.bench_scene(p, 0)).items()})
    opts = pre.RenderOptions(height=hw, width=hw, gaussian_dim=4,
                             rot_4d=True, time_duration=1.0)
    cams = [cs.camera(hw, hw, ts, device) for ts in (0.3, 0.6)]
    gt = torch.as_tensor(np.random.default_rng(0).random(
        (2, hw, hw, 3)).astype(np.float32), device=device)
    captured = []
    blend.blend_backward.observer = lambda args, out: captured.append(
        tuple(a.detach() if torch.is_tensor(a) else a for a in args))
    try:
        train.train_step(gaussians.new_state(params, p), cs.FIRST_STEP, cams,
                         gt, torch.ones((2, hw, hw), device=device),
                         torch.zeros(3, device=device), cs.LEGO, opts)
    finally:
        blend.blend_backward.observer = None
    torch.cuda.synchronize()
    return captured


def infer_views(device):
    """(label, K3's arguments) of chip_smoke's evaluation views."""
    root = os.path.join(ROOT, "build", "eval_800x800")
    cfg_path = cs.write_eval_scene(root, 100_000, 800, device)
    evaluator = Evaluator(load_config(cfg_path), device=device, verbose=False)
    evaluator.load(os.path.join(root, "model", "chkpnt30000.pkl"))
    views = [("800x800 view 0", evaluator, evaluator.scene.test_cameras[0]),
             ("1352x1014 env", *cs.env_evaluator(device, 300_000, 1014,
                                                  1352, 500))]
    out = []
    for label, ev, cam in views:
        packed, bins, _ = cs.infer_inputs(ev, cam)
        out.append((label, cs.kernel_args(packed, bins, ev.opts)))
    return out


def in_turns(versions, args):
    """{name: [ms, ms]}: every version timed in the order given, then in
    reverse."""
    names = list(versions)
    times = {name: [] for name in names}
    for name in names + names[::-1]:
        times[name].append(
            cs.time_call(lambda: versions[name](*args), REPS))
    return times


def main(argv) -> int:
    if len(argv) not in (2, 3):
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("torch_kernel_turns: no CUDA device", file=sys.stderr)
        return 1
    forward, backward, infer = ([n for n in arg.split(",") if n]
                                for arg in (*argv, "")[:3])
    device = torch.device("cuda:0")
    print(cs.card_line(), flush=True)
    for name in forward + backward + infer:
        cuda_build.KERNEL_FLAGS[name] = ("-fmad=false",)
        build = cuda_build.build(name)
        cs.emit(dict(build=name, nvcc_seconds=build.seconds, ptxas=[
            ln.strip() for ln in build.log.splitlines()
            if "registers" in ln or "spill" in ln]))

    if forward:
        versions = {name: forward_version(name) for name in forward}
        for label, args in forward_views(device):
            plain = blend.blend_forward_plain(*args)
            row = dict(view=label)
            for name, run in versions.items():
                row[name] = cs.errors(run(*args), plain)
            torch.cuda.synchronize()
            row["ms"] = in_turns(versions, args)
            cs.emit(row)
    if backward:
        versions = {name: backward_version(name) for name in backward}
        for cam, args in enumerate(backward_cameras(device)):
            plain = blend.blend_backward_plain(*args)
            row = dict(camera=cam)
            for name, run in versions.items():
                row[name] = dict(grad_err=cs.grad_error(run(*args), plain))
            torch.cuda.synchronize()
            row["ms"] = in_turns(versions, args)
            cs.emit(row)
    if infer:
        versions = {name: infer_version(name) for name in infer}
        for label, args in infer_views(device):
            plain = blend.blend_infer_plain(*args)
            row = dict(view=label, instances=int(args[1].numel()))
            for name, run in versions.items():
                k = run(*args)
                row[name] = dict(
                    accum_err=float((k[0] - plain[0]).abs().max()),
                    t_final_err=float((k[1] - plain[1]).abs().max()))
            torch.cuda.synchronize()
            row["ms"] = in_turns(versions, args)
            cs.emit(row)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
