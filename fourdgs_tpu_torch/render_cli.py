"""Render a trained checkpoint's test/train views to PNG + metrics JSON.

    python3 -m fourdgs_tpu_torch.render_cli --config configs/dnerf/lego.yaml \\
        --checkpoint output/dnerf/lego/chkpnt_best.pkl [--split test] [--fast]

PyTorch counterpart of the JAX package's `render_cli.py`: the reference eval
pipeline (training_report renders, `train.py:302-342`) as a standalone
tool, with the depth dump (`utils/image_utils.py:21`-style grayscale
ramp). Runs on `--device` (default `cuda`); it does not carry on on the CPU
when that device is missing.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="fourdgs_tpu_torch.render_cli")
    ap.add_argument("--config", required=True)
    ap.add_argument("--checkpoint", default=None,
                    help="checkpoint path (.pkl, written by this package "
                         "or by the JAX package, or a reference .pth)")
    ap.add_argument("--load_iteration", type=int, default=None,
                    help="resolve chkpnt<N>.pkl from the config's "
                         "model_path; -1 = latest (reference Scene "
                         "load_iteration, scene/__init__.py:40-47)")
    ap.add_argument("--split", default="test", choices=["test", "train"])
    ap.add_argument("--out", default=None)
    ap.add_argument("--max_views", type=int, default=0)
    ap.add_argument("--viewer", action="store_true",
                    help="serve the checkpoint to a SIBR-protocol live "
                         "viewer instead of writing files")
    ap.add_argument("--viewer_port", type=int, default=6009)
    ap.add_argument("--viewer_time", type=float, default=0.0,
                    help="timestamp rendered in viewer mode")
    ap.add_argument("--fast", action="store_true",
                    help="packed inference blend (bf16 opacity/colour "
                         "rounding ~0.4%%; no flow)")
    ap.add_argument("--export_pth", default=None,
                    help="write a reference-format torch checkpoint "
                         "(loads in the upstream repo)")
    ap.add_argument("--export_ply", default=None,
                    help="also export the gaussian cloud as PLY")
    ap.add_argument("--video_frames", type=int, default=0,
                    help="render a time sweep (N frames over the scene's "
                         "time_duration) from the first camera")
    ap.add_argument("--device", default="cuda",
                    help="torch device the renders run on")
    return ap


def _error(msg: str) -> int:
    print(f"error: {msg}", file=sys.stderr)
    return 2


def to_u8(img):
    """A float image tensor in [0, 1] → host uint8 (truncating, as the
    JAX package's tool does)."""
    import torch
    return (torch.clamp(img, 0, 1) * 255).to(torch.uint8).cpu().numpy()


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import numpy as np
    import torch
    from PIL import Image

    from .config import load_config
    from .engine.evaluator import Evaluator, fetch_gt
    from .utils import losses as loss_lib
    from .utils.image import search_for_max_iteration

    cfg = load_config(args.config)
    if args.checkpoint is None:
        if args.load_iteration is None or not cfg.model.model_path:
            return _error("--checkpoint or --load_iteration (with a "
                          "model_path in the config) required")
        it = (search_for_max_iteration(cfg.model.model_path, "chkpnt")
              if args.load_iteration < 0 else args.load_iteration)
        args.checkpoint = os.path.join(cfg.model.model_path,
                                       f"chkpnt{it}.pkl")
        print(f"loading iteration {it}: {args.checkpoint}")
    if not os.path.exists(args.checkpoint):
        return _error(f"checkpoint not found: {args.checkpoint}")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        return _error(f"--device {args.device}: no CUDA device; pass "
                      "--device cpu to run on the CPU")

    evaluator = Evaluator(cfg, device=device)
    evaluator.eval_infer = bool(args.fast)
    evaluator.load(args.checkpoint)

    if args.viewer:
        return serve_viewer(evaluator, args)

    out_dir = args.out or os.path.join(
        cfg.model.model_path or ".", f"renders_{args.split}")
    os.makedirs(out_dir, exist_ok=True)

    cams = (evaluator.scene.test_cameras if args.split == "test"
            else evaluator.scene.train_cameras)
    if args.max_views:
        cams = cams[: args.max_views]

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    metrics = []
    for i, cam in enumerate(cams):
        sync()
        t0 = time.perf_counter()
        color, depth, alpha = evaluator.render_view(cam)
        sync()
        render_ms = (time.perf_counter() - t0) * 1e3
        gt = torch.as_tensor(fetch_gt(cam, cfg.model.white_background)[0],
                             device=device)
        psnr = float(loss_lib.psnr(color, gt))
        ssim = float(loss_lib.ssim(color, gt))
        msssim = float(loss_lib.msssim(color[None], gt[None]))
        metrics.append({"view": cam.image_name or str(i), "psnr": psnr,
                        "ssim": ssim, "msssim": msssim,
                        "timestamp": cam.timestamp, "render_ms": render_ms,
                        **evaluator.last_counts})
        Image.fromarray(to_u8(color)).save(
            os.path.join(out_dir, f"{i:05d}.png"))
        dmax = max(float(depth.max()), 1e-6)
        Image.fromarray(to_u8(depth / dmax)).save(
            os.path.join(out_dir, f"{i:05d}_depth.png"))
        print(f"[{i + 1}/{len(cams)}] psnr {psnr:.2f}", flush=True)

    def mean(key):
        return float(np.mean([m[key] for m in metrics])) if metrics else 0

    summary = {"psnr": mean("psnr"), "ssim": mean("ssim"),
               "msssim": mean("msssim"), "views": metrics}
    with open(os.path.join(out_dir, "metrics.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps({k: v for k, v in summary.items() if k != "views"}))

    if args.video_frames > 0:
        vdir = os.path.join(out_dir, "time_sweep")
        os.makedirs(vdir, exist_ok=True)
        base = cams[0] if cams else evaluator.scene.train_cameras[0]
        t0, t1 = evaluator.time_duration
        for k in range(args.video_frames):
            ts = t0 + (t1 - t0) * k / max(args.video_frames - 1, 1)
            color, *_ = evaluator.render_view(
                dataclasses.replace(base, timestamp=ts))
            Image.fromarray(to_u8(color)).save(
                os.path.join(vdir, f"t_{k:04d}.png"))
        print(f"time sweep: {args.video_frames} frames -> {vdir}")

    if args.export_ply:
        from .models.ply_io import export_gaussians_ply
        export_gaussians_ply(args.export_ply, evaluator.gauss,
                             gaussian_dim=cfg.gaussian_dim,
                             rot_4d=cfg.rot_4d)
        print(f"exported cloud -> {args.export_ply}")
    if args.export_pth:
        from .models.torch_import import export_reference_pth
        export_reference_pth(
            args.export_pth, evaluator.gauss, iteration=int(evaluator.step),
            rot_4d=cfg.rot_4d,
            spatial_lr_scale=float(evaluator.scene.radius),
            env_map=(evaluator.env.texture if evaluator.env is not None
                     else None))
        print(f"exported reference checkpoint -> {args.export_pth}")
    return 0


def viewer_render_fn(evaluator, timestamp: float):
    """The viewer's request handler: renders at the evaluator's resolution
    through `Evaluator.render_arrays` and resizes to the client's request."""
    import numpy as np
    import torch
    from PIL import Image

    from .data.cameras import camera_from_matrices

    w, h = evaluator.opts.width, evaluator.opts.height

    def render_fn(req):
        arrays = camera_from_matrices(
            w, h, req.fovx, req.fovy, req.viewmatrix, req.full_proj,
            timestamp=timestamp, device=evaluator.device)
        intr = torch.cat([arrays.focal, torch.tensor(
            [w / 2, h / 2], dtype=torch.float32, device=evaluator.device)])
        color, _, _ = evaluator.render_arrays(arrays, intr)
        if (req.width, req.height) != (w, h):
            return np.asarray(Image.fromarray(to_u8(color)).resize(
                (req.width, req.height))) / 255.0
        return color.cpu().numpy()

    return render_fn


def serve_viewer(evaluator, args) -> int:
    """Serve the loaded checkpoint to a SIBR-protocol viewer until
    interrupted."""
    from .viewer import ViewerServer

    w, h = evaluator.opts.width, evaluator.opts.height
    server = ViewerServer(port=args.viewer_port)
    print(f"viewer: SIBR protocol on 127.0.0.1:{args.viewer_port} "
          f"(rendering {w}x{h} @ t={args.viewer_time}); ctrl-C to stop")
    render_fn = viewer_render_fn(evaluator, args.viewer_time)
    try:
        while True:
            server.poll(render_fn)
            if server.conn is None:
                time.sleep(0.05)
    except KeyboardInterrupt:
        print("viewer: stopped")
    finally:
        server.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
