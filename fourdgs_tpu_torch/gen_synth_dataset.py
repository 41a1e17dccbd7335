"""Generate the synthetic dynamic-scene benchmark dataset on the card:

    python3 -m fourdgs_tpu_torch.gen_synth_dataset [--dynerf] [--device cpu]

PyTorch counterpart of the JAX package's `scripts/gen_synth_dataset.py`,
with its flags and defaults: `datasets/synth_quality` (120 train / 20 test
views at 400x400, `configs/synth/quality.yaml`), or with `--dynerf`
`datasets/synth_dynerf` (a fixed rig of 15 cameras, 60 video frames each
over [0, 10], camera 0 held out; `configs/synth/dynerf_quality.yaml`).
The ground truth is oracle-rendered from a known moving scene
(`data/synth.py`) on `--device` (default `cuda`; exit 2 without a card
unless `--device cpu`). Skips generation when the manifest matches.
"""

from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="fourdgs_tpu_torch.gen_synth_dataset")
    p.add_argument("--out", default="datasets/synth_quality")
    p.add_argument("--n_train", type=int, default=120)
    p.add_argument("--n_test", type=int, default=20)
    p.add_argument("--size", type=int, default=400)
    p.add_argument("--points_scale", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--dynerf", action="store_true",
                   help="DyNeRF-modality dataset (fixed multi-camera "
                        "rig, video frames over [0,10], RGBA + sky; "
                        "see data/synth.py:generate_dataset_dynerf)")
    p.add_argument("--n_cams", type=int, default=15)
    p.add_argument("--n_frames", type=int, default=60)
    p.add_argument("--device", default="cuda",
                   help="torch device the ground truth renders on")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import torch

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print(f"error: --device {args.device}: no CUDA device; pass "
              "--device cpu to run on the CPU", file=sys.stderr)
        return 2

    from .data import synth

    if args.dynerf:
        out = synth.generate_dataset_dynerf(
            args.out if args.out != "datasets/synth_quality"
            else "datasets/synth_dynerf",
            n_cams=args.n_cams, n_frames=args.n_frames,
            n_test_frames=args.n_test, width=args.size, height=args.size,
            points_scale=args.points_scale, seed=args.seed, verbose=True,
            device=device)
    else:
        out = synth.generate_dataset(
            args.out, n_train=args.n_train, n_test=args.n_test,
            width=args.size, height=args.size,
            points_scale=args.points_scale, seed=args.seed, verbose=True,
            device=device)
    print("dataset ready:", out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
