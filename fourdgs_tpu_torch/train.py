"""Training CLI, the reference entry point (`train.py:354-404`):

    python3 -m fourdgs_tpu_torch.train --config configs/dnerf/lego.yaml \\
        [--override optimization.iterations=3000 ...] [--device cpu]

PyTorch counterpart of the JAX package's `train.py`, with its flags and
their precedence: dataclass defaults < flags < YAML (applied last, as the
reference's OmegaConf merge, `train.py:381-390`) < `--override KEY=VALUE`.
Runs on `--device` (default `cuda`); it does not carry on on the CPU when
that device is missing. Writes into the config's model_path: input.ply,
cameras.json, metrics.jsonl, chkpnt{it}.pkl at the save iterations,
chkpnt_best.pkl at the test iterations, chkpnt_final.pkl at the end.

Under torchrun (WORLD_SIZE > 1 in the environment) each process opens the
process group from the environment (NCCL on CUDA, gloo with --device cpu),
takes the device cuda:LOCAL_RANK, and trains data-parallel
(`engine/trainer.py:Trainer`); rank 0 writes:

    torchrun --nproc_per_node 4 -m fourdgs_tpu_torch.train --config ...
"""

from __future__ import annotations

import argparse
import os
import sys


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="fourdgs_tpu_torch.train",
                                description="4D gaussian splatting")
    p.add_argument("--config", type=str, default=None, help="YAML config")
    p.add_argument("--source_path", "-s", type=str, default=None)
    p.add_argument("--model_path", "-m", type=str, default=None)
    p.add_argument("--resolution", "-r", type=int, default=None)
    p.add_argument("--iterations", type=int, default=None)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--test_iterations", nargs="+", type=int, default=None)
    p.add_argument("--save_iterations", nargs="+", type=int, default=None)
    p.add_argument("--start_checkpoint", type=str, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--eval", action="store_true", default=None)
    # Reference top-level flags (`train.py:361-376`); the YAML still wins
    # where it sets the same key.
    p.add_argument("--gaussian_dim", type=int, default=None)
    p.add_argument("--time_duration", nargs=2, type=float, default=None)
    p.add_argument("--num_pts", type=int, default=None)
    p.add_argument("--num_pts_ratio", type=float, default=None)
    p.add_argument("--rot_4d", action="store_true", default=None)
    p.add_argument("--force_sh_3d", action="store_true", default=None)
    p.add_argument("--exhaust_test", action="store_true", default=None)
    p.add_argument("--checkpoint_iterations", nargs="+", type=int,
                   default=None)
    p.add_argument("--debug_from", type=int, default=None,
                   help="iteration from which pipeline.debug engages")
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--detect_anomaly", action="store_true",
                   help="torch.autograd.set_detect_anomaly (reference "
                        "--detect_anomaly)")
    p.add_argument("--profile_dir", type=str, default=None,
                   help="write a torch.profiler chrome trace of "
                        "iterations 11-20, the step's spans named in it, "
                        "into this directory")
    p.add_argument("--override", nargs="*", default=[],
                   help="dotted KEY=VALUE post-YAML overrides, e.g. "
                        "optimization.lambda_rigid=0.5")
    p.add_argument("--device", default="cuda",
                   help="torch device the training runs on")
    return p.parse_args(argv)


# Flag → config attribute path, applied when the flag is given.
_FLAGS = {
    "source_path": "model.source_path", "model_path": "model.model_path",
    "resolution": "model.resolution", "iterations": "optimization.iterations",
    "batch_size": "batch_size", "test_iterations": "test_iterations",
    "save_iterations": "save_iterations",
    "start_checkpoint": "start_checkpoint", "seed": "seed",
    "eval": "model.eval", "gaussian_dim": "gaussian_dim",
    "time_duration": "time_duration", "num_pts": "num_pts",
    "num_pts_ratio": "num_pts_ratio", "rot_4d": "rot_4d",
    "force_sh_3d": "force_sh_3d", "exhaust_test": "exhaust_test",
    "checkpoint_iterations": "checkpoint_iterations",
    "debug_from": "debug_from",
}


def _parent(cfg, path: str):
    """(the object holding a dotted config attribute, its name)."""
    *groups, name = path.split(".")
    for group in groups:
        cfg = getattr(cfg, group)
    return cfg, name


def build_config(args):
    """defaults < flags < YAML < --override."""
    import yaml

    from .config import apply_yaml, load_config

    cfg = load_config(None)
    for flag, path in _FLAGS.items():
        value = getattr(args, flag)
        if value is not None:
            setattr(*_parent(cfg, path),
                    tuple(value) if flag == "time_duration" else value)
    if args.config:
        apply_yaml(cfg, args.config)
    for kv in args.override:
        key, _, text = kv.partition("=")
        obj, name = _parent(cfg, key)
        cur, value = getattr(obj, name), yaml.safe_load(text)
        setattr(obj, name, type(cur)(value) if cur is not None else value)
    return cfg


def main(argv=None) -> int:
    args = parse_args(argv)
    cfg = build_config(args)
    if not cfg.model.source_path:
        print("error: --config or --source_path required", file=sys.stderr)
        return 2
    if not os.path.exists(cfg.model.source_path):
        print(f"error: source not found: {cfg.model.source_path}",
              file=sys.stderr)
        return 2
    if cfg.start_checkpoint and not os.path.exists(cfg.start_checkpoint):
        print(f"error: checkpoint not found: {cfg.start_checkpoint}",
              file=sys.stderr)
        return 2

    import torch

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print(f"error: --device {args.device}: no CUDA device; pass "
              "--device cpu to run on the CPU", file=sys.stderr)
        return 2
    torch.autograd.set_detect_anomaly(args.detect_anomaly)

    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world == 1:
        return _train(args, cfg, device)
    import torch.distributed as dist

    from .parallel import multihost

    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(device)
    multihost.initialize(device=device)
    try:
        return _train(args, cfg, device)
    finally:
        dist.destroy_process_group()


def _train(args, cfg, device) -> int:
    from .engine.trainer import Trainer

    with Trainer(cfg, device=device, verbose=not args.quiet) as trainer:
        if args.profile_dir and trainer.is_writer:
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if device.type == "cuda":
                activities.append(ProfilerActivity.CUDA)
            prof = profile(activities=activities)

            def on_step(it, metrics):
                if it == 10:
                    prof.start()
                elif it == 20:
                    prof.stop()
                    os.makedirs(args.profile_dir, exist_ok=True)
                    prof.export_chrome_trace(
                        os.path.join(args.profile_dir, "trace.json"))

            trainer.train(on_step=on_step)
        else:
            trainer.train()
        if trainer.scene.test_cameras:
            trainer.evaluate()
        if cfg.model.model_path:
            trainer.save(os.path.join(cfg.model.model_path,
                                      "chkpnt_final.pkl"))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
