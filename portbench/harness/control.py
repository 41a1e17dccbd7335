"""The comparison's own checks: the control (the reference in bfloat16, the
next precision below the configuration's float32, put in the program's
place) and the faults a training cell can have, planted in the timed path.
Each must come out not correct; their readings set the limits' upper ends
(PERF.md §4).

    python3 portbench/harness/control.py --workload lego.train \
        --mode control --seeds 1,2,3 [--seconds 3]

prints one JSON line of compared numbers per seed. Modes: `sound` (the
program as it is), `control`, `unchanged` (the step returns its state
unchanged), `half_batch` (half of the batch left out, the mean over the
rest).
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(HERE))
    sys.path.insert(1, os.path.dirname(os.path.dirname(HERE)))

from harness import check, registry, runner, training  # noqa: E402
from harness.scene import make_data  # noqa: E402


def program_batches(cell: registry.Cell, data, seed: int) -> list:
    """The train-frame indices of the check steps as the Trainer draws
    them: an epoch's permutation from the config seed, in batch-size
    slices."""
    b = cell.config["config"]["batch_size"]
    order = np.random.default_rng(int(seed) % (1 << 31)).permutation(
        len(data.frames))
    return [[int(j) for j in order[i * b:(i + 1) * b]]
            for i in range(cell.traffic["check_steps"])]


def control_numbers(cell: registry.Cell, seed: int, device,
                    root: str = registry.REPO) -> dict:
    """The compared numbers of the reference run in bfloat16 against the
    reference in float32, on the run's own inputs."""
    data = make_data(cell.config, seed, device,
                     runner.work_dirs(cell, root)[1])
    p0 = {k: v.cpu() for k, v in data.params.items()}
    data.params.clear()
    batches = program_batches(cell, data, seed)
    ref = training.run_reference(cell.config, cell.traffic, data, p0,
                                     batches, device)
    low = training.run_reference(cell.config, cell.traffic, data, p0,
                                     batches, device, dtype=torch.bfloat16)
    return check.numbers(training.CheckReadings(
        low["losses"], low["grad_norms"], low["change_norms"], batches), ref)


@contextlib.contextmanager
def planted(fault: str):
    """The program's train step, as the Trainer calls it, with `fault`."""
    from fourdgs_tpu_torch.engine import trainer as trainer_mod

    real = trainer_mod.train_step

    def unchanged(state, *a, **kw):
        _, env, metrics = real(state, *a, **kw)
        return state, env, metrics

    def half_batch(state, step, cams, gt, alpha, *a, intrinsics=None,
                   **kw):
        h = max(1, len(cams) // 2)
        return real(state, step, cams[:h], gt[:h],
                    None if alpha is None else alpha[:h], *a,
                    intrinsics=None if intrinsics is None else intrinsics[:h],
                    **kw)

    trainer_mod.train_step = {"unchanged": unchanged,
                              "half_batch": half_batch}[fault]
    try:
        yield
    finally:
        trainer_mod.train_step = real


def fault_run(cell: registry.Cell, seed: int, seconds: float, fault: str,
              device, root: str = registry.REPO) -> dict:
    """A whole run with `fault` planted (or none: "sound"); its result."""
    t = time.perf_counter()
    quiet = dict(log=lambda line: None, root=root)
    if fault == "sound":
        return runner.run(cell, seed, seconds, False, device, t, **quiet)
    with planted(fault):
        return runner.run(cell, seed, seconds, False, device, t, **quiet)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--mode", required=True,
                    choices=("sound", "control", "unchanged", "half_batch"))
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    cell = registry.cell(registry.load_benchmark(), args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        if args.mode == "control":
            nums = control_numbers(cell, seed, "cuda")
            line = dict(correct=check.judge(
                nums, check.load_limits(registry.BENCH_DIR, cell.name)))
        else:
            out = fault_run(cell, seed, args.seconds, args.mode, "cuda")
            nums = {k: v["value"] for k, v in out["check"].items()}
            line = dict(correct=out["correct"], metrics=out["metrics"])
        print(runner.dumps_line(dict(workload=cell.name, mode=args.mode,
                                     seed=seed, numbers=nums, **line)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
