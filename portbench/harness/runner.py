"""One run of one cell, from its inputs to the result line: the inputs
made from the seed, the program's run (`training.run_cell`), the
reference's check of what the timed path produced, and the metrics."""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
from typing import NamedTuple

import torch

from harness import check, registry, training
from harness.scene import make_data
from harness.trace import top

GIB = float(1 << 30)
# Top-level module names a run may not load: JAX and the JAX package.
FORBIDDEN = ("jax", "jaxlib", "flax", "fourdgs_tpu")


class Context(NamedTuple):
    """What a per-layer metric's reader reads."""
    cell: registry.Cell
    result: training.RunResult
    profile: object        # harness.trace.Profile, or None
    cache: dict            # values readers share (kernel bounds)


def card_state() -> str:
    """Name, power limit, SM clock, power draw and temperature of the
    card(s), as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
             "power.draw,temperature.gpu", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
        return out.stdout.strip().replace("\n", " | ")
    except (OSError, subprocess.SubprocessError) as err:
        return f"nvidia-smi unavailable: {err}"


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of FORBIDDEN, compared
    whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def work_dirs(cell: registry.Cell, root: str):
    """(the run's directory, the dataset's PNG pool) under `root`/build:
    fixed paths, so that every run of a checkout finds the pool."""
    base = os.path.join(root, "build", "portbench")
    w, h = cell.config["dataset"]["image_size"]
    return (os.path.join(base, cell.name),
            os.path.join(base, "pool", cell.config_name, f"{w}x{h}"))


def end_to_end(res: training.RunResult) -> dict:
    """The window's whole steps over its wall time, its peak memory, and
    the set-up time."""
    return dict(train_step_ms=res.window_s / res.steps * 1e3,
                peak_mem_gib=res.memory_window / GIB, setup_s=res.setup_s)


def run(cell: registry.Cell, seed: int, seconds: float, trace: bool,
        device: str, t_process: float, log=print,
        root: str = registry.REPO) -> dict:
    """One run; returns the result line's object. `log` takes the lines
    that go to standard error; what the run writes lies under
    `root`/build."""
    cuda = torch.device(device).type == "cuda"
    work_dir, pool = work_dirs(cell, root)
    log(f"imports done at {time.perf_counter() - t_process:.3f} s")
    data = make_data(cell.config, seed, device, pool)
    log(f"inputs made at {time.perf_counter() - t_process:.3f} s")
    if cuda:
        log(f"card before the window: {card_state()}")
    p0_host, res = training.run_cell(
        cell.config, cell.traffic, data, seed, seconds, trace, device,
        work_dir, t_process, log=log)
    if cuda:
        log(f"card after the window: {card_state()}")
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    ref = training.run_reference(cell.config, cell.traffic, data,
                                     p0_host, res.check.batches, device)
    log(f"reference: {time.perf_counter() - t0:.3f} s; window "
        f"{res.window_s:.3f} s, {res.steps} steps; set-up {res.setup_s:.3f}"
        f" s")
    nums = check.numbers(res.check, ref)
    limits = check.load_limits(registry.BENCH_DIR, cell.name)
    correct = check.judge(nums, limits) and res.finite

    metrics = {}
    device_info = dict(
        platform="gpu" if cuda else "cpu",
        kind=torch.cuda.get_device_name(0) if cuda else "cpu",
        count=cell.chips, memory_peak_bytes=res.memory_run)
    out = dict(correct=correct, attempted=res.steps,
               failed=0 if res.finite else res.steps)
    if trace:
        prof = res.profile.summary()
        ctx = Context(cell, res, prof, {})
        for m in cell.per_layer:
            value = registry.metric_reader(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = dict(value=value, unit=m["unit"])
        device_info.update(busy_s=prof.busy_s, window_s=prof.window_s)
        out["breakdown"] = dict(device_ops=top(prof.kernel_s),
                                idle_gaps=top(prof.idle_s))
        log(f"metrics read in {time.perf_counter() - t0:.3f} s after the "
            f"window")
    else:
        e2e = end_to_end(res)
        for m in cell.end_to_end:
            metrics[m["name"]] = dict(value=e2e[m["name"]], unit=m["unit"])
    out.update(metrics=metrics, device=device_info)
    out["check"] = {k: dict(value=nums[k], limit=limits[k])
                    for k in check.NAMES}
    if not res.finite:
        out["check"]["state_finite"] = dict(value=0, limit=1)
    for k, v in out["check"].items():
        log(f"check {k} {v['value']!r} limit {v['limit']!r}")
    return out


def dumps_line(obj: dict) -> str:
    """One JSON line; nan as null."""
    def clean(x):
        if isinstance(x, float) and not math.isfinite(x):
            return None
        if isinstance(x, dict):
            return {k: clean(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [clean(v) for v in x]
        return x
    return json.dumps(clean(obj))
