#!/usr/bin/env python3
"""The north-star run of the PyTorch port on one card, end to end:

    python3 scripts/torch_north_star.py [--iterations 10000]
        [--start_checkpoint build/north_star/model/chkpnt5000.pkl]

1. `python -m fourdgs_tpu_torch.gen_synth_dataset` writes
   datasets/synth_quality (120 train / 20 test views at 400x400; skipped
   when its manifest matches);
2. `python -m fourdgs_tpu_torch.train` trains configs/synth/quality.yaml
   as it is (10k iterations), with a held-out evaluation every 1000;
3. `scripts/training_record.py` summarises its metrics.jsonl;
4. `python -m fourdgs_tpu_torch.render_cli` renders the best checkpoint's
   20 test views exact and --fast.

Writes into --out (default chiprun_out/north_star): each tool's log, the
record, metrics.jsonl, both renders' metrics.json and the last
evaluation's panels, the TensorBoard tags written, and summary.json
(card, generation seconds, steps/s, the PSNR table, the final metrics,
render_ms). A run cut short resumes from a chkpnt{it}.pkl of --model with
--start_checkpoint (the trainer restores its batch order and noise).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def run(cmd, log_path):
    """Run `cmd` from the repo root, its output into `log_path` and
    echoed; (seconds, output). A failure raises."""
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    with open(log_path, "w") as f:
        f.write(proc.stdout + proc.stderr)
    print(proc.stdout[-4000:] + proc.stderr[-4000:], flush=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)}: exit {proc.returncode}")
    return seconds, proc.stdout


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="chiprun_out/north_star")
    ap.add_argument("--data", default="datasets/synth_quality")
    ap.add_argument("--model", default="build/north_star/model")
    ap.add_argument("--iterations", type=int, default=10000)
    ap.add_argument("--start_checkpoint", default=None)
    args = ap.parse_args()

    from fourdgs_tpu_torch.utils.tb_writer import read_tags

    out = os.path.join(ROOT, args.out)
    os.makedirs(out, exist_ok=True)
    py = sys.executable
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    summary = dict(card=card)

    gen_s, gen_out = run([py, "-m", "fourdgs_tpu_torch.gen_synth_dataset",
                          "--out", args.data], os.path.join(out, "gen.log"))
    m = re.search(r"(\d+) frames in ([\d.]+) s \(([\d.]+) ms/frame\)",
                  gen_out)
    summary["generate"] = dict(
        command_s=gen_s, frames=int(m.group(1)) if m else None,
        seconds=float(m.group(2)) if m else None,
        ms_per_frame=float(m.group(3)) if m else None)

    tests = [str(i) for i in range(1000, args.iterations + 1, 1000)]
    cmd = [py, "-m", "fourdgs_tpu_torch.train",
           "--config", "configs/synth/quality.yaml",
           "--test_iterations", *tests, "--save_iterations", *tests,
           "--override", f"model.source_path={args.data}",
           f"model.model_path={args.model}",
           f"optimization.iterations={args.iterations}"]
    if args.start_checkpoint:
        cmd += ["--start_checkpoint", args.start_checkpoint]
    train_s, _ = run(cmd, os.path.join(out, "train.log"))
    model = os.path.join(ROOT, args.model)
    run([py, "scripts/training_record.py", model],
        os.path.join(out, "record.md"))

    rows = [json.loads(line) for line in open(
        os.path.join(model, "metrics.jsonl"))]
    steps = [r for r in rows if "loss" in r]
    evals = [r for r in rows if "eval_psnr" in r]
    summary["train"] = dict(
        command_s=train_s, iterations=steps[-1]["step"],
        wall_s=steps[-1]["wall_s"],
        steps_per_s=steps[-1]["step"] / steps[-1]["wall_s"],
        eval_psnr=[(r["step"], r["eval_psnr"]) for r in evals],
        points=[(r["step"], r["total_points"]) for r in steps
                if r["step"] % 1000 == 0],
        finite_loss=all(r["loss"] == r["loss"] for r in steps))

    renders = {}
    for mode in ("exact", "fast"):
        rdir = os.path.join(out, f"renders_{mode}")
        run([py, "-m", "fourdgs_tpu_torch.render_cli",
             "--config", "configs/synth/quality.yaml",
             "--checkpoint", os.path.join(model, "chkpnt_best.pkl"),
             "--out", rdir] + (["--fast"] if mode == "fast" else []),
            os.path.join(out, f"render_{mode}.log"))
        with open(os.path.join(rdir, "metrics.json")) as f:
            res = json.load(f)
        ms = sorted(v["render_ms"] for v in res["views"])
        renders[mode] = dict(psnr=res["psnr"], ssim=res["ssim"],
                             msssim=res["msssim"],
                             render_ms_median=ms[len(ms) // 2],
                             render_ms_min=ms[0], render_ms_max=ms[-1])
        for png in glob.glob(os.path.join(rdir, "*.png")):
            os.remove(png)             # --out keeps the metrics only
    summary["render_cli_best"] = renders

    (events,) = glob.glob(os.path.join(model, "events.out.tfevents.*"))
    summary["tensorboard"] = read_tags(events)
    for name in ("metrics.jsonl", "cameras.json"):
        shutil.copy(os.path.join(model, name), out)
    last = sorted(glob.glob(os.path.join(model, "eval", "it*_test_*.png")))
    for png in last[-5:]:
        shutil.copy(png, out)
    with open(os.path.join(out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
