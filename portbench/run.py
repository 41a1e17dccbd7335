"""Runs one cell of the port's benchmark once and prints its result as
the last line of standard output.

    python3 portbench/run.py --workload lego.train --seed 7 --seconds 40 \
        --trace 0

The cell, its configuration, traffic and metrics are named in
BENCHMARK.json at the root of the checkout. The program under test is the
`fourdgs_tpu_torch` package beside this folder; the run needs a CUDA card
and exits with a code other than 0, printing no result, without one.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(1, os.path.dirname(HERE))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from harness import registry, runner

    def log(line):
        print(line, file=sys.stderr, flush=True)

    cell = registry.cell(registry.load_benchmark(), args.workload)
    if not torch.cuda.is_available():
        log("no CUDA device: this benchmark measures the port on a card")
        return 3
    if torch.cuda.device_count() < cell.chips:
        log(f"{args.workload} needs {cell.chips} cards, "
            f"{torch.cuda.device_count()} found")
        return 3
    out = runner.run(cell, args.seed, args.seconds, bool(args.trace),
                     "cuda", T_PROCESS, log=log)
    found = runner.forbidden_modules()
    if found:
        log(f"the run loaded {', '.join(found)}: the port must not")
        return 4
    print(runner.dumps_line(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
