"""The program's own spans and counters (`fourdgs_tpu_torch/utils/
tracing.py`) as the training cell's readers see them: the named host
ranges of the measuring thread in the profiled window, with the device's
activity and the kernels launched inside each range, and the
per-iteration counters of the stage-marks window.

Both give nothing on a program without them: no range named by the
program in the profile, no `tracing` module to import.
"""

from __future__ import annotations

from collections import defaultdict
from typing import NamedTuple

from harness.trace import merge

# Names the program gives its spans.
SPAN_PREFIXES = ("train.", "step.", "render.")


class Spans(NamedTuple):
    steps: int             # whole steps in the profiled window
    ranges: dict           # span name -> [(start s, end s)], by start
    busy: list             # merged device activity [[start s, end s]]
    kernels: list          # (start s, end s, host launch s) of each kernel


def read_events(events, steps: int):
    """`Spans` of kineto events (as `torch.profiler`'s
    `profiler.kineto_results.events()`), or None where the measuring
    thread (the one with the most host events, as `harness/trace.py`
    picks it) opened no span. A kernel's launch is the host call of the
    same correlation id, on that thread, whose name holds "Launch"; the
    device-side copies of user annotations are not device activity."""
    from torch.autograd import DeviceType

    device, host = [], defaultdict(list)
    for e in events:
        s, t = e.start_ns() * 1e-9, e.end_ns() * 1e-9
        if e.device_type() != DeviceType.CPU:
            if not e.is_user_annotation():
                device.append((s, t, e.correlation_id()))
        else:
            host[e.start_thread_id()].append(
                (s, t, e.name(), e.correlation_id()))
    if not host:
        return None
    mine = max(host.values(), key=len)
    ranges, launch = defaultdict(list), {}
    for s, t, name, corr in mine:
        if name.startswith(SPAN_PREFIXES):
            ranges[name].append((s, t))
        elif name.startswith("cu") and "Launch" in name:
            launch[corr] = s
    if not ranges:
        return None
    return Spans(steps=steps,
                 ranges={k: sorted(v) for k, v in ranges.items()},
                 busy=merge([(s, t) for s, t, _ in device]),
                 kernels=[(s, t, launch[c]) for s, t, c in device
                          if c in launch])


def profiled(ctx):
    """The run's `Spans`, read once (`ctx.cache`); None where the run was
    not profiled or the program opened no span."""
    if "spans" not in ctx.cache:
        prof = ctx.result.profile
        ctx.cache["spans"] = (
            read_events(prof.prof.profiler.kineto_results.events(),
                        prof.steps)
            if prof is not None and prof.steps > 0 else None)
    return ctx.cache["spans"]


def overlap(intervals, s: float, t: float) -> float:
    """Seconds of the disjoint `intervals` inside (s, t)."""
    return sum(max(0.0, min(b, t) - max(a, s)) for a, b in intervals
               if a < t and b > s)


def launched_in(sp: Spans, names) -> list:
    """(start, end) of the kernels launched inside a range of the spans
    `names`."""
    ranges = [r for n in names for r in sp.ranges.get(n, ())]
    return [(s, t) for s, t, at in sp.kernels
            if any(a <= at <= b for a, b in ranges)]


def window_iterations(ctx):
    """(first, last) training iteration of the stage-marks window: the
    steps after the check and warm-up steps, one per entry of
    `ctx.result.stages`."""
    traffic = ctx.cell.traffic
    first = (traffic["start_iteration"] + traffic["check_steps"]
             + traffic["warmup_steps"] + 1)
    return first, first + len(ctx.result.stages) - 1


def window_counts(ctx):
    """The program's per-iteration counters over the stage-marks window,
    [{counter: value}], or None where the program keeps none."""
    try:
        from fourdgs_tpu_torch.utils import tracing
    except ImportError:
        return None
    first, last = window_iterations(ctx)
    entries = [c for _, c in tracing.counts(first, last)] if last >= first \
        else []
    return entries or None
