"""The traced window under `torch.profiler`: device busy time, kernel time
by name, and the device's idle gaps by what the host was doing.

A gap is attributed to the innermost operation of the measuring thread
(the thread that issued most operations) that covers the gap's midpoint,
or to "no_host_operation" (Python running between operations) where none
does.
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict
from typing import NamedTuple

IDLE_NONE = "no_host_operation"
SCAN = 5000     # operations looked back at for one gap's covering operation


class Profile(NamedTuple):
    window_s: float          # host clock, profiler start to stop
    busy_s: float            # union of device activity
    steps: int
    kernel_s: dict           # device seconds by kernel name
    idle_s: dict             # idle seconds by host operation


def merge(intervals):
    """Sorted, disjoint union of (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def idle_by_host(busy, window, host_ops):
    """Seconds of the device's idle gaps inside `window` (start, end),
    grouped by the covering host operation. `busy` is merged device time,
    `host_ops` (start, end, name) in the same clock."""
    gaps, cursor = [], window[0]
    for s, e in busy:
        if s > cursor:
            gaps.append((cursor, min(s, window[1])))
        cursor = max(cursor, e)
    if cursor < window[1]:
        gaps.append((cursor, window[1]))
    ops = sorted(host_ops)
    starts = [o[0] for o in ops]
    out = defaultdict(float)
    for g0, g1 in gaps:
        if g1 <= g0:
            continue
        mid = 0.5 * (g0 + g1)
        name = IDLE_NONE
        i = bisect.bisect_right(starts, mid) - 1
        for j in range(i, max(i - SCAN, -1), -1):
            if ops[j][1] >= mid:
                name = ops[j][2]
                break
        out[name] += g1 - g0
    return dict(out)


class Profiler:
    """`torch.profiler` over whole steps of the measuring thread."""

    def __init__(self, cuda: bool):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if cuda:
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.t0 = self.window_s = 0.0
        self.steps = 0

    def start(self):
        self.prof.__enter__()
        self.t0 = time.perf_counter()

    def stop(self, steps: int):
        """End the window after `steps` whole steps (the caller has
        synchronised)."""
        self.window_s = time.perf_counter() - self.t0
        self.prof.__exit__(None, None, None)
        self.steps = steps

    def summary(self) -> Profile:
        from torch.autograd import DeviceType

        device, host = [], defaultdict(list)
        for e in self.prof.profiler.kineto_results.events():
            s, t = e.start_ns() * 1e-9, e.end_ns() * 1e-9
            if e.device_type() != DeviceType.CPU:
                device.append((s, t, e.name()))
            else:
                host[e.start_thread_id()].append((s, t, e.name()))
        # The measuring thread issues nearly every operation; the loader's
        # threads, a few.
        mine = max(host.values(), key=len) if host else []
        busy = merge([(s, t) for s, t, _ in device])
        kernel_s = defaultdict(float)
        for s, t, name in device:
            kernel_s[name] += t - s
        if mine:
            window = (min(h[0] for h in mine), max(h[1] for h in mine))
        else:
            window = (busy[0][0], busy[-1][1]) if busy else (0.0, 0.0)
        busy = [(max(s, window[0]), min(t, window[1])) for s, t in busy
                if t > window[0] and s < window[1]]
        return Profile(
            window_s=self.window_s,
            busy_s=sum(t - s for s, t in busy),
            steps=self.steps, kernel_s=dict(kernel_s),
            idle_s=idle_by_host(busy, window, mine))


def top(d: dict, n: int = 10, width: int = 160):
    """The n largest (name, seconds), largest first, names cut to
    `width` characters."""
    return [[k[:width], v]
            for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]
