"""Spans and counters of the training path: what each stage of a step
costs, on the device trace's clock, and what each iteration did on the
host.

Spans. `span(name)` names a stage for `torch.profiler`: while a profiler
records, it opens a host range of that name in the profiler's timeline,
the one its kernels lie on; otherwise it returns a shared no-op after one
check of the profiler's flag. The range is a host operation
(`torch._C._profiler._RecordFunctionFast`), not a
`torch.profiler.record_function` user annotation: for each user
annotation the profiler also writes a device-side event that spans the
first to the last kernel launched inside it, which a reader of device
activity would count as busy time. The training path opens these, on the
thread that calls `Trainer.train`:

    train.batch_wait   the loop's top: the next batch and the GT gather
    train.step         the train_step call, holding
      step.render        every camera's render, holding per camera
        render.preprocess, render.binning, render.blend
      step.loss          the photometric (and opacity mask) losses
      step.rigid         the rigid and motion losses (knn)
      step.backward      loss.backward()
      step.update        densification statistics and Adam
    train.bookkeeping  density control, the loss read, metrics.jsonl,
                       TensorBoard and the console line

Every span of an iteration closes before `Trainer.train` calls its
`on_step`, so that a profiler started or stopped there sees whole spans.
The backward's own operations run on autograd's device thread, inside
step.backward's time but not inside the span.

Counters. Integer counts (and host-clock nanoseconds), always on, kept per
training iteration in a ring of the last `RING` iterations; counts made
outside `Trainer.train` (a served view) go to the open entry. Each count is
one dictionary add on the host; nothing touches the device.

    host_reads.<site>  device-to-host reads through `read`
    batch_wait_ns      host time of the loop's `train.batch_wait`
    launches.k1/k2/k3  launches of the blend kernels K1, K2 and K3

`counts(first, last)` gives the entries of iterations first..last,
`totals()` the sums of everything counted since the last `reset()`.
"""

from __future__ import annotations

import collections

import torch
import torch.autograd.profiler as _autograd_profiler

RING = 1024

# Host-read sites (`read`), one per place in the code that reads a device
# value back.
READ_SITES = ("binning", "trainer.loss", "metrics_jsonl", "trainer.console",
              "trainer.tensorboard", "densify", "step.all_reduce")


class _NoSpan:
    """The span while no profiler records: enters and leaves nothing."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()
_Range = torch._C._profiler._RecordFunctionFast


def span(name: str):
    """A context manager that names its block `name` in a recording
    profiler's timeline, and does nothing otherwise (the flag is the one
    `torch.profiler` sets on start and clears on stop)."""
    if _autograd_profiler._is_profiler_enabled:
        return _Range(name)
    return _NO_SPAN


class stage:
    """`span(name)` around a stage of the step, then, where the caller was
    given a `mark` (`train_step`'s timing callback), `mark(mark_name)` as
    the stage's work is issued."""
    __slots__ = ("name", "mark", "mark_name", "_span")

    def __init__(self, name: str, mark=None, mark_name: str | None = None):
        self.name, self.mark, self.mark_name = name, mark, mark_name
        self._span = None

    def __enter__(self):
        if _autograd_profiler._is_profiler_enabled:
            self._span = _Range(self.name)
            self._span.__enter__()

    def __exit__(self, *exc):
        if self._span is not None:
            self._span.__exit__(*exc)
        if self.mark and exc[0] is None:
            self.mark(self.mark_name)
        return False


# --------------------------------------------------------------- counters
_loose: dict = {}            # counts before the first iteration
_retired: dict = {}          # sums of entries that left the ring
_ring: collections.deque = collections.deque()   # (iteration, counts)
_current: dict = _loose


def begin_step(iteration: int) -> None:
    """Open the entry of training iteration `iteration`: the counts that
    follow go there."""
    global _current
    if len(_ring) == RING:
        _, old = _ring.popleft()
        for k, v in old.items():
            _retired[k] = _retired.get(k, 0) + v
    _current = {}
    _ring.append((iteration, _current))


def count(name: str, n: int = 1) -> None:
    """Add `n` to counter `name` of the open entry."""
    _current[name] = _current.get(name, 0) + n


def read(site: str, x: torch.Tensor):
    """The Python value of the one-element tensor `x`, counted as a host
    read at `site` (one of READ_SITES)."""
    key = "host_reads." + site
    _current[key] = _current.get(key, 0) + 1
    return x.item()


def counts(first: int, last: int) -> list:
    """[(iteration, {counter: value})] of the ring's iterations first..last,
    in order."""
    return [(it, dict(c)) for it, c in _ring if first <= it <= last]


def totals() -> dict:
    """Every counter summed since the last `reset`."""
    out = dict(_retired)
    for c in [_loose] + [c for _, c in _ring]:
        for k, v in c.items():
            out[k] = out.get(k, 0) + v
    return out


def reset() -> None:
    """Forget every count and iteration."""
    global _current
    _loose.clear()
    _retired.clear()
    _ring.clear()
    _current = _loose
