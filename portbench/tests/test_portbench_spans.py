"""The readers of the program's spans and counters on synthetic
kineto-like events and a synthetic counter ring, against recounts: idle
inside spans, launches by correlation id, merged device time by span, the
stage-marks window's iterations, and nothing where a run has no profile,
no span or no counters."""

import os
import sys
import types

import pytest
import torch
from torch.autograd import DeviceType

from harness import registry, runner, training

from fourdgs_tpu_torch.utils import tracing

sys.path.insert(0, os.path.join(registry.BENCH_DIR, "metrics"))
import spans  # noqa: E402

MAIN, BACKWARD = 11, 12
NEW = ("train.batch_wait_ms", "train.host_reads_per_step",
       "train.render_idle_ms", "train.render_launches",
       "train.loss_update_ms")


class Event:
    """What the readers call of a kineto event; times in µs."""

    def __init__(self, name, s, t, device=False, tid=MAIN, corr=0,
                 annotation=False):
        self._name, self._s, self._t = name, s, t
        self._device, self._tid, self._corr = device, tid, corr
        self._annotation = annotation

    def name(self):
        return self._name

    def start_ns(self):
        return int(self._s * 1000)

    def end_ns(self):
        return int(self._t * 1000)

    def device_type(self):
        return DeviceType.CUDA if self._device else DeviceType.CPU

    def start_thread_id(self):
        return self._tid

    def correlation_id(self):
        return self._corr

    def is_user_annotation(self):
        return self._annotation


def kernel(corr, at, s, t, tid=MAIN, call="cudaLaunchKernel"):
    """A launch on the host at `at` (2 µs long) and its kernel at s..t."""
    return [Event(call, at, at + 2, tid=tid, corr=corr),
            Event(f"kernel_{corr}", s, t, device=True, corr=corr)]


def step_events(t0):
    """One 100-µs step from t0: render 0–40 (kernels busy 5–15 and 20–30,
    three launched inside), loss 40–50, rigid 50–60, backward 60–80 (its
    kernel launched from the backward thread), update 80–95. A memcpy
    issued in render is not a kernel; a user annotation's device copy is
    not activity."""
    ev = [Event("train.step", t0, t0 + 100),
          Event("step.render", t0, t0 + 40),
          Event("render.preprocess", t0, t0 + 20),
          Event("step.loss", t0 + 40, t0 + 50),
          Event("step.rigid", t0 + 50, t0 + 60),
          Event("step.backward", t0 + 60, t0 + 80),
          Event("step.update", t0 + 80, t0 + 95),
          Event("train.step", t0 + 1, t0 + 99, device=True, corr=1,
                annotation=True)]
    ev += [Event("aten::mul", t0 + i, t0 + i + 0.5) for i in range(40)]
    ev += kernel(100 + t0, t0 + 2, t0 + 5, t0 + 10)
    ev += kernel(101 + t0, t0 + 3, t0 + 8, t0 + 15)
    ev += kernel(102 + t0, t0 + 18, t0 + 20, t0 + 30)
    ev += kernel(103 + t0, t0 + 19, t0 + 21, t0 + 24,
                 call="cudaMemcpyAsync")
    ev += kernel(104 + t0, t0 + 42, t0 + 44, t0 + 47)        # loss
    ev += kernel(105 + t0, t0 + 45, t0 + 46, t0 + 49)        # loss, overlaps
    ev += kernel(106 + t0, t0 + 52, t0 + 55, t0 + 58)        # rigid
    ev += kernel(107 + t0, t0 + 65, t0 + 66, t0 + 78, tid=BACKWARD)
    ev += kernel(108 + t0, t0 + 82, t0 + 84, t0 + 90)        # update
    ev += kernel(109 + t0, t0 + 94, t0 + 96, t0 + 97)        # update, late
    return ev


def fake_profile(events, steps):
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: events)))
    return types.SimpleNamespace(prof=prof, steps=steps)


def ctx(cells, profile=None, stages=()):
    res = training.RunResult(
        setup_s=12.5, window_s=40.2, steps=201, memory_window=0,
        memory_run=0, finite=True, check=None, step_s=[],
        stages=list(stages), profile=profile, kernel_args=[])
    return runner.Context(cells["lego.train"], res, None, {})


def read(name, c):
    return registry.metric_reader(name).read(c)


def test_spans_by_the_measuring_thread():
    ev = step_events(0) + step_events(1000)
    ev += [Event("step.render", 0, 500, tid=BACKWARD)]      # not measuring
    sp = spans.read_events(ev, 2)
    got = [x for r in sp.ranges["step.render"] for x in r]
    assert got == pytest.approx([0, 40e-6, 1000e-6, 1040e-6])
    # Not kernels of this thread: the memcpy and the backward's kernel.
    assert len(sp.kernels) == 2 * 8
    assert all(t - s < 20e-6 for s, t in sp.busy)     # no annotation copy
    assert spans.read_events([Event("aten::mul", 0, 1)], 1) is None


def test_render_idle_launches_and_loss_update(cells):
    c = ctx(cells, fake_profile(step_events(0) + step_events(1000), 2))
    # render 40 µs: busy 5–15 and 20–30 (the memcpy 21–24 inside), idle 20.
    assert read("train.render_idle_ms", c) == pytest.approx(20e-3)
    # Kernels 100, 101, 102 per step; the memcpy is not launched as one.
    assert read("train.render_launches", c) == 3
    # loss 44–49 merged (5 µs), update 84–90 and 96–97 (7 µs): 12 µs.
    assert read("train.loss_update_ms", c) == pytest.approx(12e-3)


def test_profile_readers_need_a_profile_and_spans(cells):
    names = NEW[2:]
    for c in (ctx(cells), ctx(cells, fake_profile(step_events(0), 0)),
              ctx(cells, fake_profile(
                  [e for e in step_events(0)
                   if not e.name().startswith(("train.", "step.",
                                               "render."))], 1))):
        for name in names:
            assert read(name, c) is None, name


def fill_ring(first, last, wait_ns, reads):
    """Iterations first..last: batch_wait_ns and binning reads from the
    callables of the iteration."""
    tracing.reset()
    for it in range(first, last + 1):
        tracing.begin_step(it)
        tracing.count("batch_wait_ns", wait_ns(it))
        for _ in range(reads(it)):
            tracing.read("binning", torch.tensor(1))
        if it % 10 == 0:
            tracing.read("trainer.loss", torch.tensor(0.5))


def test_counter_readers_take_the_marks_window(cells):
    traffic = cells["lego.train"].traffic
    first = (traffic["start_iteration"] + traffic["check_steps"]
             + traffic["warmup_steps"] + 1)
    n = 20
    last = first + n - 1
    # Outside the window: waits of 1 s and 100 reads, which would show.
    inside = lambda it: first <= it <= last  # noqa: E731
    fill_ring(traffic["start_iteration"] + 1, last + 6,
              lambda it: (it - first + 1) * 1000 if inside(it) else 10**9,
              lambda it: 2 if inside(it) else 100)
    try:
        c = ctx(cells, stages=[{}] * n)
        assert spans.window_iterations(c) == (first, last)
        waits = sorted((it - first + 1) * 1000 for it in range(first,
                                                                last + 1))
        assert read("train.batch_wait_ms", c) == pytest.approx(
            (waits[n // 2 - 1] + waits[n // 2]) / 2 * 1e-6)
        tens = sum(1 for it in range(first, last + 1) if it % 10 == 0)
        assert read("train.host_reads_per_step", c) == pytest.approx(
            (2 * n + tens) / n)
        for name in NEW[:2]:
            assert read(name, ctx(cells)) is None, name    # no window
    finally:
        tracing.reset()


def test_counter_readers_without_the_module(cells, monkeypatch):
    """On a program with no `tracing` module, nothing and no error."""
    import fourdgs_tpu_torch.utils

    fill_ring(1, 50, lambda it: 1000, lambda it: 2)
    monkeypatch.setitem(sys.modules, "fourdgs_tpu_torch.utils.tracing", None)
    monkeypatch.delattr(fourdgs_tpu_torch.utils, "tracing")
    try:
        c = ctx(cells, stages=[{}] * 20)
        for name in NEW[:2]:
            assert read(name, c) is None, name
    finally:
        tracing.reset()
