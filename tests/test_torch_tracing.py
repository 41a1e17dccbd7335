"""The port's spans and counters (fourdgs_tpu_torch/utils/tracing.py) on
the CPU: a train_step with no profiler recording opens no range and gives
the same bits as under a profiler, with the same `mark` names in the same
order; the data-parallel step counts its reads; a Trainer run on tests/fixtures/synth_gate with a profiler started
and stopped in `on_step` (as a benchmark does) holds every span, nested,
each closed before `on_step`; the per-iteration counters count each host
read at its site and the batch wait; the blend kernels' launches count in
the wrappers; the ring keeps the last RING iterations and totals all."""

import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from fourdgs_tpu_torch.config import load_config
from fourdgs_tpu_torch.engine import step as port_step
from fourdgs_tpu_torch.engine.trainer import Trainer
from fourdgs_tpu_torch.ops import blend as port_blend
from fourdgs_tpu_torch.utils import tracing

from torch_helpers import SYNTH_GATE, one_torch_thread  # noqa: F401

ITERATIONS = 10
PROFILED = (3, 4, 5)          # iterations under the profiler
DENSIFY_AT = (5, 10)
STEP_MARKS = (["preprocess", "binning", "blend"] * 2
              + ["loss", "knn"] + ["blend_backward_start",
                                   "blend_backward"] * 2
              + ["backward", "update"])
SPANS = {"train.batch_wait": None, "train.step": None,
         "train.bookkeeping": None, "step.render": "train.step",
         "step.loss": "train.step", "step.rigid": "train.step",
         "step.backward": "train.step", "step.update": "train.step",
         "render.preprocess": "step.render",
         "render.binning": "step.render", "render.blend": "step.render"}


def _config(model_path=None, **opt):
    """synth_gate at 48 px, 300 points, batch 2, the rigid loss on, no
    evaluation or checkpoint."""
    cfg = load_config(None, overrides=dict(
        gaussian_dim=4, rot_4d=True, time_duration=[0.0, 1.0], num_pts=300,
        batch_size=2, test_iterations=[], save_iterations=[],
        model=dict(source_path=SYNTH_GATE, model_path=model_path,
                   resolution=2, eval=True, white_background=True),
        pipeline=dict(eval_shfs_4d=True)))
    for k, v in dict(dict(lambda_rigid=0.1, densify_from_iter=1000,
                          opacity_reset_interval=1000), **opt).items():
        setattr(cfg.optimization, k, v)
    return cfg


def _host_events(prof):
    """(name, start, end) of the profile's host events, by start."""
    return sorted((e.name(), e.start_ns(), e.end_ns())
                  for e in prof.profiler.kineto_results.events()
                  if e.device_type() == torch.autograd.DeviceType.CPU)


# --------------------------------------------------------------- the step
@pytest.fixture(scope="module")
def step_inputs():
    tr = Trainer(_config(), device="cpu", verbose=False)
    cams, gt, alpha, intr = tr._batch_arrays([0, 1])
    yield tr, (cams, gt, alpha, intr)
    tr.close()


def _step(tr, batch, marks):
    cams, gt, alpha, intr = batch
    return port_step.train_step(
        tr.gauss, 1, cams, gt, alpha, tr.bg, tr.step_cfg, tr.opts,
        env=tr.env, intrinsics=intr, mark=marks.append)


def _refuse(*_a, **_k):
    raise AssertionError("entered with no profiler recording")


def test_step_off_enters_nothing_and_matches_under_profiler(
        step_inputs, monkeypatch):
    """No profiler: no range is entered, no CUDA call is made, and the
    marks come in train_step's documented order; under a profiler the
    same step gives the same loss and state, bit for bit, and the same
    marks."""
    tr, batch = step_inputs
    with monkeypatch.context() as m:
        for mod, name in ((torch.profiler, "record_function"),
                          (torch.autograd.profiler, "record_function"),
                          (tracing, "_Range"),
                          (torch.cuda, "synchronize"),
                          (torch.cuda, "Event")):
            m.setattr(mod, name, _refuse)
        assert not torch.autograd.profiler._is_profiler_enabled
        marks_off = []
        state_off, _, met_off = _step(tr, batch, marks_off)
    marks_on = []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert torch.autograd.profiler._is_profiler_enabled
        state_on, _, met_on = _step(tr, batch, marks_on)
    assert marks_off == marks_on == STEP_MARKS
    names = [n for n, _, _ in _host_events(prof)]
    for span in ("step.render", "step.loss", "step.rigid", "step.backward",
                 "step.update", "render.preprocess"):
        assert span in names, span
    assert torch.equal(met_off.loss, met_on.loss)
    for a, b in zip(state_off.params, state_on.params):
        assert torch.equal(a, b)
    for a, b in zip(state_off.adam.mu + state_off.adam.nu,
                    state_on.adam.mu + state_on.adam.nu):
        assert torch.equal(a, b)
    for f in ("xyz_grad_accum", "t_grad_accum", "denom", "max_radii2d"):
        assert torch.equal(getattr(state_off, f), getattr(state_on, f)), f


def test_data_parallel_step_counts_its_reads(step_inputs):
    """The step over a one-rank gloo group reads binning's count per camera
    and the reduced instance counts, two reads at `step.all_reduce`."""
    from fourdgs_tpu_torch.parallel import make_mesh, multihost

    from torch_helpers import free_port

    tr, (cams, gt, alpha, intr) = step_inputs
    multihost.initialize(f"127.0.0.1:{free_port()}", 1, 0, device="cpu")
    try:
        tracing.reset()
        tracing.begin_step(1)
        port_step.train_step(tr.gauss, 1, cams, gt, alpha, tr.bg,
                             tr.step_cfg, tr.opts, env=tr.env,
                             intrinsics=intr, mesh=make_mesh())
        assert tracing.counts(1, 1) == [(1, {
            "host_reads.binning": 2, "host_reads.step.all_reduce": 2})]
    finally:
        torch.distributed.destroy_process_group()
        tracing.reset()


# ------------------------------------------------------------ the trainer
@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A Trainer run of ITERATIONS on synth_gate with metrics.jsonl and
    TensorBoard, densify events at DENSIFY_AT, a profiler started in the
    `on_step` before PROFILED and stopped in its last one, a host range
    "test.on_step" around each profiled `on_step`: (the profile's host
    events, the ring's entries, the counter totals)."""
    tracing.reset()
    model = str(tmp_path_factory.mktemp("tracing") / "model")
    cfg = _config(model, iterations=ITERATIONS, densify_from_iter=1,
                  densification_interval=5, densify_until_iter=100)
    prof = profile(activities=[ProfilerActivity.CPU])

    def on_step(it, metrics):
        if it in PROFILED:
            with torch.profiler.record_function("test.on_step"):
                pass
        if it == PROFILED[0] - 1:
            prof.__enter__()
        if it == PROFILED[-1]:
            prof.__exit__(None, None, None)

    with Trainer(cfg, device="cpu", verbose=False) as tr:
        tr.train(on_step=on_step)
    assert os.path.exists(os.path.join(model, "metrics.jsonl"))
    return (_host_events(prof), tracing.counts(1, ITERATIONS),
            tracing.totals())


def _within(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


@pytest.mark.parametrize("name", sorted(SPANS))
def test_trainer_span_nesting(trained, name):
    """Each span once per profiled iteration (render's per camera), inside
    its parent span, and before the iteration's `on_step`."""
    events = trained[0]
    on_step = [e for e in events if e[0] == "test.on_step"]
    assert len(on_step) == len(PROFILED)
    spans = [e for e in events if e[0] == name]
    per = 2 if name.startswith("render.") else 1
    assert len(spans) == per * len(PROFILED)
    parent = SPANS[name]
    for s in spans:
        if parent is not None:
            assert any(_within(s, p) for p in events if p[0] == parent)
        if name.startswith("render."):
            assert any(_within(s, p) for p in events if p[0] == "train.step")
        assert not any(_within(o, s) for o in on_step)
        assert not any(_within(s, o) for o in on_step)
    # Each iteration's spans close before its on_step opens.
    for i, o in enumerate(on_step):
        first = on_step[i - 1][2] if i else 0
        mine = [s for s in spans if first < s[1] < o[1]]
        assert len(mine) == per
        assert all(s[2] <= o[1] for s in mine)


def _expected_reads(it):
    """The host reads of iteration `it` of the `trained` run by site: two
    cameras' binning and the loss every step, the console's psnr at 1,
    metrics.jsonl's six tensors (l1, ssim_loss, psnr, total_points, rigid,
    motion) and TensorBoard's four (l1, ssim_loss, total_points, rigid) at
    1 and every 10th, densify's active count and pruned count at each
    event."""
    want = {"binning": 2, "trainer.loss": 1}
    if it == 1:
        want["trainer.console"] = 1
    if it == 1 or it % 10 == 0:
        want.update({"metrics_jsonl": 6, "trainer.tensorboard": 4})
    if it in DENSIFY_AT:
        want["densify"] = 2
    return want


@pytest.mark.parametrize("it", range(1, ITERATIONS + 1))
def test_ring_counts_reads_and_batch_wait(trained, it):
    _, ring, _ = trained
    assert [i for i, _ in ring] == list(range(1, ITERATIONS + 1))
    counts = dict(ring)[it]
    reads = {k[len("host_reads."):]: v for k, v in counts.items()
             if k.startswith("host_reads.")}
    assert reads == _expected_reads(it)
    assert set(reads) <= set(tracing.READ_SITES)
    assert counts["batch_wait_ns"] > 0
    assert not any(k.startswith("launches.") for k in counts)   # CPU


def test_totals_sum_the_ring(trained):
    _, ring, totals = trained
    want = {}
    for _, c in ring:
        for k, v in c.items():
            want[k] = want.get(k, 0) + v
    assert totals == want


# --------------------------------------------------------------- counters
def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


LAUNCHES = {
    "k1": ("blend_forward", "launch_forward",
           lambda: (_meta(4, 12), _meta(3, dtype=torch.int32),
                    _meta(6, dtype=torch.int32), _meta(6, dtype=torch.int32),
                    3)),
    "k2": ("blend_backward", "launch_backward",
           lambda: (_meta(4, 12), _meta(3, dtype=torch.int32),
                    _meta(6, dtype=torch.int32), _meta(6, 256),
                    _meta(6, 256, dtype=torch.int32), _meta(6, 7, 256), 3)),
    "k3": ("blend_infer", "launch_infer",
           lambda: (_meta(4, 8, dtype=torch.int32),
                    _meta(3, dtype=torch.int32), _meta(6, dtype=torch.int32),
                    _meta(6, dtype=torch.int32), 3)),
}


@pytest.mark.parametrize("kernel", sorted(LAUNCHES))
def test_wrappers_count_launches(kernel, monkeypatch):
    """A device tensor's call counts one launch of its kernel and none of
    the others, in the open iteration's entry; a CPU call counts none."""
    wrapper, launcher, args = LAUNCHES[kernel]
    calls = []
    monkeypatch.setattr(port_blend, launcher,
                        lambda *a: calls.append(a) or "out")
    tracing.reset()
    tracing.begin_step(7)
    for _ in range(3):
        assert getattr(port_blend, wrapper)(*args()) == "out"
    assert len(calls) == 3
    assert tracing.counts(7, 7) == [(7, {f"launches.{kernel}": 3})]
    assert tracing.totals() == {f"launches.{kernel}": 3}
    tracing.reset()


def test_ring_keeps_the_last_iterations_and_totals_all(monkeypatch):
    monkeypatch.setattr(tracing, "RING", 4)
    tracing.reset()
    tracing.count("launches.k3")               # before any iteration
    for it in range(1, 11):
        tracing.begin_step(it)
        tracing.count("batch_wait_ns", 100 * it)
        assert tracing.read("binning", torch.tensor(it)) == it
    assert [i for i, _ in tracing.counts(0, 100)] == [7, 8, 9, 10]
    assert tracing.counts(8, 9) == [
        (8, {"batch_wait_ns": 800, "host_reads.binning": 1}),
        (9, {"batch_wait_ns": 900, "host_reads.binning": 1})]
    assert tracing.totals() == {"launches.k3": 1, "batch_wait_ns": 5500,
                                "host_reads.binning": 10}
    tracing.reset()
    assert tracing.totals() == {} and tracing.counts(0, 100) == []


@pytest.mark.parametrize("value", [np.float32(0.25), 3])
def test_read_returns_the_python_value(value):
    x = torch.tensor(value)
    got = tracing.read("trainer.loss", x)
    assert got == x.item() and type(got) is type(x.item())
