"""The port's TensorBoard writer (fourdgs_tpu_torch/utils/tb_writer.py)
and where the Trainer calls it, on the CPU.

The writer against the JAX package's: the same scalar, image and histogram
calls at the same wall time write the same bytes, decoded record by record
with the independent parser of tests/test_tb_writer.py. A short port
Trainer run on tests/fixtures/synth_gate writes the reference's tags at
the JAX trainer's cadence (step scalars at step 1 and every 10 steps; the
evaluation scalars, the opacity histogram and the panels at each test
iteration), with the values that metrics.jsonl holds (f32 rounding), and
`scripts/training_record.py` summarises that run's metrics.jsonl.
`read_tags` lists that file's tags and steps as the independent parser
does."""

import glob
import json
import os
import struct
import subprocess
import sys
import time

import numpy as np
import pytest

from fourdgs_tpu.utils import tb_writer as jax_tb
from fourdgs_tpu_torch.config import load_config
from fourdgs_tpu_torch.engine.trainer import Trainer
from fourdgs_tpu_torch.utils import tb_writer as port_tb

from test_tb_writer import _get, _parse_fields, _read_records
from torch_helpers import SYNTH_GATE, one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ITERATIONS = 20
STEP_TAGS = ("train_loss_patches/l1_loss", "train_loss_patches/ssim_loss",
             "train_loss_patches/total_loss", "train_loss_patches/rigid_loss",
             "total_points", "iter_time")


def _summary(record):
    """(step, tag, Value fields) of one summary event record."""
    ev = _parse_fields(record)
    value = _parse_fields(_get(_parse_fields(_get(ev, 5)[0]), 1)[0])
    return _get(ev, 2)[0], _get(value, 1)[0].decode(), value


def test_port_writer_writes_the_jax_records(tmp_path, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1792000000.25)
    rng = np.random.default_rng(0)
    img = rng.random((8, 12, 3)).astype(np.float32)
    img_u8 = rng.integers(0, 256, (6, 10, 3), dtype=np.uint8)
    values = rng.normal(size=257)
    paths = []
    for mod, name in ((port_tb, "port"), (jax_tb, "jax")):
        w = mod.TBWriter(str(tmp_path / name))
        w.add_scalar("train_loss_patches/total_loss", 0.125, 10)
        w.add_scalar("total_points", 4670, 11)
        w.add_image("test_view_0/gt_vs_render", img, 20)
        w.add_image("train_view_3/gt_vs_render", img_u8, 21)
        w.add_histogram("scene/opacity_histogram", values, 30)
        w.add_histogram("scene/empty", np.zeros(0), 31)   # writes nothing
        w.close()
        (path,) = glob.glob(str(tmp_path / name / "events.out.tfevents.*"))
        paths.append(path)
    assert os.path.basename(paths[0]) == os.path.basename(paths[1])
    port, ref = (_read_records(p) for p in paths)      # CRCs checked
    assert len(port) == len(ref) == 6
    assert port == ref
    assert _get(_parse_fields(port[0]), 3) == [b"brain.Event:2"]
    assert [_summary(r)[:2] for r in port[1:]] == [
        (10, "train_loss_patches/total_loss"), (11, "total_points"),
        (20, "test_view_0/gt_vs_render"), (21, "train_view_3/gt_vs_render"),
        (30, "scene/opacity_histogram")]
    histo = _parse_fields(_get(_summary(port[5])[2], 7)[0])
    assert _get(histo, 3)[0] == 257.0


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A port Trainer run of 20 iterations on synth_gate (48 px, 300
    points, batch 2, rigid loss on) with an evaluation at 20: the model
    directory."""
    model = tmp_path_factory.mktemp("tb") / "model"
    cfg = load_config(None, overrides=dict(
        gaussian_dim=4, rot_4d=True, time_duration=[0.0, 1.0], num_pts=300,
        batch_size=2, test_iterations=[ITERATIONS], save_iterations=[],
        model=dict(source_path=SYNTH_GATE, model_path=str(model),
                   resolution=2, eval=True, white_background=True),
        pipeline=dict(eval_shfs_4d=True),
        optimization=dict(iterations=ITERATIONS, lambda_rigid=0.1,
                          densify_from_iter=1000,
                          opacity_reset_interval=1000)))
    with Trainer(cfg, device="cpu", verbose=False) as trainer:
        trainer.train()
        assert not trainer.tb._f.closed
    assert trainer.tb._f.closed               # close() closed the file
    return model


def test_trainer_writes_reference_tags_at_jax_cadence(trained):
    (path,) = glob.glob(str(trained / "events.out.tfevents.*"))
    records = _read_records(path)
    assert _get(_parse_fields(records[0]), 3) == [b"brain.Event:2"]
    tags = {}
    scalars = {}
    for rec in records[1:]:
        step, tag, value = _summary(rec)
        tags.setdefault(tag, []).append(step)
        if _get(value, 2):
            scalars[(tag, step)] = _get(value, 2)[0]
    for tag in STEP_TAGS:
        assert tags.pop(tag) == [1, 10, 20], tag
    for split, views in (("test", 3), ("train", 5)):
        assert tags.pop(f"{split}/loss_viewpoint - psnr") == [ITERATIONS]
        assert tags.pop(f"{split}/loss_viewpoint - ssim") == [ITERATIONS]
        for i in range(views):
            assert tags.pop(f"{split}_view_{i}/gt_vs_render") == [ITERATIONS]
    assert tags.pop("scene/opacity_histogram") == [ITERATIONS]
    assert not tags, f"unexpected tags {sorted(tags)}"

    rows = [json.loads(line) for line in open(trained / "metrics.jsonl")]
    step20 = next(r for r in rows if r["step"] == 20 and "loss" in r)
    f32 = lambda v: struct.unpack("<f", struct.pack("<f", v))[0]  # noqa: E731
    assert scalars[("train_loss_patches/total_loss", 20)] == f32(
        step20["loss"])
    assert scalars[("train_loss_patches/rigid_loss", 20)] == f32(
        step20["rigid"]) > 0
    assert scalars[("total_points", 20)] == step20["total_points"]
    evals = [r["eval_psnr"] for r in rows if "eval_psnr" in r]
    assert scalars[("test/loss_viewpoint - psnr", 20)] == f32(evals[0])


def test_read_tags_agrees_with_independent_parser(trained):
    (path,) = glob.glob(str(trained / "events.out.tfevents.*"))
    want = {}
    for rec in _read_records(path)[1:]:
        step, tag, _ = _summary(rec)
        want.setdefault(tag, []).append(step)
    got = port_tb.read_tags(path)
    assert got == want
    assert got["total_points"] == [1, 10, 20]


def test_training_record_reads_port_metrics(trained):
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "scripts", "training_record.py"),
         str(trained)], capture_output=True, text=True, check=True).stdout
    lines = out.splitlines()
    assert lines[0].startswith("| iteration | test PSNR | points")
    assert "rigid" in lines[0]                 # the rigid loss was on
    assert lines[2].startswith(f"| {ITERATIONS} | ")
    assert f"iterations recorded: {ITERATIONS}" in out
    assert "points: 300 -> peak 300 -> final 300" in out
    assert "truncated steps: 0" in out
