"""The port's Trainer and its CLI on the CPU: against the JAX Trainer on the
committed synth_gate fixture (48 px, 300 points), bit-exact resume through
a densify event, resuming a checkpoint the JAX trainer wrote, and
`python -m fourdgs_tpu_torch.train --device cpu`.

Tolerances: the batch order, the active counts and the restored state
exact; losses rtol 1e-4 (the JAX trainer's step runs its production
numerics, `fast_grad_reduce=True`: bf16-split SSIM blurs, ~2^-17 on the
loss, and another order of the gradient sums, compounding over steps)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from fourdgs_tpu.config import load_config as jax_load_config
from fourdgs_tpu.engine.trainer import Trainer as JaxTrainer
from fourdgs_tpu_torch import train as port_train
from fourdgs_tpu_torch.config import load_config
from fourdgs_tpu_torch.engine.trainer import Trainer

from torch_helpers import SYNTH_GATE

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = ("xyz", "t", "scaling", "scaling_t", "rotation", "rotation_r",
          "f_dc", "f_rest", "opacity")


def _config(load, **opt):
    """synth_gate at resolution 2 (48 px), 300 points, batch 2, white
    background; no evaluation or checkpoint unless asked."""
    cfg = load(None, overrides=dict(
        gaussian_dim=4, rot_4d=True, time_duration=[0.0, 1.0], num_pts=300,
        batch_size=2, test_iterations=[], save_iterations=[],
        model=dict(source_path=SYNTH_GATE, resolution=2, eval=True,
                   white_background=True),
        pipeline=dict(eval_shfs_4d=True)))
    for k, v in dict(dict(densify_from_iter=1000,
                          opacity_reset_interval=1000), **opt).items():
        setattr(cfg.optimization, k, v)
    return cfg


def _make(trainer_cls, cfg):
    if trainer_cls is JaxTrainer:
        return JaxTrainer(cfg, verbose=False)
    return Trainer(cfg, device="cpu", verbose=False)


def _run(trainer, iterations):
    """Train to `iterations`: (batches drawn, per-step losses, active count
    after each step). The JAX trainer is always given an `on_step`: it then
    drains its overflow queue at every step, which keeps it clear of the
    unpacking fault at fourdgs_tpu/engine/trainer.py:902-903."""
    batches, losses, active = [], [], []
    epochs = trainer._epoch_batches

    def recorded():
        for b in epochs():
            batches.append(b)
            yield b

    trainer._epoch_batches = recorded

    def on_step(it, m):
        losses.append(float(m.loss))
        active.append(int(trainer.gauss.n_active))

    trainer.train(num_iterations=iterations, on_step=on_step)
    return batches, losses, active


def _widest_gap_threshold(state):
    """A densify grad threshold in the middle of the widest gap between
    the accumulated gradient norms of the active rows (their middle half),
    so that no row sits near it."""
    n = int(state.n_active)
    denom = np.asarray(state.denom)[:n]
    norms = np.sort(np.where(denom > 0, np.asarray(state.xyz_grad_accum)[:n]
                             / np.maximum(denom, 1.0), 0.0))
    lo, hi = n // 4, 3 * n // 4
    k = lo + int(np.argmax(np.diff(norms[lo:hi + 1])))
    return float((norms[k] + norms[k + 1]) / 2)


def test_trainer_matches_jax():
    """6 iterations with a densify event at 4 in which every hot row clones
    (percent_dense huge: no split, so no noise to share): the same batch
    order, losses and active count after the event as the JAX Trainer
    (white background: the opacity reset at densify_from_iter runs too)."""
    probe = _make(JaxTrainer, _config(jax_load_config))
    _run(probe, 4)
    thr = _widest_gap_threshold(probe.gauss)

    runs = {}
    for cls, load in ((JaxTrainer, jax_load_config), (Trainer, load_config)):
        cfg = _config(load, iterations=6, densify_from_iter=3,
                      densification_interval=4, percent_dense=1e6,
                      densify_grad_threshold=thr)
        trainer = _make(cls, cfg)
        runs[cls] = _run(trainer, 6)
        if cls is Trainer:
            trainer.close()
    (jb, jl, ja), (pb, pl, pa) = runs[JaxTrainer], runs[Trainer]
    assert pb == jb
    np.testing.assert_allclose(pl, jl, rtol=1e-4)
    assert pa == ja
    n0 = 300          # grew at the event at 4 only, by clones alone
    assert pa[:3] == [n0] * 3 and n0 < pa[3] == pa[5] < 2 * n0


def test_trainer_resume_is_bit_exact(tmp_path):
    """Checkpoint at 4 (after the densify event at 4), train on to 8 (a
    second event at 8): a fresh Trainer resumed from the checkpoint and
    trained to 8 ends with the same parameters, moments and count, bit for
    bit (the batch order's and the split noise's states are restored)."""
    cfg = _config(load_config, iterations=8, densify_from_iter=3,
                  densification_interval=4)
    with Trainer(cfg, device="cpu", verbose=False) as tr:
        tr.train(num_iterations=4)
        ck = str(tmp_path / "mid.pkl")
        tr.save(ck)
        n_mid = tr.n_active
        tr.train(num_iterations=8)
    assert tr.n_active != n_mid

    with Trainer(cfg, scene=tr.scene, device="cpu", verbose=False) as t2:
        t2.load(ck)
        assert (t2.step, t2.n_active) == (4, n_mid)
        t2.train(num_iterations=8)
    assert t2.n_active == tr.n_active
    for f in FIELDS:
        for a, b in ((t2.gauss.params, tr.gauss.params),
                     (t2.gauss.adam.mu, tr.gauss.adam.mu)):
            np.testing.assert_array_equal(getattr(a, f).numpy(),
                                          getattr(b, f).numpy(), err_msg=f)


def test_resumes_a_jax_training_checkpoint(tmp_path, request):
    """A checkpoint the JAX trainer wrote at step 3 (padded to its
    capacity) resumes in the port's Trainer: its active rows, moments,
    step, best PSNR and batch-order state, and the next two steps' batches
    and losses as the JAX trainer's own continuation."""
    jt = _make(JaxTrainer, _config(jax_load_config, iterations=5))
    _run(jt, 3)
    jt.best_psnr = 12.5
    ck = str(tmp_path / "jax.pkl")
    jt.save(ck)
    jb, jl, _ = _run(jt, 5)

    tr = Trainer(_config(load_config, iterations=5), device="cpu",
                 verbose=False)
    request.addfinalizer(tr.close)
    tr.load(ck)
    n = int(jt.gauss.n_active)
    assert jt.gauss.params.xyz.shape[0] > n       # JAX's padding rows
    assert (tr.step, tr.best_psnr, tr.n_active) == (3, 12.5, n)
    assert tr.gauss.params.xyz.shape[0] == n
    assert int(tr.gauss.adam.count) == 3
    from fourdgs_tpu.engine.checkpoint import load_checkpoint
    saved = load_checkpoint(ck)[0]
    for f in FIELDS:
        for got, want in ((tr.gauss.params, saved.params),
                          (tr.gauss.adam.nu, saved.adam.nu)):
            np.testing.assert_array_equal(getattr(got, f).numpy(),
                                          np.asarray(getattr(want, f))[:n],
                                          err_msg=f)
    pb, pl, _ = _run(tr, 5)
    assert pb == jb
    np.testing.assert_allclose(pl, jl, rtol=1e-4)


def test_close_stops_workers_and_log(tmp_path):
    """`close` (also the context manager's exit) joins a queued
    background checkpoint, stops both worker pools and closes
    metrics.jsonl; a second close is harmless."""
    cfg = _config(load_config, iterations=2)
    cfg.model.model_path = str(tmp_path / "out")
    with Trainer(cfg, device="cpu", verbose=False) as tr:
        tr.train()
        tr.save(str(tmp_path / "out" / "bg.pkl"), sync=False)
    assert (tmp_path / "out" / "bg.pkl").exists() and not tr._saves
    for pool in (tr._io_pool, tr._ckpt_pool):
        with pytest.raises(RuntimeError):
            pool.submit(int)
    assert tr.metrics_log._f is None
    assert json.loads((tmp_path / "out" / "metrics.jsonl")
                      .read_text().splitlines()[0])["step"] == 1
    tr.close()


def _write_cli_config(tmp_path):
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(
        "gaussian_dim: 4\nrot_4d: true\ntime_duration: [0.0, 1.0]\n"
        "num_pts: 200\nbatch_size: 2\nModelParams:\n  resolution: 2\n"
        f"  source_path: {SYNTH_GATE}\n  eval: true\n"
        "  white_background: true\n"
        "PipelineParams:\n  eval_shfs_4d: true\n")
    return str(cfg)


CLI_OVERRIDES = ["optimization.iterations=6",
                 "optimization.densify_from_iter=2",
                 "optimization.densification_interval=3",
                 "test_iterations=[6]", "save_iterations=[3,6]"]


def test_train_cli_on_cpu(tmp_path):
    """`python -m fourdgs_tpu_torch.train --device cpu` writes the
    reference's run artifacts; the YAML wins over a flag, --override over
    the YAML."""
    out = tmp_path / "out"
    argv = ["--config", _write_cli_config(tmp_path), "--device", "cpu",
            "--num_pts", "999", "--model_path", str(out), "--quiet",
            "--override"] + CLI_OVERRIDES
    cfg = port_train.build_config(port_train.parse_args(argv))
    assert cfg.num_pts == 200 and cfg.optimization.iterations == 6
    assert cfg.save_iterations == [3, 6] and cfg.model.model_path == str(out)

    res = subprocess.run([sys.executable, "-m", "fourdgs_tpu_torch.train"]
                         + argv, capture_output=True, text=True, timeout=300,
                         cwd=ROOT)
    assert res.returncode == 0, res.stderr[-4000:]
    for name in ("chkpnt3.pkl", "chkpnt6.pkl", "chkpnt_best.pkl",
                 "chkpnt_final.pkl", "input.ply", "cameras.json",
                 "metrics.jsonl"):
        assert (out / name).exists(), name
    lines = [json.loads(ln) for ln in
             (out / "metrics.jsonl").read_text().splitlines()]
    assert [ln["step"] for ln in lines if "loss" in ln] == [1]
    assert any("eval_psnr" in ln for ln in lines)
    assert len(json.loads((out / "cameras.json").read_text())) == 14


@pytest.mark.parametrize("case", ["no_source", "no_checkpoint", "no_cuda"])
def test_train_cli_refuses(tmp_path, capsys, case):
    cfg = _write_cli_config(tmp_path)
    argv = {"no_source": ["--source_path", str(tmp_path / "missing"),
                          "--device", "cpu"],
            "no_checkpoint": ["--config", cfg, "--device", "cpu",
                              "--start_checkpoint",
                              str(tmp_path / "missing.pkl")],
            "no_cuda": ["--config", cfg, "--device", "cuda"]}[case]
    if case == "no_cuda" and torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert port_train.main(argv) == 2
    assert "error:" in capsys.readouterr().err


@pytest.mark.parametrize("flag", ["--profile_dir", "--detect_anomaly"])
def test_train_cli_profile_and_anomaly(tmp_path, flag):
    """--profile_dir writes a torch.profiler chrome trace of iterations
    11-20, the step's spans named in it; --detect_anomaly trains under
    autograd's anomaly mode."""
    trace_dir = tmp_path / "trace"
    profile = flag == "--profile_dir"
    argv = ["--config", _write_cli_config(tmp_path), "--device", "cpu",
            "--quiet", "--override",
            f"optimization.iterations={20 if profile else 1}",
            "test_iterations=[]", "save_iterations=[]"]
    argv += [flag, str(trace_dir)] if profile else [flag]
    try:
        assert port_train.main(argv) == 0
        assert torch.is_anomaly_enabled() != profile
    finally:
        torch.autograd.set_detect_anomaly(False)
    if profile:
        trace = json.loads((trace_dir / "trace.json").read_text())
        assert trace["traceEvents"]
        names = {e.get("name") for e in trace["traceEvents"]}
        assert {"train.batch_wait", "train.step", "train.bookkeeping",
                "step.render", "step.backward", "step.update",
                "render.preprocess", "render.binning",
                "render.blend"} <= names
