"""Training-quality gate of the port, on the CPU: the JAX package's gate
(tests/test_training_quality.py) with the same config, through the port's
Trainer. From a random-colour init of the committed synth_gate fixture (96
px, 14 train views, a 1500-point cloud), 250 iterations of batch 2 with a
densify window 60-180 every 60 (one event, at 120), seed 6666; held-out
PSNR must rise by more than 7 dB and end above 17 dB (the JAX trainer
reaches ~19.8 dB from 9.4).

The plain blends run here one rank at a time on small tensors, which is
launch-bound: one intra-op thread is faster than many, and the fixture
runs with one."""

import numpy as np
import pytest
import torch

from torch_helpers import SYNTH_GATE


@pytest.fixture(scope="module")
def trained():
    from fourdgs_tpu_torch.config import load_config
    from fourdgs_tpu_torch.engine.trainer import Trainer

    cfg = load_config(None)
    cfg.model.source_path = SYNTH_GATE
    cfg.model.white_background = True
    cfg.model.eval = True
    cfg.gaussian_dim = 4
    cfg.rot_4d = True
    cfg.time_duration = (0.0, 1.0)
    cfg.num_pts = 1500
    cfg.batch_size = 2
    cfg.seed = 6666
    cfg.test_iterations = []
    cfg.save_iterations = []
    o = cfg.optimization
    o.iterations = 250
    o.densify_from_iter = 60
    o.densify_until_iter = 180
    o.densification_interval = 60
    o.opacity_reset_interval = 10000
    o.position_lr_max_steps = 250

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with Trainer(cfg, device="cpu", verbose=False) as tr:
            psnr0 = tr.evaluate()
            losses = []
            tr.train(on_step=lambda it, m: losses.append(float(m.loss)))
            psnr1 = tr.evaluate()
    finally:
        torch.set_num_threads(threads)
    return tr, psnr0, psnr1, losses


def test_port_trains_to_psnr(trained):
    _, psnr0, psnr1, _ = trained
    assert psnr1 - psnr0 > 7.0, (psnr0, psnr1)
    assert psnr1 > 17.0, psnr1


def test_port_loss_decreases_and_stays_finite(trained):
    _, _, _, losses = trained
    assert len(losses) == 250
    assert np.all(np.isfinite(losses))
    assert np.min(losses) >= 0.0
    assert np.mean(losses[-20:]) < 0.5 * np.mean(losses[:10])


def test_port_densification_ran(trained):
    tr, _, _, _ = trained
    assert tr.n_active != 1500
    assert int(tr.gauss.n_active) == tr.gauss.params.xyz.shape[0]
