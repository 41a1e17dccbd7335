"""The port's data-parallel step and multi-process helpers
(`parallel/mesh.py`, `parallel/multihost.py`) on the CPU: two gloo ranks
in subprocesses (tests/torch_parallel_worker.py), each holding the
sharded step to the single-process `train_step` on the same inputs, and
`python -m torch.distributed.run` training the fixture on two ranks
against one process.

Bounds: those of tests/test_parallel.py:117-127 (loss rtol 1e-5, PSNR
rtol 1e-4, xyz atol 1e-5, xyz_grad_accum atol 1e-5 rtol 1e-4,
max_radii2d atol 1e-4); inside one step the ranks differ from one process
only in the order of the gradient sums, so the workers' gradients,
statistics and parameters are held to 1e-6 of each leaf's largest value.
Every subprocess wait has its own timeout, so that a hung rendezvous
fails the test."""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from fourdgs_tpu.parallel import multihost as jax_multihost
from fourdgs_tpu_torch.engine.checkpoint import load_checkpoint
from fourdgs_tpu_torch.parallel import multihost

from torch_helpers import (SYNTH_GATE, free_port,
                           one_torch_thread)  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_parallel_worker.py")
WAIT_S = 120


def cpu_env():
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
    env.pop("WORLD_SIZE", None)
    return env


def run_ranks(argvs, cwd=None):
    """Start one process per argv, wait for each with its own timeout, and
    return their outputs; a hung or failed rank fails the test."""
    procs = [subprocess.Popen(a, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True,
                              env=cpu_env(), cwd=cwd) for a in argvs]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=WAIT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
    return outs


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The two workers' results, rank by rank."""
    out = str(tmp_path_factory.mktemp("ranks") / "result")
    port = free_port()
    run_ranks([[sys.executable, WORKER, str(r), "2", str(port), out]
               for r in range(2)])
    results = []
    for r in range(2):
        with open(f"{out}.{r}") as f:
            results.append(json.load(f))
    return results


@pytest.mark.parametrize("case", ["batch2", "strips2_straddle",
                                  "strips2_env_opa"])
def test_two_rank_step_equals_single_process(ranks, case):
    for r in ranks:
        got = r[case]
        assert got["metric_loss"] <= 1e-5 and got["metric_psnr"] <= 1e-4
        for f in ("metric_l1", "metric_ssim_loss", "metric_rigid"):
            assert got[f] <= 1e-5, (f, got[f])
        assert got["counts_equal"] and got["ranks_equal"]
        for f in ("grad", "params", "stats", "env_grad"):
            assert got.get(f, 0.0) <= 1e-6, (f, got[f])


def test_eval_strips_spread_over_ranks(ranks):
    for r in ranks:
        got = r["eval_strips"]
        assert got["spread_vs_alone"] == 0.0
        assert got["spread_vs_full"] <= 2e-5
        assert got["counts_equal"]
        # Without a mesh a strips config renders the full frame.
        assert got["no_mesh_vs_full"] == 0.0


def test_bad_batch_raises(ranks):
    for r in ranks:
        assert r["bad_batch"].startswith("ValueError: batch_size*strips 3")


@pytest.mark.parametrize("config", ["data_axis_1", "batch_1"])
def test_trainer_refuses_ranks_it_cannot_split_over(ranks, config):
    """Two ranks with data_axis 1, or a batch of one camera of one strip:
    the Trainer raises rather than train a replica on each rank."""
    for r in ranks:
        got = r["trainer_refuses"][config]
        assert got.startswith("ValueError: 2 ranks train data-parallel"), got


def test_process_batch_indices_match_jax(ranks, monkeypatch):
    monkeypatch.setattr(jax, "process_count", lambda: 2)
    for pid, r in enumerate(ranks):
        monkeypatch.setattr(jax, "process_index", lambda p=pid: p)
        for key, batch in (("12", list(range(12))), ("5", [5, 2, 9, 7, 1])):
            assert r["batch_indices"][key] == \
                jax_multihost.process_batch_indices(batch)
        assert r["local_batch"] == [[float(pid)] * 3] * 2
    # One process, no group: the whole batch, as in JAX.
    assert multihost.process_batch_indices([5, 2, 9]) == [5, 2, 9]
    with pytest.raises(RuntimeError, match="no process group"):
        multihost.global_mesh()


TRAIN_ARGS = [
    "--device", "cpu", "--quiet", "--override",
    f"model.source_path={SYNTH_GATE}", "model.resolution=2",
    "model.eval=true", "model.white_background=true", "gaussian_dim=4",
    "rot_4d=true", "time_duration=[0.0,1.0]", "num_pts=300", "batch_size=1",
    "strips=2", "optimization.iterations=20",
    "optimization.densify_from_iter=1000", "test_iterations=[20]",
    "save_iterations=[20]"]


def test_torchrun_cli_matches_single_process(tmp_path):
    """20 iterations of the fixture at batch 1 as 2 strips of 24 rows, one
    strip per rank (the strip colours gathered for the loss), and an
    evaluation whose strips spread over the ranks: one metrics.jsonl and a
    checkpoint equal to one process's run."""
    one, two = tmp_path / "one", tmp_path / "two"
    cmd = [sys.executable, "-m", "fourdgs_tpu_torch.train"]
    run_ranks([cmd + ["--model_path", str(one)] + TRAIN_ARGS], cwd=ROOT)
    run_ranks([[sys.executable, "-m", "torch.distributed.run", "--nnodes",
                "1", "--nproc_per_node", "2", "--master_addr", "127.0.0.1",
                "--master_port", str(free_port()), "-m",
                "fourdgs_tpu_torch.train", "--model_path", str(two)]
               + TRAIN_ARGS], cwd=ROOT)
    def files(d):        # the event file's name holds its creation time
        return sorted("events" if f.startswith("events.out") else f
                      for f in os.listdir(d))

    assert files(two) == files(one)
    assert "metrics.jsonl" in files(one)
    a = load_checkpoint(str(one / "chkpnt20.pkl"), device="cpu")[0]
    b = load_checkpoint(str(two / "chkpnt20.pkl"), device="cpu")[0]
    np.testing.assert_allclose(b.params.xyz.numpy(), a.params.xyz.numpy(),
                               atol=1e-5)
    np.testing.assert_allclose(b.xyz_grad_accum.numpy(),
                               a.xyz_grad_accum.numpy(), atol=1e-5,
                               rtol=1e-4)
    np.testing.assert_allclose(b.max_radii2d.numpy(), a.max_radii2d.numpy(),
                               atol=1e-4)
    np.testing.assert_array_equal(b.denom.numpy(), a.denom.numpy())
    rows = [[json.loads(line) for line in open(d / "metrics.jsonl")]
            for d in (one, two)]
    assert [r["step"] for r in rows[0]] == [r["step"] for r in rows[1]]
    for r1, r2 in zip(*rows):
        for key in ("loss", "psnr", "eval_psnr"):
            if key in r1:
                np.testing.assert_allclose(r2[key], r1[key], rtol=1e-4)
