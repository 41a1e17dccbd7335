"""Reference .pth checkpoints in the port (fourdgs_tpu_torch/models/
torch_import.py) against the JAX package's importer and exporter, and the
entry points that read or write them, on the CPU.

Capture tuples built from numpy seeds (the 4D layout with and without
optimizer state, with an env map, and the 3D layout) are imported by both
packages: the port's state equals the active rows of the JAX package's
exactly (params, Adam moments and step, densify statistics, active count)
and so does `meta`. Exports from the same state are equal tensor for
tensor, and the JAX importer reads the port's export back exactly. Then
`Trainer(loaded_pth=)`, `--start_checkpoint x.pth`, `Evaluator.load` and
`render_cli --export_pth` run on the CPU."""

import json

import numpy as np
import pytest
import torch

from fourdgs_tpu.models import torch_import as jax_import
from fourdgs_tpu_torch import render_cli
from fourdgs_tpu_torch import train as port_train
from fourdgs_tpu_torch.config import load_config
from fourdgs_tpu_torch.engine.checkpoint import load_checkpoint
from fourdgs_tpu_torch.engine.evaluator import Evaluator
from fourdgs_tpu_torch.engine.trainer import Trainer
from fourdgs_tpu_torch.models import torch_import

from torch_helpers import SYNTH_GATE, one_torch_thread  # noqa: F401

FIELDS = ("xyz", "t", "scaling", "scaling_t", "rotation", "rotation_r",
          "f_dc", "f_rest", "opacity")
STATS = ("xyz_grad_accum", "t_grad_accum", "denom", "max_radii2d")
GROUPS = ("xyz", "f_dc", "f_rest", "opacity", "scaling", "rotation", "t",
          "scaling_t", "rotation_r")


def _capture(seed, *, n=37, sh=16, dim=4, adam=True, env_res=0, step=123.0):
    """A reference capture() tuple of random tensors (the 4D or the 3D
    layout of gaussian_model.py:99-136) and its params by name."""
    rng = np.random.default_rng(seed)
    t = lambda *s: torch.from_numpy(  # noqa: E731
        rng.normal(size=s).astype(np.float32))
    params = dict(xyz=t(n, 3), f_dc=t(n, 1, 3), f_rest=t(n, sh - 1, 3),
                  opacity=t(n, 1), scaling=t(n, 3), rotation=t(n, 4))
    if dim == 4:
        params.update(t=t(n, 1), scaling_t=t(n, 1), rotation_r=t(n, 4))
    groups = [g for g in GROUPS if g in params]
    opt_state = {}
    if adam:
        opt_state = {
            "state": {i: {"step": torch.tensor(step) if i % 2 else step,
                          "exp_avg": t(*params[g].shape) * 0.01,
                          "exp_avg_sq": t(*params[g].shape).abs() * 1e-3}
                      for i, g in enumerate(groups)},
            "param_groups": [{"name": g, "params": [i]}
                             for i, g in enumerate(groups)]}
    capture = (2, params["xyz"], params["f_dc"], params["f_rest"],
               params["scaling"], params["rotation"], params["opacity"],
               t(n).abs(), t(n, 1).abs(), t(n, 1).abs(), t(n, 1).abs(),
               opt_state, 4.5)
    if dim == 3:        # no t_gradient_accum either
        return capture[:9] + capture[10:], params
    return capture + (
        params["t"], params["scaling_t"], params["rotation_r"], True,
        t(3, env_res, env_res) if env_res else None, 1), params


CASES = dict(
    adam_4d=dict(), no_adam_4d=dict(adam=False), env_4d=dict(env_res=8),
    layout_3d=dict(dim=3, sh=4))


def _assert_state_equals_jax(port, ref, n):
    assert int(port.n_active) == int(ref.n_active) == n
    for f in FIELDS:
        want = np.asarray(getattr(ref.params, f))[:n]
        got = getattr(port.params, f).numpy()
        assert got.shape == want.shape, f
        np.testing.assert_array_equal(got, want, err_msg=f)
        for moment in ("mu", "nu"):
            np.testing.assert_array_equal(
                getattr(getattr(port.adam, moment), f).numpy(),
                np.asarray(getattr(getattr(ref.adam, moment), f))[:n],
                err_msg=f"{moment} {f}")
    assert int(port.adam.count) == int(ref.adam.count)
    for f in STATS:
        np.testing.assert_array_equal(getattr(port, f).numpy(),
                                      np.asarray(getattr(ref, f))[:n],
                                      err_msg=f)


def _assert_meta_equal(port, ref):
    assert port.keys() == ref.keys()
    for key in port:
        if key == "env_map" and ref[key] is not None:
            np.testing.assert_array_equal(port[key], ref[key])
        else:
            assert port[key] == ref[key], key


@pytest.mark.parametrize("with_optimizer", [True, False])
@pytest.mark.parametrize("case", list(CASES))
def test_import_equals_jax_active_rows(tmp_path, case, with_optimizer):
    capture, params = _capture(3, **CASES[case])
    path = str(tmp_path / "chkpnt100.pth")
    torch.save((capture, 100), path)
    port, meta = torch_import.import_reference_pth(
        path, duration=2.0, with_optimizer=with_optimizer, device="cpu")
    ref, ref_meta = jax_import.import_reference_pth(
        path, duration=2.0, with_optimizer=with_optimizer)
    _assert_state_equals_jax(port, ref, 37)
    _assert_meta_equal(meta, ref_meta)
    assert port.params.xyz.shape[0] == 37          # no padding rows
    assert port.adam.count.dtype == torch.int64
    np.testing.assert_array_equal(port.params.xyz.numpy(),
                                  params["xyz"].numpy())
    moved = with_optimizer and CASES[case].get("adam", True)
    assert int(port.adam.count) == (123 if moved else 0)
    assert (float(port.adam.mu.xyz.abs().max()) > 0) == moved
    assert meta["iteration"] == 100
    if case == "env_4d":
        assert meta["env_map"].shape == (8, 8, 3)


@pytest.mark.parametrize("case", ["adam_4d", "env_4d", "layout_3d"])
def test_export_equals_jax_and_round_trips(tmp_path, case):
    capture, _ = _capture(4, **CASES[case])
    src = str(tmp_path / "src.pth")
    torch.save((capture, 77), src)
    port, meta = torch_import.import_reference_pth(src, device="cpu")
    ref, ref_meta = jax_import.import_reference_pth(src)
    kw = dict(iteration=meta["iteration"],
              active_sh_degree=meta["active_sh_degree"],
              active_sh_degree_t=meta["active_sh_degree_t"],
              rot_4d=meta["rot_4d"],
              spatial_lr_scale=meta["spatial_lr_scale"])
    port_path, jax_path = str(tmp_path / "port.pth"), str(tmp_path / "j.pth")
    env = meta["env_map"]
    torch_import.export_reference_pth(
        port_path, port, env_map=None if env is None else torch.as_tensor(
            env), **kw)
    jax_import.export_reference_pth(jax_path, ref,
                                    env_map=ref_meta["env_map"], **kw)
    (a, it_a), (b, it_b) = (torch.load(p, weights_only=False)
                            for p in (port_path, jax_path))
    assert it_a == it_b == 77 and len(a) == len(b) == 19
    for i, (x, y) in enumerate(zip(a, b)):
        if isinstance(y, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y), i
        else:
            assert type(x) is type(y) and x == y, i
    # The JAX importer reads the port's export back to the same state.
    back, back_meta = jax_import.import_reference_pth(port_path)
    for f in FIELDS:
        np.testing.assert_array_equal(
            np.asarray(getattr(back.params, f))[:37],
            getattr(port.params, f).numpy(), err_msg=f)
    for f in STATS:
        np.testing.assert_array_equal(np.asarray(getattr(back, f))[:37],
                                      getattr(port, f).numpy(), err_msg=f)
    assert back_meta["iteration"] == 77
    if env is not None:
        np.testing.assert_array_equal(back_meta["env_map"], env)


def _gate_config(model_path="", **top):
    return load_config(None, overrides=dict(
        dict(gaussian_dim=4, rot_4d=True, time_duration=[0.0, 1.0],
             num_pts=300, batch_size=2, test_iterations=[],
             save_iterations=[],
             model=dict(source_path=SYNTH_GATE, model_path=model_path,
                        resolution=2, eval=True, white_background=True),
             pipeline=dict(eval_shfs_4d=True, env_map_res=8),
             optimization=dict(densify_from_iter=1000,
                               opacity_reset_interval=1000)), **top))


@pytest.fixture(scope="module")
def gate_pth(tmp_path_factory):
    """A reference .pth of a port Trainer on synth_gate after 4 steps
    (Adam moments moved), with a random 8x8 env map, at iteration 4; and
    the state it holds."""
    root = tmp_path_factory.mktemp("pth")
    with Trainer(_gate_config(), device="cpu", verbose=False) as trainer:
        trainer.train(num_iterations=4)
        state = trainer.gauss
    rng = np.random.default_rng(5)
    env = rng.random((8, 8, 3)).astype(np.float32)
    capture_path = str(root / "chkpnt4.pth")
    torch_import.export_reference_pth(capture_path, state, iteration=4,
                                      env_map=env)
    # The exporter leaves the optimizer state empty; write the moments in
    # the reference's state_dict layout so that a resume restores them.
    capture, it = torch.load(capture_path, weights_only=False)
    opt = {"state": {}, "param_groups": []}
    for i, g in enumerate(GROUPS):
        opt["param_groups"].append({"name": g, "params": [i]})
        opt["state"][i] = {"step": torch.tensor(4.0),
                           "exp_avg": getattr(state.adam.mu, g).clone(),
                           "exp_avg_sq": getattr(state.adam.nu, g).clone()}
    capture = capture[:11] + (opt,) + capture[12:]
    torch.save((capture, it), capture_path)
    return capture_path, state, env


def _assert_params_equal(gauss, state):
    for f in FIELDS:
        assert torch.equal(getattr(gauss.params, f),
                           getattr(state.params, f)), f


def test_trainer_loaded_pth_starts_a_fresh_optimizer(gate_pth):
    path, state, _ = gate_pth
    cfg = _gate_config(model=dict(source_path=SYNTH_GATE, resolution=2,
                                  eval=True, white_background=True,
                                  loaded_pth=path))
    with Trainer(cfg, device="cpu", verbose=False) as trainer:
        _assert_params_equal(trainer.gauss, state)
        assert trainer.n_active == int(state.n_active)
        assert int(trainer.gauss.adam.count) == 0 and trainer.step == 0
        assert float(trainer.gauss.adam.mu.xyz.abs().max()) == 0.0
        trainer.train(num_iterations=2)
        assert trainer.step == 2


def test_train_cli_resumes_from_pth(gate_pth, tmp_path):
    path, state, env = gate_pth
    model = tmp_path / "model"
    cfg = _gate_config(str(model), start_checkpoint=path)
    with Trainer(cfg, device="cpu", verbose=False) as trainer:
        _assert_params_equal(trainer.gauss, state)
        assert trainer.step == 4 and int(trainer.gauss.adam.count) == 4
        for f in FIELDS:
            assert torch.equal(getattr(trainer.gauss.adam.mu, f),
                               getattr(state.adam.mu, f)), f
        assert torch.equal(trainer.env.texture, torch.as_tensor(env))
        assert torch.equal(trainer.gauss.denom, state.denom)
    argv = ["--device", "cpu", "--quiet", "--start_checkpoint", path,
            "--source_path", SYNTH_GATE, "--model_path", str(model),
            "--resolution", "2", "--num_pts", "300", "--iterations", "6",
            "--eval", "--gaussian_dim", "4", "--rot_4d",
            "--test_iterations", "6",
            "--override", "optimization.densify_from_iter=1000",
            "pipeline.env_map_res=8", "pipeline.eval_shfs_4d=true",
            "model.white_background=true"]
    assert port_train.main(argv) == 0
    steps = [json.loads(line)["step"] for line in open(
        model / "metrics.jsonl")]
    assert steps[0] == 6            # steps 5 and 6 ran, logged at 6
    assert load_checkpoint(str(model / "chkpnt_final.pkl"),
                           device="cpu")[2] == 6


def test_evaluator_loads_pth(gate_pth):
    path, state, env = gate_pth
    ev = Evaluator(_gate_config(), device="cpu", verbose=False)
    assert ev.load(path) == {}
    _assert_params_equal(ev.gauss, state)
    assert (ev.step, ev.n_active) == (4, int(state.n_active))
    assert torch.equal(ev.env.texture, torch.as_tensor(env))
    color, _, alpha = ev.render_view(ev.scene.test_cameras[0])
    assert color.shape == (48, 48, 3) and torch.isfinite(color).all()
    # Without an env map in the config, the texture is not taken.
    cfg = _gate_config()
    cfg.pipeline.env_map_res = 0
    ev = Evaluator(cfg, device="cpu", verbose=False)
    ev.load(path)
    assert ev.env is None


def test_render_cli_export_pth(gate_pth, tmp_path):
    import yaml

    path, state, env = gate_pth
    cfg = dict(gaussian_dim=4, time_duration=[0.0, 1.0], rot_4d=True,
               num_pts=300,
               ModelParams=dict(source_path=SYNTH_GATE, resolution=2,
                                eval=True, white_background=True),
               PipelineParams=dict(eval_shfs_4d=True, env_map_res=8))
    with open(tmp_path / "cfg.yaml", "w") as f:
        yaml.safe_dump(cfg, f)
    out = tmp_path / "x.pth"
    assert render_cli.main(
        ["--config", str(tmp_path / "cfg.yaml"), "--checkpoint", path,
         "--device", "cpu", "--max_views", "1", "--out",
         str(tmp_path / "r"), "--export_pth", str(out)]) == 0
    back, meta = jax_import.import_reference_pth(str(out))
    n = int(state.n_active)
    for f in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(back.params, f))[:n],
                                      getattr(state.params, f).numpy(),
                                      err_msg=f)
    assert meta["iteration"] == 4 and meta["rot_4d"] is True
    np.testing.assert_array_equal(meta["env_map"], env)
    scene_radius = Evaluator(_gate_config(), device="cpu",
                             verbose=False).scene.radius
    assert meta["spatial_lr_scale"] == pytest.approx(scene_radius)
