"""The port's config loader against the JAX package's: every YAML of
configs/ loads to equal dataclass fields in both, unknown keys raise the
same KeyError, dotted overrides apply alike. Tolerance: none (equality)."""

import dataclasses
import glob
import os

import pytest

from fourdgs_tpu import config as jax_config
from fourdgs_tpu_torch import config as port_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAMLS = sorted(os.path.relpath(p, ROOT) for p in glob.glob(
    os.path.join(ROOT, "configs", "**", "*.yaml"), recursive=True))


def test_configs_exist():
    assert len(YAMLS) >= 17


@pytest.mark.parametrize("path", YAMLS)
def test_yaml_loads_equal_in_both_packages(path):
    port = port_config.load_config(os.path.join(ROOT, path))
    ref = jax_config.load_config(os.path.join(ROOT, path))
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port_config.sh_degree_t(port) == jax_config.sh_degree_t(ref)
    assert isinstance(port.time_duration, tuple)


def test_defaults_and_field_names_equal():
    assert (dataclasses.asdict(port_config.TrainConfig())
            == dataclasses.asdict(jax_config.TrainConfig()))
    for name in ("ModelConfig", "PipelineConfig", "OptimizationConfig",
                 "TrainConfig"):
        assert ([f.name for f in dataclasses.fields(getattr(port_config,
                                                            name))]
                == [f.name for f in dataclasses.fields(getattr(jax_config,
                                                               name))])


@pytest.mark.parametrize("overrides", [
    {"nonsense": 1}, {"model": {"nonsense": 1}},
    {"optimization": {"lambda_nope": 0.5}}])
def test_unknown_key_raises_the_same_keyerror(overrides):
    with pytest.raises(KeyError) as ref:
        jax_config.load_config(None, overrides=overrides)
    with pytest.raises(KeyError) as port:
        port_config.load_config(None, overrides=overrides)
    assert str(port.value) == str(ref.value)
    assert "unknown config key" in str(port.value)


def test_unknown_yaml_key_raises(tmp_path):
    path = tmp_path / "bad.yaml"
    path.write_text("ModelParams:\n  sh_degree: 2\n  bogus: 3\n")
    with pytest.raises(KeyError, match="unknown config key model.bogus"):
        port_config.load_config(str(path))


def test_overrides_and_coercion_equal(tmp_path):
    path = tmp_path / "c.yaml"
    path.write_text(
        "gaussian_dim: 4\ntime_duration: [0.0, 2.0]\n"
        "OptimizationParams:\n  densify_grad_t_threshold: 0.0002 / 40\n"
        "  iterations: 7.0\nPipelineParams:\n  env_map_res: 500\n")
    overrides = {"optimization": {"lambda_motion": "0.5", "lambda_rigid": 1},
                 "model": {"white_background": 1, "resolution": 2},
                 "rot_4d": True, "seed": 3}
    port = port_config.load_config(str(path), overrides=overrides)
    ref = jax_config.load_config(str(path), overrides=overrides)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.optimization.densify_grad_t_threshold == 0.0002 / 40
    assert port.optimization.iterations == 7
    assert port.optimization.lambda_motion == 0.5
    assert port.model.white_background is True
    assert port.pipeline.env_map_res == 500
