"""Configuration system: dataclasses mirroring the reference's param groups
with identical keys and defaults, plus YAML overrides so the reference's
`configs/*/*.yaml` files run unmodified. PyTorch-port counterpart of
`fourdgs_tpu/config.py`, with the same fields and defaults, so that one
YAML loads to equal configs in both packages.

Precedence (reference `train.py:381-390`): dataclass defaults < CLI args <
YAML config (YAML applied last, every key must already exist). The
reference's `ParamGroup` reflection (`arguments/__init__.py:19-45`)
becomes plain dataclasses; the OmegaConf recursive merge becomes a dict
walk over pyyaml output.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple


@dataclasses.dataclass
class ModelConfig:
    """Reference ModelParams (`arguments/__init__.py:47-68`)."""
    sh_degree: int = 3
    source_path: str = ""
    model_path: str = ""
    images: str = "images"
    resolution: int = -1
    white_background: bool = False
    data_device: str = "tpu"    # the JAX package's default, kept so that
    #                             configs compare equal; accepted, unused
    eval: bool = False
    extension: str = ".png"
    num_extra_pts: int = 0
    loaded_pth: str = ""
    frame_ratio: int = 1
    dataloader: bool = False
    prefilter_var: float = -1.0


@dataclasses.dataclass
class PipelineConfig:
    """Reference PipelineParams (`arguments/__init__.py:70-79`)."""
    convert_SHs_python: bool = False
    compute_cov3D_python: bool = False
    debug: bool = False
    env_map_res: int = 0
    env_optimize_until: int = 1000000000
    env_optimize_from: int = 0
    eval_shfs_4d: bool = False


@dataclasses.dataclass
class OptimizationConfig:
    """Reference OptimizationParams (`arguments/__init__.py:81-108`)."""
    iterations: int = 30_000
    position_lr_init: float = 0.00016
    position_t_lr_init: float = -1.0
    position_lr_final: float = 0.0000016
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 30_000
    feature_lr: float = 0.0025
    opacity_lr: float = 0.05
    scaling_lr: float = 0.005
    rotation_lr: float = 0.001
    percent_dense: float = 0.01
    lambda_dssim: float = 0.2
    thresh_opa_prune: float = 0.005
    densification_interval: int = 100
    opacity_reset_interval: int = 3000
    densify_from_iter: int = 500
    densify_until_iter: int = 15_000
    densify_grad_threshold: float = 0.0002
    densify_grad_t_threshold: float = 0.0002 / 40
    densify_until_num_points: int = -1
    final_prune_from_iter: int = -1
    sh_increase_interval: int = 1000
    lambda_opa_mask: float = 0.0
    lambda_rigid: float = 0.0
    lambda_motion: float = 0.0


@dataclasses.dataclass
class TrainConfig:
    """Top-level trainer config: the YAML's bare keys (`train.py:368-376`)
    + the three groups + the JAX package's execution knobs."""
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    pipeline: PipelineConfig = dataclasses.field(default_factory=PipelineConfig)
    optimization: OptimizationConfig = dataclasses.field(
        default_factory=OptimizationConfig)

    gaussian_dim: int = 3
    time_duration: Tuple[float, float] = (-0.5, 0.5)
    num_pts: int = 100_000
    num_pts_ratio: float = 1.0
    rot_4d: bool = False
    force_sh_3d: bool = False
    batch_size: int = 1
    exhaust_test: bool = False
    seed: int = 6666
    test_iterations: List[int] = dataclasses.field(
        default_factory=lambda: [7000, 30000])
    save_iterations: List[int] = dataclasses.field(
        default_factory=lambda: [7000, 30000])
    checkpoint_iterations: List[int] = dataclasses.field(default_factory=list)
    start_checkpoint: Optional[str] = None
    debug_from: int = -1               # iteration from which pipeline.debug
    #                                    engages (reference train.py:361,
    #                                    `--debug_from`); -1 = never

    # Execution knobs of the JAX package (no reference analogue), kept so
    # that its YAMLs and overrides load. The port sizes its instance list
    # from the true count, so the two slack factors are accepted and
    # unused.
    capacity_slack: float = 1.3        # padded-cloud headroom
    instance_slack: float = 1.5        # tile-instance buffer headroom
    data_axis: int = 0                 # devices on the camera-batch axis
    strips: int = 1                    # horizontal strips per camera
    #                                    (multi-device; > 1 is not ported)
    eval_interval: int = 500           # used when exhaust_test
    gt_cache_mb: int = 4096            # device-resident GT cache budget


_GROUP_KEYS = {"ModelParams": "model", "PipelineParams": "pipeline",
               "OptimizationParams": "optimization"}


def _coerce(value, template):
    """YAML value -> the dataclass field's type; evals simple arithmetic
    strings (the reference YAMLs contain `0.0002 / 40`)."""
    if isinstance(value, str) and isinstance(template, (int, float)):
        value = eval(value, {"__builtins__": {}}, {})  # noqa: S307
    if isinstance(template, bool):
        return bool(value)
    if isinstance(template, int) and not isinstance(value, bool):
        return int(value)
    if isinstance(template, float):
        return float(value)
    if isinstance(template, tuple):
        return tuple(value)
    return value


def _apply(dc, updates: dict, path: str):
    for key, value in updates.items():
        if not hasattr(dc, key):
            raise KeyError(f"unknown config key {path}{key}")
        cur = getattr(dc, key)
        if dataclasses.is_dataclass(cur):
            _apply(cur, value, f"{path}{key}.")
        else:
            setattr(dc, key, _coerce(value, cur))


def apply_yaml(cfg: TrainConfig, yaml_path: str) -> None:
    """Merge a reference-layout YAML onto an existing config (the
    reference applies YAML LAST, over argparse+CLI — `train.py:381-390`)."""
    import yaml

    with open(yaml_path) as f:
        raw = yaml.safe_load(f) or {}
    for group, attr in _GROUP_KEYS.items():
        if group in raw:
            _apply(getattr(cfg, attr), raw.pop(group), f"{attr}.")
    _apply(cfg, raw, "")


def load_config(yaml_path: Optional[str] = None,
                overrides: Optional[dict] = None) -> TrainConfig:
    """Build a TrainConfig from defaults + a reference-layout YAML +
    programmatic overrides (applied last)."""
    cfg = TrainConfig()
    if yaml_path:
        apply_yaml(cfg, yaml_path)
    if overrides:
        _apply(cfg, overrides, "")
    # Reference post-processing (`train.py:368-377`): 4D SH degree.
    return cfg


def sh_degree_t(cfg: TrainConfig) -> int:
    """sh_degree_t = 2 iff eval_shfs_4d (`train.py:45`, passed to the
    model ctor)."""
    return 2 if cfg.pipeline.eval_shfs_4d else 0
