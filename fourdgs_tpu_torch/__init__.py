"""fourdgs_tpu_torch — the PyTorch/CUDA port of fourdgs_tpu for NVIDIA
Hopper (H100).

Same module layout and public names as the JAX package `fourdgs_tpu`,
which stays the reference it is tested against. This package imports
neither JAX nor `fourdgs_tpu`.

  ops/       4D gaussian math, spherindrical SH, preprocess, tile binning,
             the forward, backward and packed inference tile blends (CUDA
             kernels in csrc/ + plain PyTorch), k nearest neighbours.
  models/    the gaussian parameter set as an nn.Module, the training
             state, learning rates, Adam, densification statistics, the
             environment map, gaussian PLY import/export.
  data/      camera math, point clouds and PLY, COLMAP readers, scene
             loading (Blender-format and COLMAP datasets).
  engine/    checkpoints (this package's and the JAX package's), the
             train step, the Evaluator (renders and metrics of a
             checkpoint).
  utils/     image losses and metrics, small image/file utilities.
  config.py  the YAML/dataclass configuration.
  render.py  render() (differentiable; infer=True for the packed
             forward-only path) and the serving module GaussianRenderer.
  render_cli.py  checkpoint → PNGs + metrics.json, time sweeps, PLY
             export, the live viewer (python3 -m fourdgs_tpu_torch.render_cli).
  viewer.py  the SIBR viewer socket protocol.
  cuda_build.py  nvcc build + ctypes loading of csrc/ kernels.

Entry points run on "cuda" unless the caller passes device="cpu".
"""

from .ops.preprocess import CameraArrays, RenderOptions    # noqa: F401
from .render import GaussianRenderer, RenderOutputs, render  # noqa: F401
