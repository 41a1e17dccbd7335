"""fourdgs_tpu_torch — the PyTorch/CUDA port of fourdgs_tpu for NVIDIA
Hopper (H100).

Same module layout and public names as the JAX package `fourdgs_tpu`,
which stays the reference it is tested against. This package imports
neither JAX nor `fourdgs_tpu`.

  ops/       4D gaussian math, spherindrical SH, preprocess, tile binning,
             the forward and backward tile blends (CUDA kernels in csrc/ +
             plain PyTorch), k nearest neighbours.
  models/    the gaussian parameter set as an nn.Module, the training
             state, learning rates, Adam, densification statistics.
  data/      camera math.
  engine/    reading checkpoints written by the JAX package; the train
             step.
  utils/     image losses.
  render.py  render() (differentiable) and the serving module
             GaussianRenderer.
  cuda_build.py  nvcc build + ctypes loading of csrc/ kernels.

Entry points run on "cuda" unless the caller passes device="cpu".
"""

from .ops.preprocess import CameraArrays, RenderOptions    # noqa: F401
from .render import GaussianRenderer, RenderOutputs, render  # noqa: F401
