"""LPIPS perceptual metric: AlexNet features → unit norm per channel →
linear-weighted squared differences → spatial mean, summed over layers.

PyTorch counterpart of `fourdgs_tpu/utils/lpips.py` (parity target: the
reference's `lpipsPyTorch/` module, never wired into train.py), in
`torch.nn.functional` convolutions over the same `.npz` weights: conv{i}_w
as HWIO kernels, conv{i}_b, lin{i}_w (C values) for i in 0..4. The
pretrained weights are not in the repo; convert them once with
`scripts/convert_lpips_weights.py` on a machine with the `lpips` package.
Until they are loaded, `lpips()` raises. Images are (H, W, 3) or
(B, H, W, 3) in [0, 1], as in the JAX package. On a CUDA device the
convolutions run in TF32 where `torch.backends.cudnn.allow_tf32` (True
by default) lets them.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

# AlexNet feature config: (out_channels, kernel, stride, padding) per conv,
# with maxpool(3, 2) after convs 0 and 1 (torchvision layout).
_ALEX_CONVS = [(64, 11, 4, 2), (192, 5, 1, 2), (384, 3, 1, 1),
               (256, 3, 1, 1), (256, 3, 1, 1)]
_POOL_AFTER = {0, 1}
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)

_WEIGHTS: Optional[Dict[str, np.ndarray]] = None


def load_weights(path: str) -> None:
    """Load converted LPIPS(alex) weights: conv{i}_w (HWIO), conv{i}_b,
    lin{i}_w for i in 0..4."""
    global _WEIGHTS
    data = np.load(path)
    _WEIGHTS = {k: np.asarray(data[k]) for k in data.files}


def weights_available(search: str = "") -> bool:
    """Whether weights are loaded, loading them from `search`,
    $FOURDGS_LPIPS_WEIGHTS or weights/lpips_alex.npz if one exists."""
    if _WEIGHTS is not None:
        return True
    for cand in (search, os.environ.get("FOURDGS_LPIPS_WEIGHTS", ""),
                 os.path.join(os.path.dirname(os.path.dirname(
                     os.path.dirname(os.path.abspath(__file__)))),
                     "weights", "lpips_alex.npz")):
        if cand and os.path.exists(cand):
            load_weights(cand)
            return True
    return False


def _alexnet_features(x: torch.Tensor, w, device):
    """x (B, 3, H, W), normalised; the 5 ReLU feature maps (B, C, h, w)."""
    feats = []
    h = x
    for i, (_, _, stride, pad) in enumerate(_ALEX_CONVS):
        kern = torch.as_tensor(w[f"conv{i}_w"], device=device).permute(
            3, 2, 0, 1)                                  # HWIO → OIHW
        bias = torch.as_tensor(w[f"conv{i}_b"], device=device)
        h = F.relu(F.conv2d(h, kern, bias, stride=stride, padding=pad))
        feats.append(h)
        if i in _POOL_AFTER:
            h = F.max_pool2d(h, 3, 2)
    return feats


def lpips(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """LPIPS(alex) distance between (H, W, 3) or (B, H, W, 3) images in
    [0, 1]: the mean over the batch. Requires converted weights (see the
    module docstring)."""
    if not weights_available():
        raise RuntimeError(
            "LPIPS weights not found. Convert them once with "
            "scripts/convert_lpips_weights.py (needs the `lpips` pip "
            "package elsewhere) and set FOURDGS_LPIPS_WEIGHTS or place "
            "them at weights/lpips_alex.npz.")
    w, device = _WEIGHTS, img1.device
    if img1.ndim == 3:
        img1, img2 = img1[None], img2[None]
    shift = torch.as_tensor(_SHIFT, device=device)
    scale = torch.as_tensor(_SCALE, device=device)

    def norm_input(x):
        return ((x * 2.0 - 1.0 - shift) / scale).permute(0, 3, 1, 2)

    total = 0.0
    for i, (a, b) in enumerate(zip(_alexnet_features(norm_input(img1), w,
                                                     device),
                                   _alexnet_features(norm_input(img2), w,
                                                     device))):
        a = a / torch.sqrt(torch.sum(a * a, 1, keepdim=True) + 1e-10)
        b = b / torch.sqrt(torch.sum(b * b, 1, keepdim=True) + 1e-10)
        lin = torch.as_tensor(w[f"lin{i}_w"], device=device).reshape(
            1, -1, 1, 1)
        total = total + torch.mean(torch.sum((a - b) ** 2 * lin, dim=1),
                                   dim=(1, 2))
    return torch.mean(total)
