"""Small image and file-system utilities.

PyTorch counterpart of `fourdgs_tpu/utils/image.py` (reference
`utils/image_utils.py`, `utils/system_utils.py`)."""

from __future__ import annotations

import os

import torch

from .losses import psnr  # noqa: F401  (reference image_utils.psnr)


def mse(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """Per-image MSE over a leading batch axis (`image_utils.py:14-15`)."""
    d = (img1 - img2) ** 2
    return d.reshape(d.shape[0], -1).mean(dim=1, keepdim=True)


def easy_cmap(x: torch.Tensor) -> torch.Tensor:
    """Min-max-normalised grayscale colormap: (H, W) -> (H, W, 3)
    (`image_utils.py:21-29`; channel-last here)."""
    lo, hi = torch.min(x), torch.max(x)
    n = torch.clamp((x - lo) / torch.clamp(hi - lo, min=1e-12), 0.0, 1.0)
    return torch.stack([n, n, n], dim=-1)


def mkdir_p(folder_path: str) -> None:
    os.makedirs(folder_path, exist_ok=True)


def search_for_max_iteration(folder: str, prefix: str = "") -> int:
    """Largest numeric suffix among checkpoint-like names in `folder`
    (`system_utils.py:24-26`: accepts both name_<N> and name<N>.ext).
    `prefix` restricts the candidates (e.g. "chkpnt")."""
    best = None
    for fname in os.listdir(folder):
        if prefix and not fname.startswith(prefix):
            continue
        stem = os.path.splitext(fname)[0]
        digits = ""
        for ch in reversed(stem):
            if ch.isdigit():
                digits = ch + digits
            else:
                break
        if digits:
            best = int(digits) if best is None else max(best, int(digits))
    if best is None:
        raise ValueError(f"no iteration-numbered entries in {folder}")
    return best
