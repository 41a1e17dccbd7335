"""Image losses of the training step: L1, windowed SSIM, PSNR, the
photometric loss and the sky-opacity loss.

PyTorch counterpart of `fourdgs_tpu/utils/losses.py` (its f32 path,
`fast=False`; the bf16 split there is a TPU device). Reference semantics
(`utils/loss_utils.py:24-64`): SSIM with an 11x11 gaussian window
(sigma 1.5) built as the outer product of a 1D kernel, zero "same"
padding, C1 = 0.01², C2 = 0.03². The blur is separable: two products with
banded (H, H) and (W, W) matrices, as in the JAX package.

Images are channel-last (H, W, C) or batched (B, H, W, C) float in [0, 1].
"""

from __future__ import annotations

import functools

import numpy as np
import torch

_C1 = 0.01 ** 2
_C2 = 0.03 ** 2


def l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(pred - target))


@functools.lru_cache(maxsize=16)
def _band_matrix(n: int, window_size: int, sigma: float) -> np.ndarray:
    """(n, n) banded matrix B with B[i, j] = g[j - i + pad]: B @ x is the
    1D 'same'-zero-padded gaussian blur along an n-length axis."""
    x = np.arange(window_size) - window_size // 2
    g = np.exp(-(x ** 2) / (2.0 * sigma ** 2))
    g = (g / g.sum()).astype(np.float32)
    pad = window_size // 2
    m = np.zeros((n, n), np.float32)
    idx = np.arange(n)
    for o in range(-pad, pad + 1):
        j = idx + o
        ok = (j >= 0) & (j < n)
        m[idx[ok], j[ok]] = g[o + pad]
    return m


def _blur(img: torch.Tensor, window_size: int, sigma: float) -> torch.Tensor:
    """Separable gaussian blur, zero 'same' padding. img: (B, H, W, C)."""
    _, h, w, _ = img.shape
    bh = torch.as_tensor(_band_matrix(h, window_size, sigma),
                         device=img.device)
    bw = torch.as_tensor(_band_matrix(w, window_size, sigma),
                         device=img.device)
    out = torch.einsum("hk,bkwc->bhwc", bh, img)
    return torch.einsum("wk,bhkc->bhwc", bw, out)


def _ensure_batched(img: torch.Tensor) -> torch.Tensor:
    return img[None] if img.dim() == 3 else img


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11,
         sigma: float = 1.5, size_average: bool = True) -> torch.Tensor:
    """Mean SSIM (reference `loss_utils.py:34-64` semantics)."""
    img1, img2 = _ensure_batched(img1), _ensure_batched(img2)
    mu1 = _blur(img1, window_size, sigma)
    mu2 = _blur(img2, window_size, sigma)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = _blur(img1 * img1, window_size, sigma) - mu1_sq
    sigma2_sq = _blur(img2 * img2, window_size, sigma) - mu2_sq
    sigma12 = _blur(img1 * img2, window_size, sigma) - mu1_mu2
    cs = (2 * sigma12 + _C2) / (sigma1_sq + sigma2_sq + _C2)
    m = ((2 * mu1_mu2 + _C1) / (mu1_sq + mu2_sq + _C1)) * cs
    if size_average:
        return torch.mean(m)
    return torch.mean(m, dim=(1, 2, 3))


def psnr(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Per-image PSNR, mean over the batch (`utils/image_utils.py:17-19`)."""
    pred, target = _ensure_batched(pred), _ensure_batched(target)
    mse = torch.mean((pred - target) ** 2, dim=(1, 2, 3))
    return torch.mean(20.0 * torch.log10(1.0 / torch.sqrt(mse)))


def photometric_loss(pred: torch.Tensor, target: torch.Tensor,
                     lambda_dssim: float = 0.2):
    """(1-λ)·L1 + λ·(1-SSIM) (`train.py:115-117`). Returns
    (loss, l1, 1-ssim)."""
    ll1 = l1_loss(pred, target)
    lssim = 1.0 - ssim(pred, target)
    return (1.0 - lambda_dssim) * ll1 + lambda_dssim * lssim, ll1, lssim


def opacity_mask_loss(alpha: torch.Tensor,
                      gt_alpha_mask: torch.Tensor) -> torch.Tensor:
    """Sky opacity BCE: mean over -sky·log(1-alpha), sky = 1-mask
    (`train.py:120-128`)."""
    o = torch.clamp(alpha, 1e-6, 1.0 - 1e-6)
    sky = 1.0 - gt_alpha_mask
    return torch.mean(-sky * torch.log(1.0 - o))
