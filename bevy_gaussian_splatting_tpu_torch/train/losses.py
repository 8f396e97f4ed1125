"""Training losses: the standard 3DGS photometric objective.

The counterpart of the JAX package's ``train/losses.py``:
``loss = (1 - lambda) * L1 + lambda * (1 - SSIM)`` with lambda = 0.2 and an
11x11, sigma 1.5 Gaussian SSIM window.  Images are [..., H, W, C], as there.
The window is separable, so each of SSIM's five filtered maps is two
depthwise 1-D convolutions (``conv2d``, zero padding: 'same' size), the
JAX package's ``lax.conv_general_dilated`` pair.  ``mse`` is the bench
objective, ``mean((img - target)^2)`` (bench.py).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

SSIM_C1 = 0.01**2  # (k1 * L)^2 with L = 1.0 dynamic range
SSIM_C2 = 0.03**2


@functools.lru_cache(maxsize=8)
def _gaussian_window(size: int, sigma: float) -> np.ndarray:
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    w = np.exp(-(x**2) / (2.0 * sigma**2))
    w /= w.sum()
    return w.astype(np.float32)


def _blur(img: torch.Tensor, window: np.ndarray) -> torch.Tensor:
    """Separable 'same' Gaussian blur of [..., H, W, C] along H and W."""
    size = window.shape[0]
    *lead, h, w, c = img.shape
    x = img.reshape(-1, h, w, c).permute(0, 3, 1, 2).reshape(-1, 1, h, w)
    k = torch.from_numpy(window).to(device=img.device, dtype=img.dtype)
    pad = (size - 1) // 2
    x = F.conv2d(x, k.reshape(1, 1, size, 1), padding=(pad, 0))
    x = F.conv2d(x, k.reshape(1, 1, 1, size), padding=(0, pad))
    x = x.reshape(-1, c, h, w).permute(0, 2, 3, 1)
    return x.reshape(*lead, h, w, c)


def ssim(img: torch.Tensor, target: torch.Tensor, window_size: int = 11, sigma: float = 1.5) -> torch.Tensor:
    """Mean SSIM over [..., H, W, C] images in [0, 1] (scalar)."""
    w = _gaussian_window(window_size, sigma)
    mu_x = _blur(img, w)
    mu_y = _blur(target, w)
    mu_x2 = mu_x * mu_x
    mu_y2 = mu_y * mu_y
    mu_xy = mu_x * mu_y
    sigma_x2 = _blur(img * img, w) - mu_x2
    sigma_y2 = _blur(target * target, w) - mu_y2
    sigma_xy = _blur(img * target, w) - mu_xy
    num = (2.0 * mu_xy + SSIM_C1) * (2.0 * sigma_xy + SSIM_C2)
    den = (mu_x2 + mu_y2 + SSIM_C1) * (sigma_x2 + sigma_y2 + SSIM_C2)
    return torch.mean(num / den)


def l1(img: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(img - target))


def mse(img: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean((img - target) ** 2)


def gaussian_splatting_loss(
    img: torch.Tensor,
    target: torch.Tensor,
    ssim_weight: float = 0.2,
    rgb_only: bool = True,
) -> torch.Tensor:
    """(1 - w) L1 + w (1 - SSIM); ``rgb_only`` drops the alpha channel of
    RGBA renders (supervision on colour, alpha driven indirectly)."""
    if rgb_only and img.shape[-1] == 4:
        img = img[..., :3]
        target = target[..., :3]
    return (1.0 - ssim_weight) * l1(img, target) + ssim_weight * (1.0 - ssim(img, target))
