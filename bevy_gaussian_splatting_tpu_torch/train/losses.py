"""Training losses: the standard 3DGS photometric objective, and 2DGS's
geometric regularisers.

The counterpart of the JAX package's ``train/losses.py``:
``loss = (1 - lambda) * L1 + lambda * (1 - SSIM)`` with lambda = 0.2 and an
11x11, sigma 1.5 Gaussian SSIM window.  Images are [..., H, W, C], as there.
The window is separable, so each of SSIM's five filtered maps is two
depthwise 1-D convolutions (``conv2d``, zero padding: 'same' size), the
JAX package's ``lax.conv_general_dilated`` pair.  ``mse`` is the bench
objective, ``mean((img - target)^2)`` (bench.py).

2DGS is trained as Huang et al. train it (SIGGRAPH 2024, section 4.2, and
the official ``2d-gaussian-splatting`` trainer): L_c + alpha L_d + beta L_n,
the photometric loss plus the depth distortion and the normal consistency,
from the surface maps that ``render_tiled(..., aux_near=...)`` composites
(:class:`SurfaceLoss`; the JAX package has no such terms).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F

from bevy_gaussian_splatting_tpu_torch.utils.trace import span

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


def depth_points(depth: torch.Tensor, clip_from_view: torch.Tensor) -> torch.Tensor:
    """View-space points [H, W, 3] at ``depth`` [H, W] (the clip w, -z in
    view space) along each pixel centre's ray of a perspective projection
    ``clip_from_view`` (clip w = -view z): x = (x_ndc + P02) d / P00, y =
    (y_ndc + P12) d / P11, z = -d."""
    h, w = depth.shape
    dev = depth.device
    x = (torch.arange(w, device=dev, dtype=torch.float32) + 0.5) * (2.0 / w) - 1.0
    y = 1.0 - (torch.arange(h, device=dev, dtype=torch.float32) + 0.5) * (2.0 / h)
    p = clip_from_view
    rx = (x + p[0, 2]) / p[0, 0]
    ry = (y + p[1, 2]) / p[1, 1]
    return torch.stack([rx[None, :] * depth, ry[:, None] * depth, -depth], dim=-1)


def depth_normal(points: torch.Tensor) -> torch.Tensor:
    """The normal map of a grid of points [H, W, 3]: the normalised cross
    product of the central differences down the rows and along the columns
    (facing the camera), zero on the one-pixel border (the official
    trainer's ``depth_to_normal``)."""
    dr = points[2:, 1:-1] - points[:-2, 1:-1]
    dc = points[1:-1, 2:] - points[1:-1, :-2]
    out = torch.zeros_like(points)
    out[1:-1, 1:-1] = F.normalize(torch.linalg.cross(dr, dc, dim=-1), dim=-1)
    return out


def surfel_geometry_terms(aux: dict, camera, depth_ratio: float = 1.0, near: float = 0.2, far: float = 100.0):
    """(L_d, L_n), 2DGS's depth distortion and normal consistency, from the
    surface maps ``aux`` rendered through ``camera``.

    L_d is the mean over pixels of the depth distortion sum_{j<i} w_i w_j
    (m_i - m_j)^2 with m = far / (far - near) (1 - near / z), the official
    rasteriser's mapped depth: the maps hold the distortion of 1 / z, and
    m_i - m_j = near far / (far - near) (1/z_j - 1/z_i), so L_d is that
    distortion's mean times (near far / (far - near))^2.  L_n is the mean
    over pixels of 1 - N . N_d: N the rendered normal (view space), N_d the
    normal of the surface depth (1 - depth_ratio) D / alpha + depth_ratio
    median (:func:`depth_points`, :func:`depth_normal`) times the detached
    alpha, as the official trainer forms it.  Under the span
    ``gs.loss.geometry``."""
    with span("gs.loss.geometry"):
        alpha = aux["alpha"]
        expected = torch.where(alpha > 0.0, aux["depth"] / torch.where(alpha > 0.0, alpha, 1.0), 0.0)
        surface = (1.0 - depth_ratio) * expected + depth_ratio * aux["median"]
        normal = depth_normal(depth_points(surface, camera.clip_from_view)) * alpha.detach()[..., None]
        normal_loss = torch.mean(1.0 - torch.sum(aux["normal"] * normal, dim=-1))
        scale = (near * far / (far - near)) ** 2
        dist_loss = scale * torch.mean(aux["distortion"])
        return dist_loss, normal_loss


@dataclasses.dataclass(frozen=True)
class SurfaceLoss:
    """The geometric half of 2DGS's objective, for ``train_step``'s
    ``surface_loss``: ``lambda_dist L_d + lambda_normal L_n`` of
    :func:`surfel_geometry_terms`, from the surface maps of
    ``render_tiled(..., aux_near=near)`` rendered through the camera.  The
    defaults are the paper's bounded-scene weights (alpha 1000, beta 0.05)
    and the official rasteriser's near and far (0.2, 100), with the median
    depth as the surface (``depth_ratio`` 1, the official DTU runs')."""

    lambda_dist: float = 1000.0
    lambda_normal: float = 0.05
    depth_ratio: float = 1.0
    near: float = 0.2
    far: float = 100.0

    def __call__(self, aux: dict, camera) -> torch.Tensor:
        dist_loss, normal_loss = surfel_geometry_terms(aux, camera, self.depth_ratio, self.near, self.far)
        return self.lambda_dist * dist_loss + self.lambda_normal * normal_loss
