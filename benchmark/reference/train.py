"""The plain reference of a training step: the image (``splat.py``), the
3DGS photometric loss, its gradients by autograd, and Adam.

The loss is 3DGS's (Kerbl et al., SIGGRAPH 2023): 0.8 L1 + 0.2 (1 - SSIM)
over the rgb channels, SSIM with an 11x11 Gaussian window of sigma 1.5 and
zero padding, C1 = 0.01^2, C2 = 0.03^2.  Adam is ``optax.adam``'s update:
betas (0.9, 0.999), eps 1e-8 added to the bias-corrected root.

The image's gradient reaches the splats tile batch by tile batch: the image
is composited once without a graph, the loss's gradient taken at it, and
each batch of tiles composited again under autograd and back-propagated
with its share of that gradient, so that 1M gaussians fit.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import splat

SSIM_C1 = 0.01**2
SSIM_C2 = 0.03**2
BETA1, BETA2, EPS = 0.9, 0.999, 1e-8


def _window(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    w = np.exp(-(x**2) / (2.0 * sigma**2))
    return (w / w.sum()).astype(np.float32)


def _blur(img: torch.Tensor) -> torch.Tensor:
    """Separable 'same' Gaussian blur of [H, W, C] along H and W."""
    win = _window()
    h, w, c = img.shape
    x = img.permute(2, 0, 1).reshape(c, 1, h, w)
    k = torch.from_numpy(win).to(device=img.device, dtype=img.dtype)
    x = F.conv2d(x, k.reshape(1, 1, 11, 1), padding=(5, 0))
    x = F.conv2d(x, k.reshape(1, 1, 1, 11), padding=(0, 5))
    return x.reshape(c, h, w).permute(1, 2, 0)


def ssim(img: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    mu_x, mu_y = _blur(img), _blur(target)
    mu_x2, mu_y2, mu_xy = mu_x * mu_x, mu_y * mu_y, mu_x * mu_y
    sigma_x2 = _blur(img * img) - mu_x2
    sigma_y2 = _blur(target * target) - mu_y2
    sigma_xy = _blur(img * target) - mu_xy
    num = (2.0 * mu_xy + SSIM_C1) * (2.0 * sigma_xy + SSIM_C2)
    den = (mu_x2 + mu_y2 + SSIM_C1) * (sigma_x2 + sigma_y2 + SSIM_C2)
    return torch.mean(num / den)


def splatting_loss(img: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """0.8 L1 + 0.2 (1 - SSIM) over the rgb channels of [H, W, 4] images."""
    img, target = img[..., :3], target[..., :3]
    return 0.8 * torch.mean(torch.abs(img - target)) + 0.2 * (1.0 - ssim(img, target))


def loss_and_grads(fields: dict, cam: dict, target: torch.Tensor, time=None, chunk: int = 512,
                   dtype=torch.float32, batch: int = 64, loss_fn=None):
    """The loss of rendering ``fields`` through ``cam`` against ``target``
    and its gradient in every field -> (loss float, {field: grad}, [N] bool
    of the splats whose OBB axis is well-conditioned, ``splat.well_conditioned``).
    ``loss_fn`` replaces :func:`splatting_loss` (a planted fault)."""
    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in fields.items()}
    width, height = cam["width"], cam["height"]
    splats = splat.project(leaves, cam, time, dtype)
    bins = splat.bin_pairs({k: v for k, v in splats.items() if k != "params"}, width, height)
    params = splats["params"]
    p_det = params.detach().requires_grad_(True)
    with torch.no_grad():
        img = splat.render_bins(p_det, bins, width, height, chunk)
    img_leaf = img.detach().requires_grad_(True)
    loss = (loss_fn or splatting_loss)(img_leaf, target.to(dtype))
    loss.backward()
    d_tiles = splat.image_to_tiles(img_leaf.grad, bins["tx_count"], bins["ty_count"])  # [T, 4, 256]
    num_tiles = d_tiles.shape[0]
    for b0 in range(0, num_tiles, batch):
        tids = torch.arange(b0, min(b0 + batch, num_tiles), device=params.device)
        accum, trans = splat.composite_tiles(p_det, bins, width, height, chunk, tids)
        d = d_tiles[tids]
        # image rgb = accum, image alpha = 1 - trans (zero background)
        part = torch.sum(accum * d[:, :3]) - torch.sum(trans * d[:, 3])
        if part.requires_grad:
            part.backward()
    if p_det.grad is not None:
        params.backward(p_det.grad)
    grads = {k: (v.grad if v.grad is not None else torch.zeros_like(v)).float() for k, v in leaves.items()}
    return float(loss.detach()), grads, splats["axis_conditioned"]


class Adam:
    """``optax.adam``'s update on a dict of float32 tensors."""

    def __init__(self, fields: dict, lr: float):
        self.lr = lr
        self.t = 0
        self.m = {k: torch.zeros_like(v) for k, v in fields.items()}
        self.v = {k: torch.zeros_like(v) for k, v in fields.items()}

    def step(self, fields: dict, grads: dict) -> dict:
        self.t += 1
        c1, c2 = 1.0 - BETA1**self.t, 1.0 - BETA2**self.t
        out = {}
        for k, p in fields.items():
            g = grads[k].to(p.dtype)
            self.m[k] = BETA1 * self.m[k] + (1.0 - BETA1) * g
            self.v[k] = BETA2 * self.v[k] + (1.0 - BETA2) * g * g
            out[k] = p - self.lr * (self.m[k] / c1) / (torch.sqrt(self.v[k] / c2) + EPS)
        return out
