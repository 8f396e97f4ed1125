"""Reference (oracle) rasterizer: exact, slow, plain PyTorch.

The counterpart of the JAX package's ``ops/rasterize_ref.py`` for 3DGS / OBB
/ COLOR: back-to-front painter blending over depth-sorted gaussians with
premultiplied alpha, dst factor (1 - a) (src/render/mod.rs:914-982), OBB
falloff power = -4.5 |uv|^2 in the eigen-rotated quad frame
(src/render/gaussian.wgsl:489-497), alpha cap 0.999 (:499-505).  It defines
correctness for the tiled renderer.  Its cost is O(N * H * W): small N only.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from bevy_gaussian_splatting_tpu_torch.models.camera import Camera
from bevy_gaussian_splatting_tpu_torch.models.settings import CloudSettings
from bevy_gaussian_splatting_tpu_torch.ops import sort as sort_ops
from bevy_gaussian_splatting_tpu_torch.ops.project import project_gaussians

ALPHA_CAP = 0.999  # gaussian.wgsl:499


def pixel_grid_ndc(width: int, height: int, device=None):
    """NDC coordinates of pixel centers: x right, y up (row 0 = top).

    ``(i + 0.5) * (2 / width) - 1`` with the multiply-add fused, as the
    tiled compositor computes it (ops/cuda/tile_fwd.py): the float64
    product and sum are exact, so one rounding to float32 is the fused
    result."""
    c_w = float(np.float32(2.0 / width))
    c_h = float(np.float32(2.0 / height))
    i = torch.arange(width, dtype=torch.float64, device=device) + 0.5
    j = torch.arange(height, dtype=torch.float64, device=device) + 0.5
    xs = (i * c_w - 1.0).float()
    ys = (1.0 - j * c_h).float()
    py, px = torch.meshgrid(ys, xs, indexing="ij")
    return px, py  # each [H, W]


def _fragment_alpha_3d_obb(cx, cy, e1, bounds, px_vp, py_vp):
    """OBB quad falloff (gaussian.wgsl:489-497; helpers.wgsl:88-120), in the
    single-reciprocal form every evaluator of the JAX package shares."""
    dx = px_vp - cx
    dy = py_vp - cy
    e2x, e2y = e1[1], -e1[0]  # eigvec2 = (e1.y, -e1.x)
    inv1 = 1.0 / torch.clamp(bounds[0], min=1e-12)
    inv2 = 1.0 / torch.clamp(bounds[1], min=1e-12)
    u = (dx * e1[0] + dy * e1[1]) * inv1
    v = (dx * e2x + dy * e2y) * inv2
    inside = (u.abs() <= 1.0) & (v.abs() <= 1.0) & (bounds[0] > 0.0)
    power = -4.5 * (u * u + v * v)
    return torch.where(inside, torch.exp(power), torch.zeros_like(power))


def composite_splats(
    splats: dict,
    order: torch.Tensor,
    width: int,
    height: int,
    background: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Painter-blend splats over the image in ``order`` (back-to-front).
    Returns [H, W, 4] premultiplied linear RGBA."""
    dev = splats["rgb"].device
    px_ndc, py_ndc = pixel_grid_ndc(width, height, dev)
    px_vp = px_ndc * float(width)
    py_vp = py_ndc * float(height)
    if background is None:
        background = torch.zeros((4,), dtype=torch.float32, device=dev)
    image = background.to(torch.float32).expand(height, width, 4).clone()

    center = splats["center_ndc"][order]
    cx_all = center[:, 0] * float(width)
    cy_all = center[:, 1] * float(height)
    axis = splats["obb_axis"][order]
    bounds = splats["obb_bounds"][order]
    rgb = splats["rgb"][order]
    alpha_s = splats["alpha"][order]
    mask = splats["mask"][order]
    for i in range(order.shape[0]):
        g = _fragment_alpha_3d_obb(cx_all[i], cy_all[i], axis[i], bounds[i], px_vp, py_vp)
        alpha = torch.clamp(g * alpha_s[i], max=ALPHA_CAP)
        alpha = torch.where(mask[i], alpha, torch.zeros_like(alpha))
        src_rgb = rgb[i][None, None, :] * alpha[..., None]
        src = torch.cat([src_rgb, alpha[..., None]], dim=-1)
        image = src + image * (1.0 - alpha[..., None])
    return image


def render_oracle(
    cloud,
    camera: Camera,
    settings: CloudSettings,
    model_transform: Optional[torch.Tensor] = None,
    background: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Full oracle render: sort + project + composite -> [H, W, 4] linear RGBA."""
    splats = project_gaussians(cloud, camera, settings, model_transform)
    back_key = splats["sort_key"]
    _, order = sort_ops.sort_entries(back_key)
    splats["mask"] = splats["mask"] & (back_key != sort_ops.SENTINEL_KEY)
    return composite_splats(splats, order, camera.width, camera.height, background)
