"""Reference (oracle) rasterizer: exact, slow, plain PyTorch.

The counterpart of the JAX package's ``ops/rasterize_ref.py`` for 3DGS with
OBB or AABB bounds, 2DGS surfels and 4DGS: back-to-front painter blending over
depth-sorted gaussians with premultiplied alpha, dst factor (1 - a)
(src/render/mod.rs:914-982), OBB falloff power = -4.5 |uv|^2 in the
eigen-rotated quad frame (src/render/gaussian.wgsl:489-497), the AABB conic
falloff clipped to the radius square (:455-470) or the surfel's
min(3D ray-plane, 2x 2D) power (src/render/gaussian_2d.wgsl:134-156), alpha
cap 0.999 (:499-505), and the bounding-box overlay (:486-495).  It defines
correctness for the tiled renderer.  Its cost is O(N * H * W): small N only.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from bevy_gaussian_splatting_tpu_torch.models.camera import Camera
from bevy_gaussian_splatting_tpu_torch.models.settings import CloudSettings, SortMode
from bevy_gaussian_splatting_tpu_torch.ops import sort as sort_ops
from bevy_gaussian_splatting_tpu_torch.ops.cuda.tile_fwd import BBOX_GREEN, EDGE_BAND
from bevy_gaussian_splatting_tpu_torch.ops.gaussian_2d import surfel_affine_coeffs, surfel_affine_power
from bevy_gaussian_splatting_tpu_torch.ops.project import as_float32, project_gaussians
from bevy_gaussian_splatting_tpu_torch.ops.transforms import apply_transform

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
    single-reciprocal form every evaluator of the JAX package shares ->
    (g, edge): the edge band is where max(|u|, |v|) passes EDGE_BAND inside
    the quad (gaussian.wgsl:486-495)."""
    dx = px_vp - cx
    dy = py_vp - cy
    e2x, e2y = e1[1], -e1[0]  # eigvec2 = (e1.y, -e1.x)
    inv1 = 1.0 / torch.clamp(bounds[0], min=1e-12)
    inv2 = 1.0 / torch.clamp(bounds[1], min=1e-12)
    u = (dx * e1[0] + dy * e1[1]) * inv1
    v = (dx * e2x + dy * e2y) * inv2
    inside = (u.abs() <= 1.0) & (v.abs() <= 1.0) & (bounds[0] > 0.0)
    power = -4.5 * (u * u + v * v)
    edge = inside & (torch.maximum(u.abs(), v.abs()) > EDGE_BAND)
    return torch.where(inside, torch.exp(power), torch.zeros_like(power)), edge


def _fragment_alpha_3d_aabb(cx, cy, conic, radius, px_vp, py_vp):
    """AABB conic falloff clipped to the radius square (gaussian.wgsl:455-470;
    rasterize_ref.py:48-69 of the JAX package) -> (g, edge); the edge band
    is measured in the square, whatever the falloff there."""
    dx = cx - px_vp
    dy = cy - py_vp
    power = -0.5 * (conic[0] * dx * dx + conic[2] * dy * dy) + conic[1] * dx * dy
    in_quad = (dx.abs() <= radius) & (dy.abs() <= radius)
    inside = in_quad & (power <= 0.0)
    edge = in_quad & (torch.maximum(dx.abs(), dy.abs()) / torch.clamp(radius, min=1e-12) > EDGE_BAND)
    return torch.where(inside, torch.exp(power), torch.zeros_like(power)), edge


def _fragment_alpha_2d(cx_ndc, cy_ndc, mr, A, B, C, px_ndc, py_ndc, width: int, height: int):
    """2DGS surfel falloff in the reference's fragment frame
    (rasterize_ref.py:92-129 of the JAX package): the folded affine form of
    the homography intersection, clipped to the surfel's square, whose
    half-sides are ``mr`` scaled by f32 1/width and 1/height -> (g, edge),
    the edge band measured in doubled pixels against ``mr``."""
    inv_w = np.float32(1.0) / np.float32(width)
    inv_h = np.float32(1.0) / np.float32(height)
    dx_ndc = px_ndc - cx_ndc
    dy_ndc = py_ndc - cy_ndc
    inside = (dx_ndc.abs() <= mr * float(inv_w)) & (dy_ndc.abs() <= mr * float(inv_h))
    power = surfel_affine_power(A, B, C, dx_ndc, dy_ndc, width)
    uv = torch.maximum(dx_ndc.abs() * float(width), dy_ndc.abs() * float(height)) / torch.clamp(mr, min=1e-12)
    edge = inside & (uv > EDGE_BAND)
    return torch.where(inside, torch.exp(power), torch.zeros_like(power)), edge


def composite_splats(
    splats: dict,
    order: torch.Tensor,
    width: int,
    height: int,
    background: Optional[torch.Tensor] = None,
    bbox: bool = False,
) -> torch.Tensor:
    """Painter-blend splats over the image in ``order`` (back-to-front).
    Returns [H, W, 4] premultiplied linear RGBA.  Splats that carry
    ``surfel_t`` (a 2DGS projection) take the surfel falloff, those that
    carry ``radius_vp`` (an AABB projection) the AABB falloff.  ``bbox``
    draws the bounding-box overlay: opaque green edges of every splat in the
    mask, whatever its opacity (gaussian.wgsl:486-495)."""
    dev = splats["rgb"].device
    px_ndc, py_ndc = pixel_grid_ndc(width, height, dev)
    px_vp = px_ndc * float(width)
    py_vp = py_ndc * float(height)
    if background is None:
        background = torch.zeros((4,), dtype=torch.float32, device=dev)
    image = background.to(torch.float32).expand(height, width, 4).clone()
    green = torch.tensor(BBOX_GREEN, dtype=torch.float32, device=dev)

    center = splats["center_ndc"][order]
    if "surfel_t" in splats:
        mr = splats["surfel_radius"][order]
        A, B, C = surfel_affine_coeffs(splats["surfel_t"][order], splats["mean_2d"][order], width)

        def falloff(i):
            return _fragment_alpha_2d(center[i, 0], center[i, 1], mr[i], A[i], B[i], C[i],
                                      px_ndc, py_ndc, width, height)
    else:
        cx_all = center[:, 0] * float(width)
        cy_all = center[:, 1] * float(height)
        if "radius_vp" in splats:
            shape_a, shape_b = splats["conic"][order], splats["radius_vp"][order]
            falloff_3d = _fragment_alpha_3d_aabb
        else:
            shape_a, shape_b = splats["obb_axis"][order], splats["obb_bounds"][order]
            falloff_3d = _fragment_alpha_3d_obb

        def falloff(i):
            return falloff_3d(cx_all[i], cy_all[i], shape_a[i], shape_b[i], px_vp, py_vp)
    rgb = splats["rgb"][order]
    alpha_s = splats["alpha"][order]
    mask = splats["mask"][order]
    for i in range(order.shape[0]):
        g, edge = falloff(i)
        alpha = torch.clamp(g * alpha_s[i], max=ALPHA_CAP)
        alpha = torch.where(mask[i], alpha, torch.zeros_like(alpha))
        src_rgb = rgb[i][None, None, :] * alpha[..., None]
        if bbox:
            # the edge is gated by the mask, not by the opacity: a splat of
            # opacity 0 gets a box here and none from the tiled renderer
            edge = edge & mask[i]
            alpha = torch.where(edge, torch.ones_like(alpha), alpha)
            src_rgb = torch.where(edge[..., None], green, src_rgb)
        src = torch.cat([src_rgb, alpha[..., None]], dim=-1)
        image = src + image * (1.0 - alpha[..., None])
    return image


def render_oracle(
    cloud,
    camera: Camera,
    settings: CloudSettings,
    model_transform: Optional[torch.Tensor] = None,
    background: Optional[torch.Tensor] = None,
    time=None,
) -> torch.Tensor:
    """Full oracle render: sort + project + composite -> [H, W, 4] linear RGBA
    at ``time`` (4DGS; default ``settings.time``).

    RADIX and NONE sort by the radix key and cull its sentinels; STD and
    RAYON take the host sort's order and cull nothing.  The DEPTH ramp's
    (min, max) are the camera distances of sorted entries ``n - 1`` and
    ``min(1, n - 1)``, the reference's quirk (gaussian.wgsl:329-347).  The
    sort and the ramp read the stored positions, also in 4DGS, as in the
    reference (rasterize_ref.py:217-246)."""
    cloud = as_float32(cloud)
    dev = cloud.device
    if model_transform is None:
        model_transform = torch.eye(4, dtype=torch.float32, device=dev)
    if settings.sort_mode in (SortMode.RADIX, SortMode.NONE):
        back_key = sort_ops.radix_depth_key(
            cloud.position, model_transform, camera.clip_from_world, camera.world_position,
            settings.radix_sort_depth_bits.bits,
        )
        _, order = sort_ops.sort_entries(back_key)
        sentinel_mask = back_key != sort_ops.SENTINEL_KEY
    else:
        order = torch.from_numpy(sort_ops.sort_gaussians_host(
            cloud.position.detach().cpu().numpy(), model_transform.cpu().numpy(),
            camera.world_position.cpu().numpy(),
        ).astype(np.int64)).to(dev)
        sentinel_mask = torch.ones(len(cloud), dtype=torch.bool, device=dev)
    n = len(cloud)
    wp = apply_transform(model_transform, cloud.position)
    max_d = torch.linalg.norm(wp[order[min(1, n - 1)]] - camera.world_position)
    min_d = torch.linalg.norm(wp[order[n - 1]] - camera.world_position)
    splats = project_gaussians(cloud, camera, settings, model_transform, depth_minmax=(min_d, max_d), time=time)
    splats["mask"] = splats["mask"] & sentinel_mask
    return composite_splats(splats, order, camera.width, camera.height, background,
                            bbox=settings.visualize_bounding_box)
