"""World/clip transforms and frustum culling.

Reference: src/render/transform.wgsl:5-14.
"""

from __future__ import annotations

import torch


def world_to_clip(world_pos: torch.Tensor, clip_from_world: torch.Tensor) -> torch.Tensor:
    """Project world positions [..., 3] to NDC [..., 4] with the reference's
    w-division epsilon (src/render/transform.wgsl:5-8)."""
    hom = world_pos @ clip_from_world[:3, :3].T + clip_from_world[:3, 3]
    w = world_pos @ clip_from_world[3, :3] + clip_from_world[3, 3]
    full = torch.cat([hom, w[..., None]], dim=-1)
    return full / (w[..., None] + 1e-9)


def in_frustum(clip_pos: torch.Tensor) -> torch.Tensor:
    """Frustum test on NDC xyz [..., 3] -> bool [...]: |x|,|y| < 1.1 and z in
    (0, 1) (src/render/transform.wgsl:11-14)."""
    x, y, z = clip_pos[..., 0], clip_pos[..., 1], clip_pos[..., 2]
    return (x.abs() < 1.1) & (y.abs() < 1.1) & ((z - 0.5).abs() < 0.5)


def apply_transform(transform: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Apply a [4,4] model transform to positions [..., 3] (the reference's
    ``gaussian_uniforms.transform * position``)."""
    return pos @ transform[:3, :3].T + transform[:3, 3]
