"""Rasterize-mode colour heads: the counterpart of the JAX package's
``ops/color.py``, transcribed from the reference material shaders:

  - depth ramp:        src/material/depth.wgsl:3-11
  - classification:    src/material/classification.wgsl:9-27
  - optical flow:      src/material/optical_flow.wgsl:16-56
"""

from __future__ import annotations

import torch

TAU = 6.283185307179586


def smoothstep(edge0, edge1, x: torch.Tensor) -> torch.Tensor:
    t = torch.clamp((x - edge0) / (edge1 - edge0), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def hsv_to_rgb(hsv: torch.Tensor) -> torch.Tensor:
    """Bevy's ``hsv_to_rgb`` (hue in radians [0, 2pi), s, v) -> rgb [..., 3].

    The sector is ``floor(h) mod 6`` with a floored modulo (``jnp.mod``), so
    h = 6 falls in sector 0; sector 5 is the default branch of the JAX
    package's ``jnp.select``."""
    h = hsv[..., 0] / TAU * 6.0
    s = hsv[..., 1]
    v = hsv[..., 2]
    c = v * s
    xcomp = c * (1.0 - torch.abs(torch.remainder(h, 2.0) - 1.0))
    m = v - c
    zeros = torch.zeros_like(c)
    sector = torch.remainder(torch.floor(h).to(torch.int32), 6)

    def select(values, default):
        out = default
        for k in reversed(range(5)):  # the first true condition wins
            out = torch.where(sector == k, values[k], out)
        return out

    r = select([c, xcomp, zeros, zeros, xcomp], c)
    g = select([xcomp, c, c, xcomp, zeros], zeros)
    b = select([zeros, zeros, xcomp, c, c], xcomp)
    return torch.stack([r + m, g + m, b + m], dim=-1)


def depth_to_rgb(depth: torch.Tensor, min_depth, max_depth) -> torch.Tensor:
    """Blue -> green -> red depth ramp (depth.wgsl:3-11)."""
    nd = torch.clamp((depth - min_depth) / (max_depth - min_depth), 0.0, 1.0)
    r = smoothstep(0.5, 1.0, nd)
    g = 1.0 - torch.abs(nd - 0.5) * 2.0
    b = 1.0 - smoothstep(0.0, 0.5, nd)
    return torch.stack([r, g, b], dim=-1)


def class_to_rgb(visualization: torch.Tensor, sh_color: torch.Tensor, num_classes: int) -> torch.Tensor:
    """Visibility >= 2 encodes a class index -> HSV hue mixed 50% with the SH
    colour (classification.wgsl:9-27)."""
    class_idx = visualization - 2.0
    hue = (class_idx / float(num_classes)) * TAU
    ones = torch.ones_like(hue)
    mixed = 0.5 * sh_color + 0.5 * hsv_to_rgb(torch.stack([hue, ones, ones], dim=-1))
    return torch.where((visualization < 2.0)[..., None], sh_color, mixed)


def calculate_motion_vector(
    world_position: torch.Tensor,
    previous_world_position: torch.Tensor,
    clip_from_world: torch.Tensor,
    prev_clip_from_world: torch.Tensor,
) -> torch.Tensor:
    """Screen-space motion vector in [-1, 1] UV units with y flipped
    (optical_flow.wgsl:16-40)."""

    def project(p, m):
        clip = p @ m[:3, :3].T + m[:3, 3]
        w = p @ m[3, :3] + m[3, 3]
        return clip[..., :2] / w[..., None]

    cur = project(world_position, clip_from_world)
    prev = project(previous_world_position, prev_clip_from_world)
    flip = torch.tensor([0.5, -0.5], dtype=cur.dtype, device=cur.device)
    return (cur - prev) * flip


def optical_flow_to_rgb(motion_vector: torch.Tensor, delta_time: float) -> torch.Tensor:
    """HSV colour wheel over flow = motion / delta_time (optical_flow.wgsl:42-56)."""
    flow = motion_vector / delta_time
    radius = torch.linalg.norm(flow, dim=-1)
    angle = torch.atan2(flow[..., 1], flow[..., 0])
    angle = torch.where(angle < 0.0, angle + TAU, angle)
    m = torch.clamp(radius, 0.0, 1.0)
    return hsv_to_rgb(torch.stack([angle, m, torch.ones_like(m)], dim=-1))
