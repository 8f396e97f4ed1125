"""Cloud interpolation (morph): lhs/rhs -> output lerp, the reference's
256-lane compute pass before each frame's sort (src/morph/interpolate.rs:32-477,
src/morph/interpolate.wgsl:52-119), as the JAX package's
``morph/interpolate.py`` computes it, on the clouds' device:

  - t = clamp((time - time_start) / duration, 0, 1); a degenerate duration
    (|d| < 1e-6) snaps to 0 or 1 by whether time reached time_stop
    (wgsl:52-58);
  - position, visibility, SH, scale and opacity: lerp (wgsl:85-118);
  - rotation: nlerp = normalize(mix(q_l, q_r, t)), a zero quaternion giving
    vec4(0, 0, 0, 1), the wgsl's w-last identity (wgsl:60-66).
"""

from __future__ import annotations

import numpy as np
import torch

from bevy_gaussian_splatting_tpu_torch.models.cloud import Gaussian3dCloud
from bevy_gaussian_splatting_tpu_torch.models.settings import CloudSettings


def interpolation_factor(time, time_start, time_stop) -> float:
    """interpolate.wgsl:52-58, in float32 (a Python float holding it)."""
    time = np.float32(time)
    duration = np.float32(time_stop - time_start)
    if abs(duration) < 1e-6:
        return 1.0 if time >= np.float32(time_stop) else 0.0
    return float(np.clip((time - np.float32(time_start)) / duration, np.float32(0.0), np.float32(1.0)))


def normalize_quaternion(q: torch.Tensor) -> torch.Tensor:
    """interpolate.wgsl:60-66: the zero quaternion's fallback is (0, 0, 0, 1)
    in component order, the wgsl vec4's w-last identity, kept as it is."""
    length_sq = ((q[..., 0:1] * q[..., 0:1] + q[..., 1:2] * q[..., 1:2]) + q[..., 2:3] * q[..., 2:3]) \
        + q[..., 3:4] * q[..., 3:4]
    fallback = torch.zeros_like(q)
    fallback[..., 3] = 1.0
    positive = length_sq > 0.0
    return torch.where(positive, q / torch.sqrt(torch.where(positive, length_sq, torch.ones_like(length_sq))), fallback)


def interpolate_clouds(
    lhs: Gaussian3dCloud,
    rhs: Gaussian3dCloud,
    time,
    time_start: float = 0.0,
    time_stop: float = 1.0,
) -> Gaussian3dCloud:
    """GaussianInterpolate lhs/rhs -> output (interpolate.wgsl:71-119)."""
    if len(lhs) != len(rhs):
        raise ValueError(f"interpolate requires equal-size clouds, got {len(lhs)} vs {len(rhs)}")
    t = interpolation_factor(time, time_start, time_stop)

    def lerp(a, b):
        return a + (b - a) * t

    return Gaussian3dCloud(
        position_visibility=lerp(lhs.position_visibility, rhs.position_visibility),
        spherical_harmonic=lerp(lhs.spherical_harmonic, rhs.spherical_harmonic),
        rotation=normalize_quaternion(lerp(lhs.rotation, rhs.rotation)),
        scale_opacity=lerp(lhs.scale_opacity, rhs.scale_opacity),
    )


def interpolate_for_settings(
    lhs: Gaussian3dCloud, rhs: Gaussian3dCloud, settings: CloudSettings, time=None
) -> Gaussian3dCloud:
    """Driven by the CloudSettings playback state (the InterpolatePlugin
    wiring, src/morph/interpolate.rs:110-145)."""
    if time is None:
        time = settings.time
    return interpolate_clouds(lhs, rhs, time, settings.time_start, settings.time_stop)
