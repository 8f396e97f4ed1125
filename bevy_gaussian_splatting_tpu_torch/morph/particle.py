"""Particle behaviours: jerk -> acceleration -> velocity -> position
(reference: src/morph/particle.rs, src/morph/particle.wgsl:23-53), as the
JAX package's ``morph/particle.py`` steps them: one functional step adds each
behaviour's cubic motion to its gaussian's ``position_visibility`` by
``index_add``.  Several behaviours on one gaussian sum; on the card their
order is unspecified, so such a sum may round apart from the CPU's.  A
negative index is inert (particle.wgsl:41-43).

The reference adds the vec4 delta, so a velocity with a w component drifts
the visibility channel too (particle.wgsl:37-47); kept.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from bevy_gaussian_splatting_tpu_torch.device import DeviceLike, resolve_device
from bevy_gaussian_splatting_tpu_torch.models.cloud import Gaussian3dCloud


@dataclasses.dataclass(frozen=True)
class ParticleBehaviors:
    """SoA mirror of the reference's ParticleBehavior storage buffer."""

    indices: torch.Tensor  # [B] int32, negative = inert
    velocity: torch.Tensor  # [B, 4]
    acceleration: torch.Tensor  # [B, 4]
    jerk: torch.Tensor  # [B, 4]

    @staticmethod
    def random(n: int, seed: int = 0, scale: float = 0.1, device: DeviceLike = None) -> "ParticleBehaviors":
        """The JAX package's draws (numpy ``default_rng(seed)``), on ``device``."""
        dev = resolve_device(device)
        rng = np.random.default_rng(seed)
        z = np.zeros((n, 1), np.float32)

        def vec(s):
            return torch.from_numpy(
                np.concatenate([rng.normal(0, s, (n, 3)).astype(np.float32), z], axis=1)
            ).to(dev)

        return ParticleBehaviors(
            indices=torch.arange(n, dtype=torch.int32, device=dev),
            velocity=vec(scale),
            acceleration=vec(scale * 0.1),
            jerk=vec(scale * 0.01),
        )


def apply_particle_behaviors(
    cloud: Gaussian3dCloud,
    behaviors: ParticleBehaviors,
    delta_time: float,
) -> tuple[Gaussian3dCloud, ParticleBehaviors]:
    """One integration step (particle.wgsl:23-53)."""
    dt = float(np.float32(delta_time))
    v, a, j = behaviors.velocity, behaviors.acceleration, behaviors.jerk

    delta_position = v * dt + 0.5 * a * dt * dt + (1.0 / 6.0) * j * dt * dt * dt
    new_velocity = v + a * dt + 0.5 * j * dt * dt
    new_acceleration = a + j * dt

    active = (behaviors.indices >= 0)[:, None]
    idx = behaviors.indices.to(torch.int64).clamp(0, len(cloud) - 1)
    delta = torch.where(active, delta_position, torch.zeros_like(delta_position))
    pv = cloud.position_visibility.index_add(0, idx, delta)
    return dataclasses.replace(cloud, position_visibility=pv), ParticleBehaviors(
        indices=behaviors.indices,
        velocity=torch.where(active, new_velocity, v),
        acceleration=torch.where(active, new_acceleration, a),
        jerk=behaviors.jerk,
    )
