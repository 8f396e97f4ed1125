"""Level-of-detail chains (the reference's declared "level of detail"
intent, README.md:55-58; ``stream/lod.py`` of the JAX package).

A LOD chain is a list of clouds: level 0 is the full cloud; each subsequent
level keeps the top ``ratio`` fraction of gaussians by contribution score
(opacity x screen-footprint proxy).  Optional opacity compensation rescales
the survivors so the total opacity mass of the level approximates the full
cloud's.

Scores, their order and the opacity sums are taken on the host with the
JAX package's numpy calls (``np.cbrt`` on float32, the default unstable
``np.argsort``, numpy's pairwise sums), so that ties at the ``k`` boundary
keep the same rows and the compensation gain is the same float; the rows
are gathered and rescaled on the cloud's device.

Selection maps camera distance to a level with a distance-doubling rule:
every doubling of distance past ``base_distance`` drops one level.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from bevy_gaussian_splatting_tpu_torch.stream.slice import aabb_distance, take_rows


def importance_scores(cloud) -> np.ndarray:
    """Per-gaussian contribution proxy: opacity x mean linear extent, on the
    host (float32)."""
    opacity = cloud.opacity.detach().cpu().numpy()
    scale = np.abs(cloud.scale.detach().cpu().numpy())
    extent = np.cbrt(np.maximum(scale.prod(axis=1), 1e-30))
    return opacity * extent


def build_lod_chain(cloud, levels: int = 3, ratio: float = 0.25, compensate: bool = True) -> List[object]:
    """[full, full*ratio, full*ratio^2, ...] importance-ordered sub-clouds."""
    if levels < 1:
        raise ValueError("levels must be >= 1")
    scores = importance_scores(cloud)
    order = np.argsort(-scores)  # descending importance
    opacity = cloud.opacity.detach().cpu().numpy()
    total_mass = float(opacity.sum())
    chain = [cloud]
    n = len(cloud)
    for lv in range(1, levels):
        k = max(1, int(round(n * ratio**lv)))
        idx = np.sort(order[:k])  # preserve original ordering within a level
        sub = take_rows(cloud, idx)
        if compensate:
            kept_mass = float(opacity[idx].sum())
            gain = min(4.0, total_mass / max(kept_mass, 1e-12))
            so = sub.scale_opacity.clone()
            # numpy's float32 column times a Python float rounds in float32
            so[:, 3] = torch.clamp(so[:, 3] * float(np.float32(gain)), max=1.0)
            sub = dataclasses.replace(sub, scale_opacity=so)
        chain.append(sub)
    return chain


def select_lod(aabb_min, aabb_max, camera_position, num_levels: int, base_distance: float) -> int:
    """Distance-doubling level pick for a chunk with the given AABB.

    Distance is measured from the camera to the AABB (0 inside).  Level 0 up
    to ``base_distance``; +1 per doubling after that, clamped to the chain."""
    d = aabb_distance(aabb_min, aabb_max, camera_position)
    if d <= base_distance:
        return 0
    return int(min(np.floor(np.log2(d / base_distance)) + 1, num_levels - 1))
