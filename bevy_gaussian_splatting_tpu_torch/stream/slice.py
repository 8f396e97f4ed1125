"""Spatial cloud slicing (the reference's ``src/stream/slice.rs`` intent;
``stream/slice.py`` of the JAX package).

Partition a cloud into an axis-aligned grid of chunks, each carrying its own
AABB, and re-assemble chunks into one cloud.  Chunks are ordinary clouds on
the source cloud's device, so every renderer, IO and query path applies to
them unchanged.  The cell of each gaussian is computed on the host in numpy,
with the JAX package's expression: ``(pos - lo) / span`` is float32, and the
product with the int64 grid promotes to float64 before the truncation, so a
position on a cell boundary lands in the same chunk in both packages.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np
import torch


@dataclasses.dataclass
class CloudChunk:
    """One spatial block of a larger cloud."""

    cloud: object  # Gaussian3dCloud / Gaussian4dCloud / Gaussian3dCovCloud
    aabb_min: np.ndarray  # [3] tight bounds of the member positions
    aabb_max: np.ndarray  # [3]
    cell: Tuple[int, int, int]  # grid index

    def __len__(self) -> int:
        return len(self.cloud)


def take_rows(cloud, idx: np.ndarray):
    """The rows ``idx`` (host indices) of every field, gathered on the
    cloud's own device."""
    rows = torch.from_numpy(np.asarray(idx, dtype=np.int64)).to(cloud.device)
    return type(cloud)(**{f.name: getattr(cloud, f.name)[rows] for f in dataclasses.fields(cloud)})


def aabb_distance(lo, hi, p) -> float:
    """Euclidean distance from point ``p`` to the AABB [lo, hi] (0 inside)."""
    lo = np.asarray(lo, dtype=np.float64)
    hi = np.asarray(hi, dtype=np.float64)
    p = np.asarray(p, dtype=np.float64)
    return float(np.linalg.norm(np.maximum(np.maximum(lo - p, p - hi), 0.0)))


def slice_cloud(cloud, grid: Sequence[int] = (2, 2, 2), drop_empty: bool = True) -> List[CloudChunk]:
    """Partition ``cloud`` into a ``grid`` of AABB blocks by position.

    Every gaussian lands in exactly one chunk (upper-boundary positions go to
    the last cell).  Returns chunks in row-major cell order."""
    pos = cloud.position.detach().cpu().numpy()
    lo = pos.min(axis=0)
    hi = pos.max(axis=0)
    span = np.maximum(hi - lo, 1e-12)
    g = np.asarray(grid, dtype=np.int64)
    cell = np.clip(((pos - lo) / span * g).astype(np.int64), 0, g - 1)
    flat = (cell[:, 0] * g[1] + cell[:, 1]) * g[2] + cell[:, 2]

    chunks: List[CloudChunk] = []
    for cx in range(g[0]):
        for cy in range(g[1]):
            for cz in range(g[2]):
                fid = (cx * g[1] + cy) * g[2] + cz
                idx = np.nonzero(flat == fid)[0]
                if drop_empty and idx.size == 0:
                    continue
                p = pos[idx] if idx.size else np.zeros((1, 3))
                chunks.append(
                    CloudChunk(
                        cloud=take_rows(cloud, idx),
                        aabb_min=p.min(axis=0),
                        aabb_max=p.max(axis=0),
                        cell=(cx, cy, cz),
                    )
                )
    return chunks


def concat_clouds(clouds: Sequence[object]):
    """Field-wise concatenation of same-type clouds on one device."""
    if not clouds:
        raise ValueError("concat_clouds needs at least one cloud")
    return type(clouds[0])(**{
        f.name: torch.cat([getattr(c, f.name) for c in clouds], dim=0) for f in dataclasses.fields(clouds[0])
    })
