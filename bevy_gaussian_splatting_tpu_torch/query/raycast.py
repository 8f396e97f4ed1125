"""Point-in-mesh tests by Möller–Trumbore ray-triangle parity (reference:
src/query/raycast.rs:54-124): a +x ray from each point, its triangle
crossings counted, odd parity inside.  Points x triangles are one broadcast
``[P, T]`` computation on the points' device (the reference loops the
triangles per point; the JAX package vmaps over the points), in chunks of
points that bound its memory.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

EPSILON = 1e-6  # raycast.rs:92
CHUNK = 1 << 18  # points per broadcast chunk


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def ray_intersects_triangle(
    ray_origin: torch.Tensor,  # [..., 3]
    ray_direction: torch.Tensor,  # [3]
    v0: torch.Tensor,  # [..., 3]
    v1: torch.Tensor,
    v2: torch.Tensor,
) -> torch.Tensor:
    """Möller–Trumbore (raycast.rs:91-124), broadcast over leading axes."""
    edge1 = v1 - v0
    edge2 = v2 - v0
    h = torch.linalg.cross(ray_direction.expand(edge2.shape), edge2)
    a = _dot(edge1, h)
    non_parallel = a.abs() > EPSILON
    f = 1.0 / torch.where(non_parallel, a, torch.ones_like(a))
    s = ray_origin - v0
    u = f * _dot(s, h)
    q = torch.linalg.cross(s, edge1.expand(s.shape))
    v = f * _dot(ray_direction.expand(q.shape), q)
    t = f * _dot(edge2.expand(q.shape), q)
    return non_parallel & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0) & (t > EPSILON)


def points_in_mesh(
    points: torch.Tensor,  # [P, 3]
    vertices,  # [V, 3]
    indices,  # [F, 3] int
    mesh_transform: Optional[torch.Tensor] = None,  # [4, 4] mesh-to-world
) -> torch.Tensor:
    """bool [P] on the points' device: odd +x-ray crossing parity
    (raycast.rs:54-90), the points taken into mesh space by the inverse
    transform as the reference does."""
    dev = points.device
    points = points.to(torch.float32)
    if mesh_transform is not None:
        inv = torch.linalg.inv(torch.as_tensor(mesh_transform, dtype=torch.float32, device=dev))
        points = points @ inv[:3, :3].T + inv[:3, 3]
    vertices = torch.as_tensor(vertices, dtype=torch.float32, device=dev)
    indices = torch.as_tensor(indices, dtype=torch.int64, device=dev)
    tri = vertices[indices]  # [F, 3, 3]
    v0, v1, v2 = tri[:, 0], tri[:, 1], tri[:, 2]
    ray_dir = torch.tensor([1.0, 0.0, 0.0], dtype=torch.float32, device=dev)
    inside = []
    for lo in range(0, len(points), CHUNK):
        hits = ray_intersects_triangle(points[lo:lo + CHUNK, None, :], ray_dir, v0, v1, v2)  # [p, F]
        inside.append(hits.sum(dim=1, dtype=torch.int32) % 2 == 1)
    return torch.cat(inside) if inside else torch.zeros(0, dtype=torch.bool, device=dev)


def select_in_mesh(cloud, vertices, indices, mesh_transform=None):
    """The selection of the gaussians whose centres lie inside the mesh."""
    from bevy_gaussian_splatting_tpu_torch.query.select import Select

    inside = points_in_mesh(cloud.position, vertices, indices, mesh_transform)
    return Select(np.nonzero(inside.cpu().numpy())[0])
