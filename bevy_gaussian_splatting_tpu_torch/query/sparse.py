"""Sparse-outlier selection by k-d tree radius counts (reference:
src/query/sparse.rs:23-53): the gaussians with fewer than
``neighbor_threshold`` neighbours within ``radius``, a point counting as its
own neighbour (kd_tree::within_radius).  Cloud clean-up and the
ply_to_gcloud import filter use it.

scipy's ``cKDTree`` runs on a host copy of the positions (the reference is
host-side too); ``chunk`` bounds the peak memory of the counts.
"""

from __future__ import annotations

import numpy as np

from bevy_gaussian_splatting_tpu_torch.query.select import Select, extract_selection

DEFAULT_RADIUS = 0.05  # sparse.rs:32
DEFAULT_NEIGHBOR_THRESHOLD = 3  # sparse.rs:33


def sparse_select(
    cloud,
    radius: float = DEFAULT_RADIUS,
    neighbor_threshold: int = DEFAULT_NEIGHBOR_THRESHOLD,
    chunk: int = 262_144,
) -> Select:
    """SparseSelect::select (sparse.rs:40-53)."""
    from scipy.spatial import cKDTree

    points = cloud.position.detach().float().cpu().numpy()
    tree = cKDTree(points)
    counts = np.empty(len(points), dtype=np.int64)
    for lo in range(0, len(points), chunk):
        hi = min(lo + chunk, len(points))
        counts[lo:hi] = tree.query_ball_point(points[lo:hi], r=radius, return_length=True)
    return Select(np.nonzero(counts < neighbor_threshold)[0])


def remove_outliers(
    cloud,
    radius: float = DEFAULT_RADIUS,
    neighbor_threshold: int = DEFAULT_NEIGHBOR_THRESHOLD,
):
    """The cloud without its sparse outliers (the ply_to_gcloud filter,
    tools/ply_to_gcloud.rs)."""
    return extract_selection(cloud, sparse_select(cloud, radius, neighbor_threshold).invert(len(cloud)))
