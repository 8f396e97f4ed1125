"""Selections: index lists and per-gaussian visibility (reference:
src/query/select.rs:13-176).  A selection lives in the
``position_visibility.w`` channel as 0.0 / 1.0: ``DrawMode.SELECTED``
renders only w >= 0.5, ``HIGHLIGHT_SELECTED`` recolours them, and
classification reads w >= 2 as a class index, so a selection writes floats.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Union

import numpy as np
import torch

from bevy_gaussian_splatting_tpu_torch.device import DeviceLike, resolve_device
from bevy_gaussian_splatting_tpu_torch.models.cloud import Gaussian3dCloud


@dataclasses.dataclass
class Select:
    """An index-list selection (select.rs:13-27), held on the host."""

    indices: np.ndarray  # int64 indices into the cloud

    def __init__(self, indices: Union[Sequence[int], np.ndarray]):
        self.indices = np.asarray(indices, dtype=np.int64)

    def __len__(self) -> int:
        return len(self.indices)

    def invert(self, cloud_size: int) -> "Select":
        """select.rs:29-40."""
        mask = np.ones(cloud_size, dtype=bool)
        mask[self.indices] = False
        return Select(np.nonzero(mask)[0])

    def to_visibility(self, cloud_size: int, device: DeviceLike = None) -> torch.Tensor:
        vis = np.zeros(cloud_size, dtype=np.float32)
        vis[self.indices] = 1.0
        return torch.from_numpy(vis).to(resolve_device(device))


def apply_selection(cloud, selection: Select):
    """The selection written into the visibility channel (the
    ``apply_selection`` system, select.rs:118-152), on the cloud's device."""
    return cloud.with_visibility(selection.to_visibility(len(cloud), cloud.device))


def selection_from_visibility(cloud) -> Select:
    """The index list back from the visibility channel."""
    return Select(np.nonzero(cloud.visibility.cpu().numpy() >= 0.5)[0])


def extract_selection(cloud: Gaussian3dCloud, selection: Select) -> Gaussian3dCloud:
    """The cloud of the selected gaussians only: the ``SaveSelectionEvent``
    path that writes live_output.gcloud (select.rs:155-176)."""
    idx = torch.from_numpy(selection.indices).to(cloud.device)
    return Gaussian3dCloud(
        position_visibility=cloud.position_visibility[idx],
        spherical_harmonic=cloud.spherical_harmonic[idx],
        rotation=cloud.rotation[idx],
        scale_opacity=cloud.scale_opacity[idx],
    )


def save_selection(cloud: Gaussian3dCloud, selection: Select, path: str) -> int:
    from bevy_gaussian_splatting_tpu_torch.io.loader import save_cloud

    return save_cloud(extract_selection(cloud, selection), path)
