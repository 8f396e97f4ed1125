"""One cloud rendered from several cameras.

The counterpart of the JAX package's ``render/multi_camera.py``.  The
reference chunks its sorted-entries buffer per camera
(examples/multi_camera.rs, src/sort/mod.rs:347-354), and the JAX package
``vmap``s the tiled pipeline over a stacked camera batch.  Here each camera
is one serving frame (``render_tiled(..., differentiable=False)``), in turn,
and the images are stacked.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from bevy_gaussian_splatting_tpu_torch.device import DeviceLike, resolve_device
from bevy_gaussian_splatting_tpu_torch.models.camera import Camera
from bevy_gaussian_splatting_tpu_torch.models.settings import CloudSettings
from bevy_gaussian_splatting_tpu_torch.ops.rasterize_tile import render_tiled

_TENSOR_FIELDS = ("view_from_world", "clip_from_view", "viewport", "prev_clip_from_world", "world_position")


def _check_one_size(cameras: Sequence[Camera]) -> None:
    sizes = {(c.width, c.height) for c in cameras}
    if len(sizes) != 1:
        raise ValueError(f"cameras of one batch share one image size, got {sorted(sizes)}")


def stack_cameras(cameras: Sequence[Camera]) -> Camera:
    """Cameras of one image size stacked along a leading batch axis (every
    tensor field); raises where their sizes differ."""
    _check_one_size(cameras)
    first = cameras[0]
    return dataclasses.replace(
        first, **{name: torch.stack([getattr(c, name) for c in cameras]) for name in _TENSOR_FIELDS}
    )


def _unstack_cameras(batch: Camera) -> list:
    """The cameras of a stacked batch, in order."""
    return [
        dataclasses.replace(batch, **{name: getattr(batch, name)[i] for name in _TENSOR_FIELDS})
        for i in range(batch.view_from_world.shape[0])
    ]


def render_multi_camera(
    cloud,
    cameras,
    settings: Optional[CloudSettings] = None,
    width: Optional[int] = None,
    height: Optional[int] = None,
    background: Optional[torch.Tensor] = None,
    device: DeviceLike = None,
) -> torch.Tensor:
    """Render one cloud from a batch of cameras -> [C, H, W, 4].

    ``cameras`` is a list of cameras of one image size or a batch from
    :func:`stack_cameras`; ``width`` and ``height`` default to the cameras'.
    Runs on the card unless ``device`` says otherwise; cloud and cameras
    are moved there if they lie elsewhere."""
    dev = resolve_device(device)
    if settings is None:
        settings = CloudSettings()
    if isinstance(cameras, Camera):
        cameras = _unstack_cameras(cameras)
    else:
        _check_one_size(cameras)
    if cloud.device != dev:
        cloud = cloud.to(dev)
    if background is not None and background.device != dev:
        background = background.to(dev)
    images = [
        render_tiled(
            cloud, cam if cam.device == dev else cam.to(dev), settings, background=background,
            differentiable=False, width=width, height=height,
        )
        for cam in cameras
    ]
    return torch.stack(images)
