"""Per-gaussian projection: cloud -> screen-space splat attributes.

The counterpart of the JAX package's ``ops/project.py`` (the reference's
vertex stage ``vs_points``, src/render/gaussian.wgsl:205-436), for the
default configuration only: 3DGS, OBB bounds, COLOR mode.

Outputs ("splats" dict, all [N, ...]):
  mask        bool     survives frustum culling
  depth2      f32      squared distance to camera
  sort_key    int64    radix depth key (ops/sort.py), sentinel where culled
  center_ndc  [N, 2]   projected center in NDC
  cutoff      f32      sigma cutoff (3 or opacity-adaptive)
  obb_bounds  [N, 2]   major / minor radius in vp units
  obb_axis    [N, 2]   unit major eigenvector
  rgb         [N, 3]   SH colour (linear)
  alpha       f32      opacity * global_opacity
"""

from __future__ import annotations

from typing import Optional

import torch

from bevy_gaussian_splatting_tpu_torch.models.camera import Camera
from bevy_gaussian_splatting_tpu_torch.models.cloud import Gaussian3dCloud
from bevy_gaussian_splatting_tpu_torch.models.settings import (
    CloudSettings,
    GaussianColorSpace,
    check_supported,
)
from bevy_gaussian_splatting_tpu_torch.ops import covariance as cov_ops
from bevy_gaussian_splatting_tpu_torch.ops import sh as sh_ops
from bevy_gaussian_splatting_tpu_torch.ops import sort as sort_ops
from bevy_gaussian_splatting_tpu_torch.ops.transforms import (
    apply_transform,
    in_frustum,
    world_to_clip,
)


def project_gaussians(
    cloud: Gaussian3dCloud,
    camera: Camera,
    settings: CloudSettings,
    model_transform: Optional[torch.Tensor] = None,
) -> dict:
    """Project a cloud to per-splat screen attributes (vs_points equivalent)."""
    check_supported(settings)
    if not isinstance(cloud, Gaussian3dCloud):
        raise NotImplementedError(
            f"{type(cloud).__name__} arrives with slice 3 (other kernel modes)"
        )
    dev = cloud.device
    if model_transform is None:
        model_transform = torch.eye(4, dtype=torch.float32, device=dev)
    if cloud.position_visibility.dtype != torch.float32:
        raise TypeError("cloud tensors must be float32")

    viewport = camera.viewport[2:]

    world_pos = apply_transform(model_transform, cloud.position)
    opacity = cloud.opacity
    cutoff = cov_ops.opacity_cutoff(opacity, settings.opacity_adaptive_radius)

    proj = world_to_clip(world_pos, camera.clip_from_world)
    mask = in_frustum(proj[..., :3])
    # the radix key shares the frustum test and the camera offset
    diff = world_pos - camera.world_position
    dist2 = sort_ops.squared_distance(diff)
    sort_key = sort_ops.depth_key(dist2, mask, settings.radix_sort_depth_bits.bits)
    cov3 = cov_ops.compute_cov3d(
        cloud.rotation, cloud.scale, settings.global_scale, model_transform
    )
    cov2 = cov_ops.cov2d(
        world_pos, cov3, camera.view_from_world, camera.clip_from_view, viewport
    )
    major, minor, axis = cov_ops.obb_axes(cov2, cutoff)

    # COLOR mode (gaussian.wgsl:312-328): SH lookup along the view ray
    ray_dir = diff / torch.clamp(torch.sqrt(dist2)[..., None], min=1e-12)
    ray_dir_local = sh_ops.world_to_local_direction(ray_dir, model_transform)
    rgb = sh_ops.spherical_harmonics_lookup(ray_dir_local, cloud.spherical_harmonic)
    if settings.color_space == GaussianColorSpace.SRGB_REC709_DISPLAY:
        rgb = sh_ops.srgb_to_linear(rgb)

    return {
        "mask": mask,
        "center_ndc": proj[..., :2],
        "depth2": dist2,
        "sort_key": sort_key,
        "cutoff": cutoff,
        "obb_bounds": torch.stack([major, minor], dim=-1),
        "obb_axis": axis,
        "rgb": rgb,
        "alpha": opacity * settings.global_opacity,
    }
