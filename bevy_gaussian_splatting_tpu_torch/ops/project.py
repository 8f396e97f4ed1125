"""Per-gaussian projection: cloud -> screen-space splat attributes.

The counterpart of the JAX package's ``ops/project.py`` (the reference's
vertex stage ``vs_points``, src/render/gaussian.wgsl:205-436), in COLOR mode
for 3DGS with OBB or AABB bounds and for 2DGS surfels.

Outputs ("splats" dict, all [N, ...]):
  mask        bool     survives frustum culling (2DGS: and the surfel is valid)
  depth2      f32      squared distance to camera
  sort_key    int64    radix depth key (ops/sort.py), sentinel where culled
  center_ndc  [N, 2]   projected center in NDC
  cutoff      f32      sigma cutoff (3 or opacity-adaptive)
  obb_bounds  [N, 2]   major / minor radius in vp units      (OBB)
  obb_axis    [N, 2]   unit major eigenvector                (OBB)
  conic       [N, 3]   inverse 2D covariance                 (AABB)
  radius_vp   f32      axis-aligned bounding radius, vp units (AABB)
  surfel_t    [N, 3, 3] local-to-pixel homography             (2DGS)
  mean_2d     [N, 2]   homography centre, true pixels         (2DGS)
  surfel_radius f32    bounding radius, doubled pixel units    (2DGS)
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
    GaussianMode,
    check_supported,
)
from bevy_gaussian_splatting_tpu_torch.ops import covariance as cov_ops
from bevy_gaussian_splatting_tpu_torch.ops import gaussian_2d as g2d
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

    # COLOR mode (gaussian.wgsl:312-328): SH lookup along the view ray
    ray_dir = diff / torch.clamp(torch.sqrt(dist2)[..., None], min=1e-12)
    ray_dir_local = sh_ops.world_to_local_direction(ray_dir, model_transform)
    rgb = sh_ops.spherical_harmonics_lookup(ray_dir_local, cloud.spherical_harmonic)
    if settings.color_space == GaussianColorSpace.SRGB_REC709_DISPLAY:
        rgb = sh_ops.srgb_to_linear(rgb)

    splats = {
        "mask": mask,
        "center_ndc": proj[..., :2],
        "depth2": dist2,
        "sort_key": sort_key,
        "cutoff": cutoff,
        "rgb": rgb,
        "alpha": opacity * settings.global_opacity,
    }
    if settings.gaussian_mode == GaussianMode.GAUSSIAN_2D:
        # the radix key above saw the frustum test only; an invalid surfel
        # leaves the mask after it (render_tiled takes the key from
        # radix_depth_key's own frustum test, rasterize_tile.py:1154-1174)
        T, mean_2d, extent, valid = g2d.compute_cov2d_surfel(
            world_pos, cloud.rotation, cloud.scale, settings.global_scale, model_transform,
            camera.clip_from_world, camera.clip_from_view, viewport, cutoff,
        )
        splats["mask"] = mask & valid
        splats["surfel_t"] = T
        splats["mean_2d"] = mean_2d
        splats["surfel_radius"] = g2d.surfel_bounding_radius(extent, cutoff)
        return splats
    cov3 = cov_ops.compute_cov3d(
        cloud.rotation, cloud.scale, settings.global_scale, model_transform
    )
    cov2 = cov_ops.cov2d(
        world_pos, cov3, camera.view_from_world, camera.clip_from_view, viewport
    )
    if settings.aabb:
        splats["conic"] = cov_ops.conic_from_cov2d(cov2)
        splats["radius_vp"] = cov_ops.aabb_radius(cov2, cutoff)
    else:
        major, minor, axis = cov_ops.obb_axes(cov2, cutoff)
        splats["obb_bounds"] = torch.stack([major, minor], dim=-1)
        splats["obb_axis"] = axis
    return splats
