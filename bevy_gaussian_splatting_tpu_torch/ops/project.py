"""Per-gaussian projection: cloud -> screen-space splat attributes.

The counterpart of the JAX package's ``ops/project.py`` (the reference's
vertex stage ``vs_points``, src/render/gaussian.wgsl:205-436) for 3DGS with
OBB or AABB bounds and for 2DGS surfels, in every rasterize mode but
VELOCITY (which needs 4DGS) and every draw mode.

Outputs ("splats" dict, all [N, ...]):
  mask        bool     survives frustum culling and the SELECTED draw mode
                       (2DGS: and the surfel is valid)
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
  rgb         [N, 3]   the rasterize mode's colour (COLOR: linear SH colour)
  alpha       f32      opacity * global_opacity (1 where HIGHLIGHT_SELECTED
                       highlights)
"""

from __future__ import annotations

from typing import Optional

import torch

from bevy_gaussian_splatting_tpu_torch.models.camera import Camera
from bevy_gaussian_splatting_tpu_torch.models.cloud import Gaussian3dCloud
from bevy_gaussian_splatting_tpu_torch.models.settings import (
    CloudSettings,
    DrawMode,
    GaussianColorSpace,
    GaussianMode,
    RasterizeMode,
    check_supported,
)
from bevy_gaussian_splatting_tpu_torch.ops import color as color_ops
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
    aabb_min: Optional[torch.Tensor] = None,
    aabb_max: Optional[torch.Tensor] = None,
    depth_minmax: Optional[tuple] = None,
    delta_time: float = 1.0 / 60.0,
) -> dict:
    """Project a cloud to per-splat screen attributes (vs_points equivalent).

    ``depth_minmax`` is the (min, max) camera distance of the DEPTH ramp,
    which the renderers take from the reference's sorted-entry quirk; without
    it the masked minimum and maximum are used.  ``aabb_min``/``aabb_max``
    bound the POSITION ramp (default: ``cloud.compute_aabb()``, over the
    untransformed positions, as in the JAX package); ``delta_time`` scales
    OPTICAL_FLOW."""
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
    visibility = cloud.visibility

    world_pos = apply_transform(model_transform, cloud.position)
    opacity = cloud.opacity
    cutoff = cov_ops.opacity_cutoff(opacity, settings.opacity_adaptive_radius)

    proj = world_to_clip(world_pos, camera.clip_from_world)
    visible = in_frustum(proj[..., :3])
    # the radix key shares the frustum test and the camera offset; it sees
    # neither the draw mode nor the surfel validity
    diff = world_pos - camera.world_position
    dist2 = sort_ops.squared_distance(diff)
    sort_key = sort_ops.depth_key(dist2, visible, settings.radix_sort_depth_bits.bits)
    mask = visible
    if settings.draw_mode == DrawMode.SELECTED:
        mask = mask & (visibility >= 0.5)  # gaussian.wgsl:219-221

    splats = {
        "mask": mask,
        "center_ndc": proj[..., :2],
        "depth2": dist2,
        "sort_key": sort_key,
        "cutoff": cutoff,
    }
    if settings.gaussian_mode == GaussianMode.GAUSSIAN_2D:
        # an invalid surfel leaves the mask after the radix key
        # (render_tiled takes the key from radix_depth_key's own frustum
        # test, rasterize_tile.py:1154-1174)
        T, mean_2d, extent, valid = g2d.compute_cov2d_surfel(
            world_pos, cloud.rotation, cloud.scale, settings.global_scale, model_transform,
            camera.clip_from_world, camera.clip_from_view, viewport, cutoff,
        )
        splats["mask"] = mask & valid
        splats["surfel_t"] = T
        splats["mean_2d"] = mean_2d
        splats["surfel_radius"] = g2d.surfel_bounding_radius(extent, cutoff)
    else:
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

    # colour per rasterize mode (gaussian.wgsl:312-421, project.py:198-262)
    rmode = settings.rasterize_mode
    if rmode in (RasterizeMode.COLOR, RasterizeMode.CLASSIFICATION):
        # SH lookup along the view ray
        ray_dir = diff / torch.clamp(torch.sqrt(dist2)[..., None], min=1e-12)
        ray_dir_local = sh_ops.world_to_local_direction(ray_dir, model_transform)
        rgb = sh_ops.spherical_harmonics_lookup(ray_dir_local, cloud.spherical_harmonic)
        if settings.color_space == GaussianColorSpace.SRGB_REC709_DISPLAY:
            rgb = sh_ops.srgb_to_linear(rgb)
        if rmode == RasterizeMode.CLASSIFICATION:
            rgb = color_ops.class_to_rgb(visibility, rgb, settings.num_classes)
    elif rmode == RasterizeMode.DEPTH:
        depth = torch.sqrt(dist2)
        if depth_minmax is None:
            min_d = torch.where(mask, depth, torch.inf).min()
            max_d = torch.where(mask, depth, -torch.inf).max()
        else:
            min_d, max_d = depth_minmax
        rgb = color_ops.depth_to_rgb(depth, min_d, max_d)
    elif rmode == RasterizeMode.NORMAL:
        # view-space z axis of T S R (gaussian.wgsl:348-368): the third
        # column of model[:3, :3] @ (R * s[:, None])
        R = cov_ops.quat_to_rotation_matrix(cloud.rotation)
        SR = R * (cloud.scale * settings.global_scale)[..., :, None]
        local_normal = (model_transform[:3, :3] @ SR)[..., :, 2]
        world_normal = local_normal @ camera.view_from_world[:3, :3].T
        t = world_normal / torch.clamp(torch.linalg.norm(world_normal, dim=-1, keepdim=True), min=1e-12)
        rgb = 0.5 * (t + 1.0)
    elif rmode == RasterizeMode.OPTICAL_FLOW:
        # the previous world position is the current one (project.py:115):
        # the flow comes from the camera's previous clip matrix alone
        mv = color_ops.calculate_motion_vector(
            world_pos, world_pos, camera.clip_from_world, camera.prev_clip_from_world
        )
        rgb = color_ops.optical_flow_to_rgb(mv, delta_time)
    else:  # POSITION (check_supported let no other mode through)
        if aabb_min is None or aabb_max is None:
            # over the positions, applied to the world positions (a quirk of
            # the JAX package, project.py:237-240)
            aabb_min, aabb_max = cloud.compute_aabb()
        rgb = (world_pos - aabb_min) / (aabb_max - aabb_min)

    alpha = opacity * settings.global_opacity
    if settings.draw_mode == DrawMode.HIGHLIGHT_SELECTED:
        selected = visibility > 0.5
        highlight = torch.tensor([0.3, 1.0, 0.1], dtype=rgb.dtype, device=dev)
        rgb = torch.where(selected[..., None], highlight, rgb)
        alpha = torch.where(selected, torch.ones_like(alpha), alpha)
    splats["rgb"] = rgb
    splats["alpha"] = alpha
    return splats
