"""Per-gaussian projection: cloud -> screen-space splat attributes.

The counterpart of the JAX package's ``ops/project.py`` (the reference's
vertex stage ``vs_points``, src/render/gaussian.wgsl:205-436) for 3DGS with
OBB or AABB bounds, 2DGS surfels and 4DGS, in every rasterize and draw
mode, for every cloud class (``Gaussian3dCloud``, ``Gaussian4dCloud``,
``Gaussian3dCovCloud``) stored in float32, float16 or bfloat16.

Outputs ("splats" dict, all [N, ...]):
  mask        bool     survives frustum culling and the SELECTED draw mode
                       (2DGS: and the surfel is valid; 4DGS: and the
                       temporal marginal is above 0.05)
  depth2      f32      squared distance to camera
  sort_key    int64    radix depth key (ops/sort.py), sentinel where culled;
                       4DGS: of the unshifted position, as the reference
                       keys it (rasterize_tile.py:1150-1157)
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
  alpha       f32      opacity * global_opacity (4DGS: times the temporal
                       marginal; 1 where HIGHLIGHT_SELECTED highlights)
"""

from __future__ import annotations

from typing import Optional

import torch

from bevy_gaussian_splatting_tpu_torch.models.camera import Camera
from bevy_gaussian_splatting_tpu_torch.models.cloud import Gaussian3dCovCloud, Gaussian4dCloud
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
from bevy_gaussian_splatting_tpu_torch.ops import gaussian_4d as g4d
from bevy_gaussian_splatting_tpu_torch.ops import sh as sh_ops
from bevy_gaussian_splatting_tpu_torch.ops import sort as sort_ops
from bevy_gaussian_splatting_tpu_torch.ops.transforms import (
    apply_transform,
    in_frustum,
    world_to_clip,
)
from bevy_gaussian_splatting_tpu_torch.ops.cuda.sh import sh_colour
from bevy_gaussian_splatting_tpu_torch.utils import trace
from bevy_gaussian_splatting_tpu_torch.utils.trace import span, spanned


def time_tensor(time, settings: CloudSettings, device) -> torch.Tensor:
    """The frame time as a float32 scalar tensor on ``device``, as the JAX
    package makes it ``jnp.float32(settings.time)`` (project.py:85-86):
    ``settings.time`` where ``time`` is None.  A number becomes a tensor by a
    fill, which neither copies from the host nor waits for the card."""
    if time is None:
        time = settings.time
    if isinstance(time, torch.Tensor):
        return time.to(device=device, dtype=torch.float32)
    return torch.full((), float(time), dtype=torch.float32, device=device)


def local_view_direction(diff: torch.Tensor, dist2: torch.Tensor, model_transform: torch.Tensor) -> torch.Tensor:
    """The SH colour's direction: the view ray ``diff / max(sqrt(dist2),
    1e-12)`` in the cloud's frame, unit (``sh.py``
    ``world_to_local_direction``)."""
    ray_dir = diff / torch.clamp(torch.sqrt(dist2)[..., None], min=1e-12)
    return sh_ops.world_to_local_direction(ray_dir, model_transform)


def as_float32(cloud):
    """f16 and bf16 storage cast to float32 (exactly) before any operation
    (project.py:89-92; the reference decodes PLANAR_F16 in-shader), so
    that every later step, the kernels included, sees float32 only."""
    return cloud if cloud.dtype == torch.float32 else cloud.astype(torch.float32)


def _check_cloud(cloud, settings: CloudSettings) -> None:
    """Raise where the cloud's class does not fit the settings: 4DGS takes
    a ``Gaussian4dCloud`` and only it; the precomputed-covariance cloud
    stores no quaternion or scale, so it takes neither 2DGS nor NORMAL
    (the JAX package's project.py:95-107)."""
    mode = settings.gaussian_mode
    if (mode == GaussianMode.GAUSSIAN_4D) != isinstance(cloud, Gaussian4dCloud):
        raise TypeError(
            f"GaussianMode.{mode.name} cannot render a {type(cloud).__name__}: "
            "GAUSSIAN_4D renders a Gaussian4dCloud, and a Gaussian4dCloud renders only in GAUSSIAN_4D"
        )
    if isinstance(cloud, Gaussian3dCovCloud):
        if mode != GaussianMode.GAUSSIAN_3D:
            raise ValueError("precomputed-covariance clouds support GaussianMode.GAUSSIAN_3D only")
        if settings.rasterize_mode == RasterizeMode.NORMAL:
            raise ValueError(
                "RasterizeMode.NORMAL requires quat/scale storage (not precompute_covariance_3d)"
            )


@spanned("gs.project")
def project_gaussians(
    cloud,
    camera: Camera,
    settings: CloudSettings,
    model_transform: Optional[torch.Tensor] = None,
    aabb_min: Optional[torch.Tensor] = None,
    aabb_max: Optional[torch.Tensor] = None,
    depth_minmax: Optional[tuple] = None,
    delta_time: float = 1.0 / 60.0,
    time=None,
) -> dict:
    """Project a cloud to per-splat screen attributes (vs_points equivalent).

    ``depth_minmax`` is the (min, max) camera distance of the DEPTH ramp,
    which the renderers take from the reference's sorted-entry quirk; without
    it the masked minimum and maximum are used.  ``aabb_min``/``aabb_max``
    bound the POSITION ramp (default: ``cloud.compute_aabb()``, over the
    untransformed positions, as in the JAX package); ``delta_time`` scales
    OPTICAL_FLOW; ``time`` (a number or a float32 scalar tensor, default
    ``settings.time``) is the 4DGS frame time."""
    check_supported(settings)
    _check_cloud(cloud, settings)
    cloud = as_float32(cloud)
    dev = cloud.device
    if model_transform is None:
        model_transform = torch.eye(4, dtype=torch.float32, device=dev)

    viewport = camera.viewport[2:]
    visibility = cloud.visibility
    mode = settings.gaussian_mode

    # the radix key's world position and frustum test: the unshifted
    # position in every mode, also in 4DGS (rasterize_tile.py:1150-1157)
    key_pos = apply_transform(model_transform, cloud.position)
    key_proj = world_to_clip(key_pos, camera.clip_from_world)
    key_visible = in_frustum(key_proj[..., :3])
    opacity = cloud.opacity
    cutoff = cov_ops.opacity_cutoff(opacity, settings.opacity_adaptive_radius)

    cond = None
    if mode == GaussianMode.GAUSSIAN_4D:
        time = time_tensor(time, settings, dev)
        with span("gs.project.time"):
            cond = g4d.conditional_cov3d(
                cloud.rotation, cloud.rotation_r, cloud.scale, cloud.timescale, cloud.timestamp, time,
                settings.global_scale,
            )
        # the mean shifted by the temporal delta, then transformed
        # (gaussian.wgsl:262-283); the covariance is not conjugated by the
        # model transform (gaussian_4d.wgsl), as in the reference
        world_pos = apply_transform(model_transform, cloud.position + cond["delta_mean"])
        proj = world_to_clip(world_pos, camera.clip_from_world)
        visible = in_frustum(proj[..., :3]) & cond["mask"]
        opacity = opacity * cond["opacity_modifier"]
        diff = world_pos - camera.world_position
        dist2 = sort_ops.squared_distance(diff)
        key_dist2 = sort_ops.squared_distance(key_pos - camera.world_position)
    else:
        world_pos, proj, visible = key_pos, key_proj, key_visible
        # the radix key shares the frustum test and the camera offset; it
        # sees neither the draw mode nor the surfel validity
        diff = world_pos - camera.world_position
        key_dist2 = dist2 = sort_ops.squared_distance(diff)
    sort_key = sort_ops.depth_key(key_dist2, key_visible, settings.radix_sort_depth_bits.bits)
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
    if mode == GaussianMode.GAUSSIAN_2D:
        with span("gs.project.surfel"):
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
        with span("gs.project.cov"):
            if cond is not None:
                cov3 = cond["cov3d"]
            elif isinstance(cloud, Gaussian3dCovCloud):
                # stored as is: no model-transform conjugation, no global scale
                # (gaussian_3d.wgsl:76-81, get_cov3d)
                cov3 = cloud.cov3d
            else:
                cov3 = cov_ops.compute_cov3d(cloud.rotation, cloud.scale, settings.global_scale, model_transform)
            cov2 = cov_ops.cov2d(world_pos, cov3, camera.view_from_world, camera.clip_from_view, viewport)
            if settings.aabb:
                splats["conic"] = cov_ops.conic_from_cov2d(cov2)
                splats["radius_vp"] = cov_ops.aabb_radius(cov2, cutoff)
            else:
                major, minor, axis = cov_ops.obb_axes(cov2, cutoff)
                splats["obb_bounds"] = torch.stack([major, minor], dim=-1)
                splats["obb_axis"] = axis

    # colour per rasterize mode (gaussian.wgsl:312-421, project.py:198-262)
    with span("gs.project.sh"):
        rmode = settings.rasterize_mode
        if rmode in (RasterizeMode.COLOR, RasterizeMode.CLASSIFICATION):
            trace.count("sh.calls")
            # SH lookup along the view ray: ops/sh.py's lookups as one
            # autograd function, a kernel each way on the card
            ray_dir_local = local_view_direction(diff, dist2, model_transform)
            if cond is not None:
                # duration = float32(time_stop - time_start) (project.py:56-66)
                duration = torch.full((), settings.time_stop - settings.time_start, dtype=torch.float32, device=dev)
                rgb = sh_colour(ray_dir_local, cloud.spherindrical_harmonic, cond["dir_t"], duration)
            else:
                rgb = sh_colour(ray_dir_local, cloud.spherical_harmonic)
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
            # column of model[:3, :3] @ (R * s[:, None]); 4DGS takes the left
            # quaternion (project.py:213-226)
            R = cov_ops.quat_to_rotation_matrix(cloud.rotation)
            SR = R * (cloud.scale * settings.global_scale)[..., :, None]
            local_normal = (model_transform[:3, :3] @ SR)[..., :, 2]
            world_normal = local_normal @ camera.view_from_world[:3, :3].T
            t = world_normal / torch.clamp(torch.linalg.norm(world_normal, dim=-1, keepdim=True), min=1e-12)
            rgb = 0.5 * (t + 1.0)
        elif rmode == RasterizeMode.OPTICAL_FLOW:
            # the previous world position is the unshifted one (project.py:113-115):
            # without 4DGS the flow comes from the camera's previous clip matrix
            # alone, with it also from the temporal shift
            mv = color_ops.calculate_motion_vector(
                world_pos, key_pos, camera.clip_from_world, camera.prev_clip_from_world
            )
            rgb = color_ops.optical_flow_to_rgb(mv, delta_time)
        elif rmode == RasterizeMode.POSITION:
            if aabb_min is None or aabb_max is None:
                # over the positions, applied to the world positions (a quirk of
                # the JAX package, project.py:237-240)
                aabb_min, aabb_max = cloud.compute_aabb()
            rgb = (world_pos - aabb_min) / (aabb_max - aabb_min)
        else:  # VELOCITY (check_supported let it through with 4DGS only)
            # a float32 finite difference of the delta mean over 1e-3 of time
            # (gaussian.wgsl:378-405, project.py:241-260)
            time_delta = torch.full((), 1e-3, dtype=torch.float32, device=dev)
            cond_f = g4d.conditional_cov3d(
                cloud.rotation, cloud.rotation_r, cloud.scale, cloud.timescale, cloud.timestamp, time + 1e-3,
                settings.global_scale,
            )
            vel = (cond_f["delta_mean"] - cond["delta_mean"]) / time_delta
            vmag = torch.linalg.norm(vel, dim=-1)
            vdir = vel / torch.clamp(vmag[..., None], min=1e-12)
            scaled_mag = torch.clamp((vmag - 1.0) / (2.0 - 1.0), 0.0, 1.0)
            opacity = torch.where(scaled_mag < 1e-2, torch.zeros_like(opacity), opacity)
            rgb = 0.5 * (vdir + 1.0) * scaled_mag[..., None]

    alpha = opacity * settings.global_opacity
    if settings.draw_mode == DrawMode.HIGHLIGHT_SELECTED:
        selected = visibility > 0.5
        highlight = torch.tensor([0.3, 1.0, 0.1], dtype=rgb.dtype, device=dev)
        rgb = torch.where(selected[..., None], highlight, rgb)
        alpha = torch.where(selected, torch.ones_like(alpha), alpha)
    splats["rgb"] = rgb
    splats["alpha"] = alpha
    return splats
