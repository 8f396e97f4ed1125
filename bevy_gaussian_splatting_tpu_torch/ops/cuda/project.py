"""The frame's projection: a cloud to the fields the binning reads and the
packed compositor rows, one dict on every path (:func:`project_splats`),
from one kernel (``csrc/project.cu``) where it applies.

Replaces no TPU kernel: the JAX package leaves the projection chain
(``ops/project.py``, ``covariance.py``, ``sh.py``, ``gaussian_4d.py``) to
XLA, which fuses it.  Run eagerly, that chain and the packing's stack are
some 600 launches a served frame, and the frame was bound by issuing them.
The kernel does the same float32 work, term for term in the chain's order
(see the source), for ``GAUSSIAN_3D`` and ``GAUSSIAN_2D`` (a
``Gaussian3dCloud``, the second drawn as surfels: the 16-column surfel rows)
and ``GAUSSIAN_4D`` (a ``Gaussian4dCloud``) in ``RasterizeMode.COLOR``, every
draw mode, both colour spaces and cutoffs, OBB or AABB, any model transform.

:func:`project_splats` launches it wherever :func:`fused_projection_applies`,
a rule on what the input shows (device, grad state, mode, cloud class).
Where grad is carried, a ``Gaussian3dCloud`` under ``GAUSSIAN_3D`` in COLOR
on the card (:func:`trained_projection_applies`) takes
:class:`ProjectCore`, a kernel each way: the forward the same arithmetic up
to the colour, the backward hand-derived (its twin in PyTorch is
:func:`project_backward_plain`), with the colour stage
(``ops/cuda/sh.py`` ``sh_colour``) between them.  Everything else runs the
plain version, :func:`project_splats_plain` (the eager chain and
:func:`pack_raster_param_cols`): the CPU, the other rasterize modes, 2DGS
and 4DGS training and the precomputed-covariance cloud.
``ops/rasterize_tile.py`` ``project_for_binning`` is its one caller on a
frame.  ``project_gaussians`` itself, which the oracle calls, stays the
eager chain.  The counter ``project.fused`` (``utils/trace.py``) counts
forward launches of either kernel.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import torch
from torch.autograd.function import once_differentiable

from bevy_gaussian_splatting_tpu_torch.models.cloud import (
    Gaussian3dCloud,
    Gaussian4dCloud,
    sh_coeff_width,
    sh_degree_from_width,
)
from bevy_gaussian_splatting_tpu_torch.models.settings import (
    CloudSettings,
    DrawMode,
    GaussianColorSpace,
    GaussianMode,
    RasterizeMode,
)
from bevy_gaussian_splatting_tpu_torch.ops import covariance as cov_ops
from bevy_gaussian_splatting_tpu_torch.ops import sh as sh_ops
from bevy_gaussian_splatting_tpu_torch.ops import sort as sort_ops
from bevy_gaussian_splatting_tpu_torch.ops.cuda import build
from bevy_gaussian_splatting_tpu_torch.ops.cuda.sh import sh_colour
from bevy_gaussian_splatting_tpu_torch.ops.gaussian_2d import (
    surfel_affine_coeffs,
    surfel_depth_coeffs,
    surfel_view_normal,
)
from bevy_gaussian_splatting_tpu_torch.ops.project import (
    as_float32,
    local_view_direction,
    project_gaussians,
    time_tensor,
)
from bevy_gaussian_splatting_tpu_torch.ops.transforms import apply_transform
from bevy_gaussian_splatting_tpu_torch.utils import trace

_ARGTYPES = (
    [ctypes.c_void_p] * 5
    + [ctypes.c_int] * 6
    + [ctypes.c_void_p] * 7
    + [ctypes.c_float] * 4
    + [ctypes.c_int] * 2
    + [ctypes.c_void_p] * 7
)
_TRAIN_ARGTYPES = (
    [ctypes.c_void_p] * 3
    + [ctypes.c_int] * 4
    + [ctypes.c_void_p] * 6
    + [ctypes.c_float] * 2
    + [ctypes.c_int] * 2
    + [ctypes.c_void_p] * 9
)
_BACKWARD_ARGTYPES = (
    [ctypes.c_void_p] * 5
    + [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    + [ctypes.c_int] * 3
    + [ctypes.c_void_p] * 6
    + [ctypes.c_float] * 2
    + [ctypes.c_int] * 2
    + [ctypes.c_void_p] * 4
)

# csrc/project.cu's flags
_ADAPTIVE, _SRGB, _SELECTED, _HIGHLIGHT = 1, 2, 4, 8
# the cloud class each gaussian mode the kernel takes renders
_CLOUDS = {
    GaussianMode.GAUSSIAN_3D: Gaussian3dCloud,
    GaussianMode.GAUSSIAN_2D: Gaussian3dCloud,
    GaussianMode.GAUSSIAN_4D: Gaussian4dCloud,
}
_SURFEL_KIND = 5  # csrc/project.cu's kind of a surfel cloud with SH degree 0


def fused_projection_applies(cloud, settings: CloudSettings, *tensors) -> bool:
    """Whether the serving projection of ``cloud`` under ``settings`` takes
    the kernel: the cloud lies on the card, none of its tensors (nor any of
    ``tensors``, such as a model transform or a time) requires grad while
    grad is enabled, the rasterize mode is COLOR, and the cloud's class is
    the one its gaussian mode renders (``GAUSSIAN_3D`` and ``GAUSSIAN_2D`` a
    ``Gaussian3dCloud``, ``GAUSSIAN_4D`` a ``Gaussian4dCloud``)."""
    if cloud.device.type != "cuda" or type(cloud) is not _CLOUDS.get(settings.gaussian_mode):
        return False
    if settings.rasterize_mode != RasterizeMode.COLOR:
        return False
    if torch.is_grad_enabled():
        fields = [getattr(cloud, f.name) for f in dataclasses.fields(cloud)]
        return not any(isinstance(t, torch.Tensor) and t.requires_grad for t in (*fields, *tensors))
    return True


def trained_projection_applies(cloud, settings: CloudSettings, model_transform=None) -> bool:
    """Whether a projection that carries grad takes :class:`ProjectCore`:
    the cloud lies on the card, grad is enabled and a field of the cloud
    requires it, the cloud is a ``Gaussian3dCloud`` under ``GAUSSIAN_3D`` in
    COLOR, and the model transform needs no grad.  2DGS, 4DGS, the
    precomputed-covariance cloud, the other modes and the CPU keep the
    eager chain."""
    if cloud.device.type != "cuda" or not torch.is_grad_enabled() or type(cloud) is not Gaussian3dCloud:
        return False
    if settings.gaussian_mode != GaussianMode.GAUSSIAN_3D or settings.rasterize_mode != RasterizeMode.COLOR:
        return False
    if not any(getattr(cloud, f.name).requires_grad for f in dataclasses.fields(cloud)):
        return False
    return not (isinstance(model_transform, torch.Tensor) and model_transform.requires_grad)


def _extent_keys(settings: CloudSettings) -> tuple:
    """The names of the binning's extent fields under ``settings``."""
    if settings.gaussian_mode == GaussianMode.GAUSSIAN_2D:
        return ("surfel_radius",)
    return ("radius_vp",) if settings.aabb else ("obb_axis", "obb_bounds")


def pack_raster_param_cols(splats: dict, settings: CloudSettings, width: int, height: int) -> list:
    """The eager chain's per-splat compositor parameters as a list of
    columns, in the kernel's order (the JAX package's
    ``ops/rasterize_tile.py:812-858``): ``[cx_vp,
    cy_vp, e1x, e1y, b1, b2, r, g, b, alpha]`` for OBB, ``[cx_vp, cy_vp,
    conic.x, conic.y, conic.z, radius_vp, r, g, b, alpha]`` for AABB, and
    for 2DGS the slim surfel ``[cx_ndc, cy_ndc, surfel_radius, A.xyz, B.xyz,
    C.xyz, r, g, b, alpha]`` with the homography folded into q = dxn A + dyn
    B + C (``gaussian_2d.surfel_affine_coeffs``); the 2DGS centre stays in
    NDC.  The kernel writes the same rows."""
    rgb = splats["rgb"]
    alpha = splats["alpha"] * splats["mask"].to(torch.float32)
    if settings.gaussian_mode == GaussianMode.GAUSSIAN_2D:
        A, B, C = surfel_affine_coeffs(splats["surfel_t"], splats["mean_2d"], width)
        cols = [splats["center_ndc"][:, 0], splats["center_ndc"][:, 1], splats["surfel_radius"]]
        cols += [v[:, k] for v in (A, B, C) for k in range(3)]
    else:
        cols = [splats["center_ndc"][:, 0] * width, splats["center_ndc"][:, 1] * height]
        if settings.aabb:
            conic = splats["conic"]
            cols += [conic[:, 0], conic[:, 1], conic[:, 2], splats["radius_vp"]]
        else:
            e1 = splats["obb_axis"]
            b = splats["obb_bounds"]
            cols += [e1[:, 0], e1[:, 1], b[:, 0], b[:, 1]]
    return cols + [rgb[:, 0], rgb[:, 1], rgb[:, 2], alpha]


def _size(camera, size) -> tuple:
    return (camera.width, camera.height) if size is None else tuple(int(v) for v in size)


def surface_cols(cloud, camera, splats: dict, model_transform=None, width: Optional[int] = None) -> list:
    """The seven columns that 2DGS training with the surface maps packs
    after the 16 (``tile_fwd.SURFACE_COLS``): a fragment's depth
    coefficients with the scales factored out (``gaussian_2d.
    surfel_depth_coeffs``: det T0, A0.z, B0.z, C0.z, folded for an image
    ``width`` wide, default the camera's), and the surfel's camera-facing
    unit normal in view space (``gaussian_2d.surfel_view_normal``)."""
    cloud = as_float32(cloud)
    with trace.span("gs.project.surfel"):
        if model_transform is None:
            model_transform = torch.eye(4, dtype=torch.float32, device=cloud.device)
        world_pos = apply_transform(model_transform, cloud.position)
        depth = surfel_depth_coeffs(world_pos, cloud.rotation, model_transform, camera.clip_from_world,
                                    camera.clip_from_view, camera.viewport[2:], splats["mean_2d"],
                                    camera.width if width is None else width)
        n = surfel_view_normal(cloud.rotation, world_pos, model_transform, camera.view_from_world)
    return [depth[:, k] for k in range(4)] + [n[:, k] for k in range(3)]


def project_splats_plain(cloud, camera, settings: CloudSettings, model_transform=None, time=None, size=None,
                         depth_minmax=None, surface: bool = False) -> dict:
    """Plain PyTorch version, differentiable by autograd: the eager chain
    (``project_gaussians``, whose span the caller's replaces) with the
    DEPTH ramp's range ``depth_minmax``, the radix key's sentinel cull
    folded into ``mask`` and the rows stacked from
    :func:`pack_raster_param_cols` at ``size`` (default the camera's);
    ``surface`` (2DGS) appends :func:`surface_cols`."""
    splats = project_gaussians.__wrapped__(
        cloud, camera, settings, model_transform, depth_minmax=depth_minmax, time=time
    )
    splats["mask"] = splats["mask"] & (splats["sort_key"] != sort_ops.SENTINEL_KEY)
    width, height = _size(camera, size)
    cols = pack_raster_param_cols(splats, settings, width, height)
    if surface:
        cols += surface_cols(cloud, camera, splats, model_transform, width)
    params = torch.stack(cols, dim=-1)
    keys = ("mask", "center_ndc", "sort_key") + _extent_keys(settings)
    return {"params": params, **{k: splats[k] for k in keys}}


def _ready(t: torch.Tensor, dev: torch.device, name: str) -> torch.Tensor:
    """``t`` as the kernel reads it: float32, contiguous, 16-byte aligned, on
    ``dev`` (another device raises: a copy would wait for the card)."""
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, the cloud on {dev}")
    t = t.to(torch.float32).contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _flags(settings: CloudSettings) -> int:
    flags = _ADAPTIVE if settings.opacity_adaptive_radius else 0
    if settings.color_space == GaussianColorSpace.SRGB_REC709_DISPLAY:
        flags |= _SRGB
    if settings.draw_mode == DrawMode.SELECTED:
        flags |= _SELECTED
    elif settings.draw_mode == DrawMode.HIGHLIGHT_SELECTED:
        flags |= _HIGHLIGHT
    return flags


def _frame(camera, model_transform, dev) -> list:
    """The kernels' per-frame tensors: the model transform (None for the
    identity), view_from_world, clip_from_view, clip_from_world, the
    camera's position and the viewport."""
    return [
        None if model_transform is None else _ready(model_transform, dev, "model_transform"),
        _ready(camera.view_from_world, dev, "camera"),
        _ready(camera.clip_from_view, dev, "camera"),
        _ready(camera.clip_from_world, dev, "camera"),
        _ready(camera.world_position, dev, "camera"),
        _ready(camera.viewport, dev, "camera"),
    ]


def _ptr(t):
    return None if t is None else t.data_ptr()


def _fn(name: str, argtypes):
    fn = getattr(build.load("project"), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def project_splats(cloud, camera, settings: CloudSettings, model_transform=None, time=None, size=None,
                   depth_minmax=None, surface: bool = False) -> dict:
    """Project ``cloud`` for binning and compositing -> dict: ``mask`` [N]
    bool (the sentinel cull folded in), ``center_ndc`` [N, 2], ``sort_key``
    [N] int64, ``obb_axis`` and ``obb_bounds`` [N, 2] (OBB), ``radius_vp``
    [N] (AABB) or ``surfel_radius`` [N] (2DGS), and ``params`` [N, 10] (2DGS
    [N, 16]), the compositor's rows for an image of ``size`` (default the
    camera's).

    ``time`` (a number or a float32 scalar tensor, default ``settings.time``)
    is the 4DGS frame time: a number is passed by value, a tensor read on
    the card; ``depth_minmax`` the DEPTH ramp's range.  The kernel runs where
    :func:`fused_projection_applies` (it propagates no grad),
    :func:`project_splats_trained` where :func:`trained_projection_applies`,
    the plain version everywhere else.  ``surface`` (2DGS training with the
    surface maps) takes the plain version, whose rows gain the six
    :func:`surface_cols`."""
    if surface:
        if settings.gaussian_mode != GaussianMode.GAUSSIAN_2D:
            raise ValueError("the surface columns are 2DGS's: settings.gaussian_mode must be GAUSSIAN_2D")
        return project_splats_plain(cloud, camera, settings, model_transform, time, size, depth_minmax, True)
    if not fused_projection_applies(cloud, settings, model_transform, time):
        if trained_projection_applies(cloud, settings, model_transform):
            return project_splats_trained(cloud, camera, settings, model_transform, size)
        return project_splats_plain(cloud, camera, settings, model_transform, time, size, depth_minmax)
    cloud = as_float32(cloud)
    dev = cloud.device
    n = len(cloud)
    is_4d = settings.gaussian_mode == GaussianMode.GAUSSIAN_4D
    surfel = settings.gaussian_mode == GaussianMode.GAUSSIAN_2D
    rot = cloud.isotropic_rotations if is_4d else cloud.rotation
    sh = cloud.spherindrical_harmonic if is_4d else cloud.spherical_harmonic
    kind = 4 if is_4d else (_SURFEL_KIND if surfel else 0) + min(sh_degree_from_width(sh.shape[1]), 3)
    inputs = [_ready(t, dev, "cloud") for t in (cloud.position_visibility, rot, cloud.scale_opacity, sh)]
    inputs.append(_ready(cloud.timestamp_timescale, dev, "cloud") if is_4d else None)
    frame = _frame(camera, model_transform, dev)
    time_value = 0.0
    time_ptr = None
    if is_4d:
        if time is None:
            time = settings.time
        if isinstance(time, torch.Tensor):
            time_ptr = time_tensor(time, settings, dev).reshape(()).contiguous()
        else:
            time_value = float(time)
    aabb = settings.aabb and not surfel
    width, height = _size(camera, size)
    params = torch.empty((n, 16 if surfel else 10), dtype=torch.float32, device=dev)
    center = torch.empty((n, 2), dtype=torch.float32, device=dev)
    axis = None if aabb or surfel else torch.empty((n, 2), dtype=torch.float32, device=dev)
    bounds = torch.empty((n,) if aabb or surfel else (n, 2), dtype=torch.float32, device=dev)
    mask = torch.empty((n,), dtype=torch.bool, device=dev)
    key = torch.empty((n,), dtype=torch.int64, device=dev)

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = _fn("bgs_project", _ARGTYPES)(
            *map(_ptr, inputs), n, sh.shape[1], kind, int(aabb), _flags(settings),
            settings.radix_sort_depth_bits.bits, *map(_ptr, frame), _ptr(time_ptr), time_value,
            settings.time_stop - settings.time_start, settings.global_scale, settings.global_opacity,
            width, height, params.data_ptr(), center.data_ptr(), _ptr(axis), bounds.data_ptr(),
            mask.data_ptr(), key.data_ptr(), stream,
        )
    build.check(status, "project_splats")
    if n > 0:
        trace.count("project.fused")
    extents = dict(zip(_extent_keys(settings), (bounds,) if aabb or surfel else (axis, bounds)))
    return {"params": params, "mask": mask, "center_ndc": center, "sort_key": key, **extents}



# --- training: a Gaussian3dCloud in GAUSSIAN_3D, COLOR ----------------------


def _model(model_transform, like: torch.Tensor) -> torch.Tensor:
    if model_transform is None:
        return torch.eye(4, dtype=like.dtype, device=like.device)
    return model_transform.to(like.dtype)


def project_train_plain(pos_vis, rot, scale_op, camera, settings: CloudSettings, model_transform, width: int,
                        height: int) -> tuple:
    """Plain forward of :class:`ProjectCore`: the eager chain
    (:func:`project_splats_plain`, whose rows give the geometric columns
    and alpha; its colour, which reads no SH in DEPTH mode over a fixed
    range, is dropped) and the colour's direction (``ops/project.py``
    ``local_view_direction``) -> (geom [N, 6], alpha [N, 1], dir [N, 3],
    the binning's fields)."""
    n = pos_vis.shape[0]
    cloud = Gaussian3dCloud(pos_vis, pos_vis.new_zeros((n, sh_coeff_width(0))), rot, scale_op)
    model = _model(model_transform, pos_vis)
    fields = project_splats_plain(cloud, camera, settings.replace(rasterize_mode=RasterizeMode.DEPTH), model,
                                  size=(width, height), depth_minmax=(1.0, 2.0))
    params = fields.pop("params")
    diff = apply_transform(model, pos_vis[:, :3]) - camera.world_position
    direction = local_view_direction(diff, sort_ops.squared_distance(diff), model)
    return params[:, :6].contiguous(), params[:, 9:].contiguous(), direction, fields


def _safe_sqrt_vjp(x, g):
    """d ``safe_sqrt(x)`` at the cotangent g as autograd takes it: g / (2
    sqrt(x)) where x >= 1e-12, else 0."""
    return torch.where(x >= 1e-12, g / (torch.sqrt(x) * 2.0), torch.zeros_like(x))


def _bounds_vjp(sxx, sxy, syy, cutoff, g, aabb: bool):
    """(d_sxx, d_sxy, d_syy, d_cutoff) from the bounds' cotangent g (four
    columns): ``csrc/project.cu`` cov2d_bounds_vjp."""
    zero = torch.zeros_like(sxx)
    det = sxx * syy - sxy * sxy
    mid = (sxx + syy) * 0.5
    disc = mid * mid - det
    term = cov_ops.safe_sqrt(disc)
    lambda1 = mid + term
    if aabb:
        det_inv = 1.0 / det
        d_inv = (g[0] * syy + g[1] * -sxy) + g[2] * sxx
        d_syy = g[0] * det_inv
        d_sxy = -(g[1] * det_inv)
        d_sxx = g[2] * det_inv
        d_det = -d_inv * (det_inv * det_inv)
        low = mid - term
        lambda2 = torch.clamp(low, min=0.0)
        r1, r2 = cov_ops.safe_sqrt(lambda1), cov_ops.safe_sqrt(lambda2)
        d_cutoff = g[3] * torch.maximum(r1, r2)
        d_r = g[3] * cutoff
        tie = r1 == r2
        d_r1 = torch.where(tie, d_r * 0.5, torch.where(r1 < r2, zero, d_r))
        d_r2 = torch.where(tie, d_r * 0.5, torch.where(r1 > r2, zero, d_r))
        d_l1 = _safe_sqrt_vjp(lambda1, d_r1)
        d_l2 = torch.where(low >= 0.0, _safe_sqrt_vjp(lambda2, d_r2), zero)
        d_mid, d_term = d_l1 + d_l2, d_l1 - d_l2
    else:
        d = sxx - syy
        bq = d * d + (sxy * 4.0) * sxy
        b = cov_ops.safe_sqrt(bq)
        qa, qb = ((sxx + syy) + b) * 0.5, ((sxx + syy) - b) * 0.5
        d_cutoff = g[2] * cov_ops.safe_sqrt(qa) + g[3] * cov_ops.safe_sqrt(qb)
        d_qa, d_qb = _safe_sqrt_vjp(qa, g[2] * cutoff), _safe_sqrt_vjp(qb, g[3] * cutoff)
        d_sum = (d_qa + d_qb) * 0.5
        d_bq = _safe_sqrt_vjp(bq, (d_qa - d_qb) * 0.5)
        d_sxx = d_sum + d_bq * (d * 2.0)
        d_syy = d_sum - d_bq * (d * 2.0)
        d_sxy = d_bq * (sxy * 8.0)
        e0, e1 = -sxy, lambda1 - sxx
        sq = e0 * e0 + e1 * e1
        norm = torch.where(sq > 0.0, torch.sqrt(torch.where(sq > 0.0, sq, torch.ones_like(sq))), zero)
        unit = norm > 1e-12
        safe = torch.where(unit, norm, torch.ones_like(norm))
        d_norm = -(g[0] * ((e0 / safe) / safe) + g[1] * ((e1 / safe) / safe))
        d_sq = d_norm / (safe * 2.0)
        d_e0 = torch.where(unit, g[0] / safe + d_sq * (e0 * 2.0), zero)
        d_e1 = torch.where(unit, g[1] / safe + d_sq * (e1 * 2.0), zero)
        d_sxy = d_sxy - d_e0
        d_sxx = d_sxx - d_e1
        d_mid = d_term = d_e1
        d_det = zero
    d_disc = _safe_sqrt_vjp(disc, d_term)
    d_mid = d_mid + d_disc * (mid * 2.0)
    d_det = d_det - d_disc
    return ((d_sxx + d_mid * 0.5) + d_det * syy, d_sxy - d_det * (sxy * 2.0), (d_syy + d_mid * 0.5) + d_det * sxx,
            d_cutoff)


def project_backward_plain(pos_vis, rot, scale_op, mask, g_geom, g_alpha, g_dir, camera, settings: CloudSettings,
                           model_transform, width: int, height: int) -> tuple:
    """Plain backward of :class:`ProjectCore`, the twin of ``csrc/project.cu``
    project_bwd_kernel, term for term: the cotangents of geom [N, 6], alpha
    [N, 1] and dir [N, 3] (each None for zeros) -> the gradients of
    position_visibility, rotation and scale_opacity, [N, 4] each, in the
    inputs' dtype.  Through the clip projection, the EWA Jacobian at the
    view-space mean, ``cov2d`` with its dilation, ``obb_axes``'s closed-form
    2x2 eigen-decomposition (or the conic and radius), the opacity cutoff,
    ``compute_cov3d`` from the unnormalised quaternion and the scale,
    alpha, and the colour's direction."""
    n, dt = pos_vis.shape[0], pos_vis.dtype
    zero = pos_vis.new_zeros(n)
    g = [zero] * 6 if g_geom is None else list(g_geom.to(dt).unbind(-1))
    model = _model(model_transform, pos_vis)
    T = model[:3, :3]
    view = camera.view_from_world.to(dt)
    rv = view[:3, :3]
    clip = camera.clip_from_world.to(dt)
    world = apply_transform(model, pos_vis[:, :3])
    w = world.unbind(-1)

    # the centre: cx_vp = hom_x / wd * width, cy_vp = hom_y / wd * height
    wd = (world @ clip[3, :3] + clip[3, 3]) + 1e-9
    hom = world @ clip[:2, :3].T + clip[:2, 3]
    d_ndc = (g[0] * width, g[1] * height)
    d_hom = [d_ndc[r] / wd for r in range(2)]
    d_wd = -(d_ndc[0] * ((hom[:, 0] / wd) / wd)) - d_ndc[1] * ((hom[:, 1] / wd) / wd)
    d_world = [(d_hom[0] * clip[0, k] + d_hom[1] * clip[1, k]) + d_wd * clip[3, k] for k in range(3)]

    # the bounds and the 2D covariance (csrc/project.cu ewa)
    opacity = scale_op[:, 3]
    cutoff = cov_ops.opacity_cutoff(opacity, settings.opacity_adaptive_radius)
    cov = cov_ops.compute_cov3d(rot, scale_op[:, :3], settings.global_scale, model).unbind(-1)
    t = world @ rv.T + view[:3, 3]
    tx, ty, tz = t.unbind(-1)
    fx = camera.clip_from_view[0, 0].to(dt) * camera.viewport[2].to(dt)
    fy = camera.clip_from_view[1, 1].to(dt) * camera.viewport[3].to(dt)
    s = 1.0 / (tz * tz)
    j00, j11 = fx / tz, -fy / tz
    j20, j21 = (-fx * tx) * s, (fy * ty) * s
    T0 = [rv[0, k] * j00 + rv[2, k] * j20 for k in range(3)]
    T1 = [rv[1, k] * j11 + rv[2, k] * j21 for k in range(3)]

    def vrk(v):
        c = cov
        return [(c[0] * v[0] + c[1] * v[1]) + c[2] * v[2], (c[1] * v[0] + c[3] * v[1]) + c[4] * v[2],
                (c[2] * v[0] + c[4] * v[1]) + c[5] * v[2]]

    def dot(a, b):
        return ((0.0 + a[0] * b[0]) + a[2] * b[2]) + (0.0 + a[1] * b[1])

    vT0, vT1 = vrk(T0), vrk(T1)
    sxx, sxy, syy = dot(T0, vT0) + 0.3, dot(T1, vT0), dot(T1, vT1) + 0.3
    c2d = _bounds_vjp(sxx, sxy, syy, cutoff, g[2:], settings.aabb)
    d_cutoff = c2d[3]

    # cov2d's derivative (csrc/project.cu ewa_vjp)
    dv0 = [c2d[0] * T0[k] + c2d[1] * T1[k] for k in range(3)]
    dv1 = [c2d[2] * T1[k] for k in range(3)]
    dT0 = [c2d[0] * vT0[k] for k in range(3)]
    dT1 = [c2d[1] * vT0[k] + c2d[2] * vT1[k] for k in range(3)]
    d_c = [zero] * 6
    for v, dv, dT in ((T0, dv0, dT0), (T1, dv1, dT1)):
        back = vrk(dv)
        for k in range(3):
            dT[k] = dT[k] + back[k]
        d_c = [d_c[0] + dv[0] * v[0], d_c[1] + (dv[0] * v[1] + dv[1] * v[0]), d_c[2] + (dv[0] * v[2] + dv[2] * v[0]),
               d_c[3] + dv[1] * v[1], d_c[4] + (dv[1] * v[2] + dv[2] * v[1]), d_c[5] + dv[2] * v[2]]
    d_j00 = sum((dT0[k] * rv[0, k] for k in range(3)), zero)
    d_j20 = sum((dT0[k] * rv[2, k] for k in range(3)), zero)
    d_j11 = sum((dT1[k] * rv[1, k] for k in range(3)), zero)
    d_j21 = sum((dT1[k] * rv[2, k] for k in range(3)), zero)
    d_s = d_j20 * (-fx * tx) + d_j21 * (fy * ty)
    d_t = [(d_j20 * s) * -fx, (d_j21 * s) * fy,
           (-d_j00 * (j00 / tz) - d_j11 * (j11 / tz)) + (-d_s * (s * s)) * (tz * 2.0)]
    d_world = [d_world[k] + ((rv[0, k] * d_t[0] + rv[1, k] * d_t[1]) + rv[2, k] * d_t[2]) for k in range(3)]

    # compute_cov3d's derivative (csrc/project.cu cov3d_vjp)
    G = torch.stack([torch.stack([d_c[0], d_c[1] * 0.5, d_c[2] * 0.5], -1),
                     torch.stack([d_c[1] * 0.5, d_c[3], d_c[4] * 0.5], -1),
                     torch.stack([d_c[2] * 0.5, d_c[4] * 0.5, d_c[5]], -1)], -2)
    H = T.T @ G @ T
    R = cov_ops.quat_to_rotation_matrix(rot)
    sg = scale_op[:, :3] * settings.global_scale
    HR = torch.einsum("nkl,nml->nmk", H, R)  # HR[m] = H R_m^T
    d_s2 = (R * HR).sum(-1)
    d_scale = (d_s2 * (sg * 2.0)) * settings.global_scale
    dR = ((sg * sg) * 2.0)[..., None] * HR
    r, x, y, z = rot.unbind(-1)
    d = dR.reshape(n, 9).unbind(-1)  # d[3 m + k] = dR[m][k]
    d_rot = torch.stack([
        (z * d[1] - y * d[2]) + (-z * d[3] + x * d[5]) + (y * d[6] - x * d[7]),
        (y * d[1] + z * d[2]) + (y * d[3] - (x * 2.0) * d[4] + r * d[5]) + (z * d[6] - r * d[7] - (x * 2.0) * d[8]),
        (-(y * 2.0) * d[0] + x * d[1] - r * d[2]) + (x * d[3] + z * d[5]) + (r * d[6] + z * d[7] - (y * 2.0) * d[8]),
        (-(z * 2.0) * d[0] + r * d[1] + x * d[2]) + (-r * d[3] - (z * 2.0) * d[4] + y * d[5]) + (x * d[6] + y * d[7]),
    ], -1) * 2.0

    # the colour's direction
    if g_dir is not None:
        gu = g_dir.to(dt).unbind(-1)
        diff = world - camera.world_position.to(dt)
        dist2 = sort_ops.squared_distance(diff)
        len_raw = torch.sqrt(dist2)
        length = torch.clamp(len_raw, min=1e-12)
        ray = diff / length[:, None]
        basis = torch.stack([v / torch.sqrt(torch.sum(v * v)) for v in T.unbind(-1)])  # rows: unit columns of T
        local = (ray @ basis.T).unbind(-1)
        lnorm = torch.sqrt(dot(local, local))
        d_lnorm = -sum((gu[k] * ((local[k] / lnorm) / lnorm) for k in range(3)), zero)
        d_l2 = d_lnorm / (lnorm * 2.0)
        d_ray = sum(((gu[k] / lnorm + d_l2 * (local[k] * 2.0))[:, None] * basis[k] for k in range(3)),
                    torch.zeros_like(ray))
        d_len = -sum((d_ray[:, j] * (ray[:, j] / length) for j in range(3)), zero)
        d_dist2 = torch.where(len_raw >= 1e-12, d_len / (len_raw * 2.0), zero)
        d_world = [d_world[j] + (d_ray[:, j] / length + d_dist2 * (diff[:, j] * 2.0)) for j in range(3)]
    d_pos = torch.stack(d_world, -1) @ T

    # the opacity: alpha, and the adaptive cutoff
    d_o = zero if g_alpha is None else (g_alpha.to(dt).reshape(n) * mask.to(dt)) * settings.global_opacity
    if settings.draw_mode == DrawMode.HIGHLIGHT_SELECTED:
        d_o = torch.where(pos_vis[:, 3] > 0.5, zero, d_o)
    if settings.opacity_adaptive_radius:
        oc = torch.clamp(opacity, min=1e-8)
        inner = 9.0 + torch.log(oc) * 2.0
        d_inner = torch.where(inner >= 1e-6, d_cutoff / (cutoff * 2.0), zero)
        d_o = d_o + torch.where(opacity >= 1e-8, (d_inner * 2.0) / oc, zero)
    return (torch.cat([d_pos, zero[:, None]], -1), d_rot, torch.cat([d_scale, d_o[:, None]], -1))


def _rows(t: Optional[torch.Tensor], cols: int) -> tuple:
    """A cotangent [N, cols] as the backward kernel reads it -> (tensor or
    None, row stride): float32 rows of ``cols`` contiguous floats, such as
    a view of the packed rows' cotangent, as they are, else a copy."""
    if t is None:
        return None, cols
    if t.dtype != torch.float32 or (cols > 1 and t.stride(1) != 1) or t.stride(0) < cols:
        t = t.to(torch.float32).contiguous()
    return t, t.stride(0)


def _train_kernel(pos_vis, rot, scale_op, camera, settings: CloudSettings, model_transform, width: int,
                  height: int) -> tuple:
    """:class:`ProjectCore`'s forward by ``csrc/project.cu``'s
    project_train_kernel: CUDA tensors."""
    dev = pos_vis.device
    inputs = [_ready(t, dev, "cloud") for t in (pos_vis, rot, scale_op)]
    frame = _frame(camera, model_transform, dev)
    n = pos_vis.shape[0]
    aabb = settings.aabb

    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)

    geom, alpha, direction, center = empty(n, 6), empty(n, 1), empty(n, 3), empty(n, 2)
    axis = None if aabb else empty(n, 2)
    bounds = empty(n) if aabb else empty(n, 2)
    mask, key = empty(n, dtype=torch.bool), empty(n, dtype=torch.int64)
    with torch.cuda.device(dev):
        status = _fn("bgs_project_train", _TRAIN_ARGTYPES)(
            *map(_ptr, inputs), n, int(aabb), _flags(settings), settings.radix_sort_depth_bits.bits,
            *map(_ptr, frame), settings.global_scale, settings.global_opacity, width, height,
            geom.data_ptr(), alpha.data_ptr(), direction.data_ptr(), center.data_ptr(), _ptr(axis),
            bounds.data_ptr(), mask.data_ptr(), key.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        )
    build.check(status, "project_splats_trained forward")
    if n > 0:
        trace.count("project.fused")
    extents = (bounds,) if aabb else (axis, bounds)
    return geom, alpha, direction, {"mask": mask, "center_ndc": center, "sort_key": key,
                                    **dict(zip(_extent_keys(settings), extents))}


def _backward_kernel(pos_vis, rot, scale_op, mask, g_geom, g_alpha, g_dir, camera, settings: CloudSettings,
                     model_transform, width: int, height: int) -> tuple:
    """:class:`ProjectCore`'s backward by ``csrc/project.cu``'s
    project_bwd_kernel: CUDA tensors."""
    dev = pos_vis.device
    inputs = [_ready(t, dev, "cloud") for t in (pos_vis, rot, scale_op)]
    g_geom, geom_stride = _rows(g_geom, 6)
    g_alpha, alpha_stride = _rows(g_alpha, 1)
    g_dir = None if g_dir is None else g_dir.to(torch.float32).contiguous()
    frame = _frame(camera, model_transform, dev)
    n = pos_vis.shape[0]
    grads = [torch.empty((n, 4), dtype=torch.float32, device=dev) for _ in range(3)]
    with torch.cuda.device(dev):
        status = _fn("bgs_project_backward", _BACKWARD_ARGTYPES)(
            *map(_ptr, inputs), mask.data_ptr(), _ptr(g_geom), geom_stride, _ptr(g_alpha), alpha_stride,
            _ptr(g_dir), n, int(settings.aabb), _flags(settings), *map(_ptr, frame), settings.global_scale,
            settings.global_opacity, width, height, *map(_ptr, grads), torch.cuda.current_stream(dev).cuda_stream,
        )
    build.check(status, "project_splats_trained backward")
    return tuple(grads)


class ProjectCore(torch.autograd.Function):
    """The training projection's geometry: position_visibility, rotation and
    scale_opacity [N, 4] each -> (geom [N, 6], alpha [N, 1], dir [N, 3],
    mask, center_ndc, sort_key, then ``obb_axis`` and ``obb_bounds`` or
    ``radius_vp``), the last ones without grad.  A kernel each way on the
    card, the plain versions (:func:`project_train_plain`,
    :func:`project_backward_plain`) on the CPU."""

    @staticmethod
    def forward(ctx, pos_vis, rot, scale_op, camera, settings, model_transform, width, height):
        args = (camera, settings, model_transform, width, height)
        if pos_vis.device.type == "cuda":
            geom, alpha, direction, fields = _train_kernel(pos_vis, rot, scale_op, *args)
        else:
            geom, alpha, direction, fields = project_train_plain(pos_vis, rot, scale_op, *args)
        extents = [fields[k] for k in _extent_keys(settings)]
        ctx.save_for_backward(pos_vis, rot, scale_op, fields["mask"])
        ctx.args = args
        ctx.set_materialize_grads(False)
        ctx.mark_non_differentiable(fields["mask"], fields["center_ndc"], fields["sort_key"], *extents)
        return (geom, alpha, direction, fields["mask"], fields["center_ndc"], fields["sort_key"], *extents)

    @staticmethod
    @once_differentiable
    def backward(ctx, g_geom, g_alpha, g_dir, *_):
        pos_vis, rot, scale_op, mask = ctx.saved_tensors
        with trace.span("gs.project.bwd"):
            run = _backward_kernel if pos_vis.device.type == "cuda" else project_backward_plain
            grads = run(pos_vis, rot, scale_op, mask, g_geom, g_alpha, g_dir, *ctx.args)
        need = ctx.needs_input_grad
        return tuple(d if need[k] else None for k, d in enumerate(grads)) + (None,) * 5


def project_splats_trained(cloud, camera, settings: CloudSettings, model_transform=None, size=None) -> dict:
    """The training projection of a ``Gaussian3dCloud`` in ``GAUSSIAN_3D``,
    COLOR: :class:`ProjectCore`'s geometry, the colour stage
    (``sh_colour``, then the colour space and the highlight, as
    ``project_gaussians``) along its direction, the rows packed by one
    ``cat`` -> :func:`project_splats`'s dict, the eager chain's bits."""
    cloud = as_float32(cloud)
    width, height = _size(camera, size)
    geom, alpha, direction, mask, center, key, *extents = ProjectCore.apply(
        cloud.position_visibility, cloud.rotation, cloud.scale_opacity, camera, settings, model_transform, width,
        height,
    )
    with trace.span("gs.project.sh"):
        trace.count("sh.calls")
        rgb = sh_colour(direction, cloud.spherical_harmonic)
        if settings.color_space == GaussianColorSpace.SRGB_REC709_DISPLAY:
            rgb = sh_ops.srgb_to_linear(rgb)
    if settings.draw_mode == DrawMode.HIGHLIGHT_SELECTED:
        highlight = torch.tensor([0.3, 1.0, 0.1], dtype=rgb.dtype, device=rgb.device)
        rgb = torch.where((cloud.visibility > 0.5)[..., None], highlight, rgb)
    params = torch.cat([geom, rgb, alpha], dim=1)
    return {"params": params, "mask": mask, "center_ndc": center, "sort_key": key,
            **dict(zip(_extent_keys(settings), extents))}
