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
a rule on what the input shows (device, grad state, mode, cloud class), and
runs the plain version, :func:`project_splats_plain` (the eager chain and
:func:`pack_raster_param_cols`), everywhere else: the CPU, training, the
other rasterize modes and the precomputed-covariance cloud.
``ops/rasterize_tile.py`` ``project_for_binning`` is its one caller on a
frame.  ``project_gaussians`` itself, which the oracle calls, stays the
eager chain.  The counter ``project.fused`` (``utils/trace.py``) counts
kernel launches.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from bevy_gaussian_splatting_tpu_torch.models.cloud import Gaussian3dCloud, Gaussian4dCloud, sh_degree_from_width
from bevy_gaussian_splatting_tpu_torch.models.settings import (
    CloudSettings,
    DrawMode,
    GaussianColorSpace,
    GaussianMode,
    RasterizeMode,
)
from bevy_gaussian_splatting_tpu_torch.ops import sort as sort_ops
from bevy_gaussian_splatting_tpu_torch.ops.cuda import build
from bevy_gaussian_splatting_tpu_torch.ops.gaussian_2d import surfel_affine_coeffs
from bevy_gaussian_splatting_tpu_torch.ops.project import as_float32, project_gaussians, time_tensor
from bevy_gaussian_splatting_tpu_torch.utils import trace

_ARGTYPES = (
    [ctypes.c_void_p] * 5
    + [ctypes.c_int] * 6
    + [ctypes.c_void_p] * 7
    + [ctypes.c_float] * 4
    + [ctypes.c_int] * 2
    + [ctypes.c_void_p] * 7
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


def project_splats_plain(cloud, camera, settings: CloudSettings, model_transform=None, time=None, size=None,
                         depth_minmax=None) -> dict:
    """Plain PyTorch version, differentiable by autograd: the eager chain
    (``project_gaussians``, whose span the caller's replaces) with the
    DEPTH ramp's range ``depth_minmax``, the radix key's sentinel cull
    folded into ``mask`` and the rows stacked from
    :func:`pack_raster_param_cols` at ``size`` (default the camera's)."""
    splats = project_gaussians.__wrapped__(
        cloud, camera, settings, model_transform, depth_minmax=depth_minmax, time=time
    )
    splats["mask"] = splats["mask"] & (splats["sort_key"] != sort_ops.SENTINEL_KEY)
    params = torch.stack(pack_raster_param_cols(splats, settings, *_size(camera, size)), dim=-1)
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


def project_splats(cloud, camera, settings: CloudSettings, model_transform=None, time=None, size=None,
                   depth_minmax=None) -> dict:
    """Project ``cloud`` for binning and compositing -> dict: ``mask`` [N]
    bool (the sentinel cull folded in), ``center_ndc`` [N, 2], ``sort_key``
    [N] int64, ``obb_axis`` and ``obb_bounds`` [N, 2] (OBB), ``radius_vp``
    [N] (AABB) or ``surfel_radius`` [N] (2DGS), and ``params`` [N, 10] (2DGS
    [N, 16]), the compositor's rows for an image of ``size`` (default the
    camera's).

    ``time`` (a number or a float32 scalar tensor, default ``settings.time``)
    is the 4DGS frame time: a number is passed by value, a tensor read on
    the card; ``depth_minmax`` the DEPTH ramp's range.  The kernel runs where
    :func:`fused_projection_applies` (it propagates no grad), the plain
    version everywhere else."""
    if not fused_projection_applies(cloud, settings, model_transform, time):
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
    frame = [
        None if model_transform is None else _ready(model_transform, dev, "model_transform"),
        _ready(camera.view_from_world, dev, "camera"),
        _ready(camera.clip_from_view, dev, "camera"),
        _ready(camera.clip_from_world, dev, "camera"),
        _ready(camera.world_position, dev, "camera"),
        _ready(camera.viewport, dev, "camera"),
    ]
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

    def ptr(t):
        return None if t is None else t.data_ptr()

    fn = build.load("project").bgs_project
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = fn(
            *map(ptr, inputs), n, sh.shape[1], kind, int(aabb), _flags(settings),
            settings.radix_sort_depth_bits.bits, *map(ptr, frame), ptr(time_ptr), time_value,
            settings.time_stop - settings.time_start, settings.global_scale, settings.global_opacity,
            width, height, params.data_ptr(), center.data_ptr(), ptr(axis), bounds.data_ptr(),
            mask.data_ptr(), key.data_ptr(), stream,
        )
    build.check(status, "project_splats")
    if n > 0:
        trace.count("project.fused")
    extents = dict(zip(_extent_keys(settings), (bounds,) if aabb or surfel else (axis, bounds)))
    return {"params": params, "mask": mask, "center_ndc": center, "sort_key": key, **extents}

