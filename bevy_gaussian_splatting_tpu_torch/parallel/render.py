"""Sharded rendering and training over ranks of ``torch.distributed``.

The counterpart of the JAX package's ``parallel/render.py``, with its mesh
axes as process groups (:class:`Mesh`):

  - gaussians shard across the ``tiles`` axis and each rank projects its
    shard;
  - the projected rows are exchanged (an all-gather, or the bounded band
    exchange of ``parallel/exchange.py``) and each rank bins and composites
    only its own band of tile rows, in the full frame (band-windowed
    binning, kernels at the band's first pixel row ``y0``), so a band's
    pairs are exactly its slice of the one-rank frame's; the band's pairs
    keep their one-rank positions modulo the compositor's 128-pair
    alignment, and its chunk size is the one-rank frame's, so the early
    exits fall where that frame's do and the image is that frame's, bit
    for bit (the JAX package's sharded path anchors the chunk grid at the
    band's own positions);
  - an optional ``camera`` axis splits a batch of cameras.

Every rank of a mesh calls the same functions with the same arguments but
its own shard (:func:`shard_cloud`), as a shard_map body runs on every
device.  The collectives (JAX -> here): ``lax.all_gather`` ->
``all_gather_into_tensor`` in an autograd Function whose backward is an
equal-split ``all_to_all_single`` and a sum over sources in rank order (the
reduce-scatter that JAX derives, written with a collective both NCCL and
gloo have); ``lax.all_to_all`` -> ``all_to_all_single``; ``lax.psum`` ->
``all_reduce``; the replicated output -> an all-gather of the bands.  A
rank's tensors stay where the caller put them: the compositor follows the
device (the kernels on the card, their plain versions on the CPU), as in
``make_replay_pipeline``, so there is no ``compositor`` argument.

Training: :func:`make_train_step` renders, takes the band's term of the
loss, back-propagates through the exchange and steps Adam on the shard.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from bevy_gaussian_splatting_tpu_torch.models.camera import Camera
from bevy_gaussian_splatting_tpu_torch.models.cloud import pad_cloud
from bevy_gaussian_splatting_tpu_torch.models.settings import CloudSettings, GaussianMode
from bevy_gaussian_splatting_tpu_torch.ops import sort as sort_ops
from bevy_gaussian_splatting_tpu_torch.ops.cuda.core import composite_core
from bevy_gaussian_splatting_tpu_torch.ops.cuda.tile_fwd import composite_epilogue, preferred_chunk
from bevy_gaussian_splatting_tpu_torch.ops.rasterize_tile import (
    TILE,
    bin_gaussians,
    composite_tiles,
    kernel_mode,
    pairs_budget,
    project_for_binning,
    tile_budget,
    tile_ranges,
    tile_rects,
    tile_row_range,
)
from bevy_gaussian_splatting_tpu_torch.parallel.exchange import auto_exchange_plan, band_exchange, band_interval
from bevy_gaussian_splatting_tpu_torch.render.multi_camera import _unstack_cameras
from bevy_gaussian_splatting_tpu_torch.train.losses import gaussian_splatting_loss
from bevy_gaussian_splatting_tpu_torch.train.step import TrainableCloud, adam
from bevy_gaussian_splatting_tpu_torch.utils.trace import span

TILES_AXIS = "tiles"
CAMERA_AXIS = "camera"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Ranks laid out as [camera, tiles] (one camera row for a 1D mesh),
    with this rank's process group along each axis and over the whole
    mesh.  ``names`` are the axes a user sees: ``("tiles",)`` or
    ``("camera", "tiles")``."""

    ranks: np.ndarray  # [camera, tiles] global ranks
    names: tuple
    groups: dict  # axis name (or None: the whole mesh) -> ProcessGroup of this rank

    @property
    def shape(self) -> dict:
        sizes = {CAMERA_AXIS: self.ranks.shape[0], TILES_AXIS: self.ranks.shape[1]}
        return {name: sizes[name] for name in self.names}

    def get_group(self, name: Optional[str] = None):
        """This rank's group along axis ``name`` (None: the whole mesh)."""
        return self.groups[name]

    def get_local_rank(self, name: str) -> int:
        """This rank's index along axis ``name``."""
        where = np.argwhere(self.ranks == dist.get_rank())
        if not len(where):
            raise ValueError(f"rank {dist.get_rank()} is not in the mesh {self.ranks.tolist()}")
        return int(where[0][0 if name == CAMERA_AXIS else 1])


def mesh_from_grid(grid: np.ndarray, names: tuple) -> Mesh:
    """A mesh over the ranks of ``grid`` [camera, tiles].  Every rank of
    the world must call it (``dist.new_group`` is collective); ranks outside
    the grid get a mesh they are not in."""
    grid = np.asarray(grid, dtype=np.int64).reshape(-1, np.asarray(grid).shape[-1])
    me = dist.get_rank()
    groups = {}
    whole = dist.new_group(sorted(grid.reshape(-1).tolist()))
    groups[None] = whole if me in grid else None
    for row in grid:  # the tiles groups, one per camera row
        g = dist.new_group(row.tolist())
        if me in row:
            groups[TILES_AXIS] = g
    for col in grid.T:  # the camera groups, one per tiles column
        g = dist.new_group(col.tolist())
        if me in col:
            groups[CAMERA_AXIS] = g
    return Mesh(ranks=grid, names=names, groups=groups)


def make_mesh(n_devices: Optional[int] = None, camera_parallel: int = 1) -> Mesh:
    """The 1D tiles mesh over ranks 0 .. n_devices - 1 (default: the whole
    world), or the 2D (camera, tiles) mesh when ``camera_parallel`` > 1
    (rows of consecutive ranks; ranks past ``camera_parallel * tiles`` are
    left out, as the JAX package leaves devices out)."""
    n = dist.get_world_size() if n_devices is None else int(n_devices)
    if not 0 < n <= dist.get_world_size():
        raise ValueError(f"n_devices {n} must be in [1, {dist.get_world_size()}]")
    if camera_parallel > 1:
        tiles = n // camera_parallel
        return mesh_from_grid(np.arange(camera_parallel * tiles).reshape(camera_parallel, tiles),
                              (CAMERA_AXIS, TILES_AXIS))
    return mesh_from_grid(np.arange(n).reshape(1, n), (TILES_AXIS,))


def _n_bands(mesh) -> int:
    return mesh if isinstance(mesh, int) else mesh.shape[TILES_AXIS]


def shard_multiple(n_bands: int) -> int:
    """Padding multiple of a sharded cloud: lane-friendly and divisible by
    the band count (also where that is not a power of two)."""
    return 256 * n_bands // math.gcd(256, n_bands)


def shard_cloud(cloud, mesh: Mesh):
    """This rank's rows of ``cloud`` (any cloud class, 4DGS included) padded
    to a multiple of :func:`shard_multiple` by ``pad_cloud``: band ``b``
    holds rows ``[b * n_local, (b + 1) * n_local)``, on the cloud's device."""
    n_bands = mesh.shape[TILES_AXIS]
    padded = pad_cloud(cloud, shard_multiple(n_bands))
    n_local = len(padded) // n_bands
    band = mesh.get_local_rank(TILES_AXIS)
    rows = slice(band * n_local, (band + 1) * n_local)
    return type(padded)(**{f.name: getattr(padded, f.name)[rows] for f in dataclasses.fields(padded)})


def plan_exchange(
    cloud,
    cameras,
    settings: CloudSettings,
    width: int,
    height: int,
    mesh,
    model_transform=None,
    time: float = 0.0,
    headroom: float = 1.25,
    with_pairs: bool = False,
):
    """Exchange planner, run once per scene and camera schedule on the whole
    cloud -> ``(mode, budget)``, or ``(mode, budget, band_pairs)`` with
    ``with_pairs``: project the padded cloud for each camera (one or a
    list), measure each (source shard, band) coverage
    (``exchange.auto_exchange_plan``), and take ``"bounded"`` only where it
    receives fewer rows per rank than the all-gather.  ``band_pairs`` is the
    worst band's (gaussian, tile) pair count, a ``pairs_hint`` that sizes a
    band's pair buffers by its coverage.  ``mesh`` is a :class:`Mesh` or its
    tiles count; no collective runs."""
    n_bands = _n_bands(mesh)
    padded = pad_cloud(cloud, shard_multiple(n_bands))
    n_total = len(padded)
    n_local = n_total // n_bands
    band_rows = (height // n_bands) // TILE
    if not isinstance(cameras, (list, tuple)):
        cameras = [cameras]
    budget, band_pairs = 0, 0
    for camera in cameras:
        splats = project_for_binning(padded, camera, settings, model_transform, time=time)
        ty0, ty1, active = tile_row_range(splats, width, height)
        _, b = auto_exchange_plan(ty0 // band_rows, ty1 // band_rows, active, n_bands, n_local, headroom=headroom)
        budget = max(budget, b)
        if with_pairs:
            # per band: the rectangle's tile columns times its rows in the band
            _, ty0r, rect_w, rect_h, act = (t.cpu().numpy() for t in tile_rects(splats, width, height))
            ty1r = ty0r + rect_h - 1
            for band in range(n_bands):
                lo, hi = band * band_rows, (band + 1) * band_rows - 1
                rows = np.maximum(np.minimum(ty1r, hi) - np.maximum(ty0r, lo) + 1, 0)
                band_pairs = max(band_pairs, int(np.sum(rect_w * np.where(act, rows, 0))))
    mode = "bounded" if n_bands * budget < n_total else "allgather"
    return (mode, budget, band_pairs) if with_pairs else (mode, budget)


class _AllGather(torch.autograd.Function):
    """``all_gather_into_tensor`` of equal row blocks; the backward is the
    sum-reduce-scatter to this rank's rows, by an equal-split all-to-all and
    a sum over sources in rank order (one formulation on every backend)."""

    @staticmethod
    def forward(ctx, rows, group):
        world = dist.get_world_size(group)
        out = rows.new_empty((world * rows.shape[0],) + tuple(rows.shape[1:]))
        dist.all_gather_into_tensor(out, rows.contiguous(), group=group)
        ctx.group, ctx.world = group, world
        return out

    @staticmethod
    def backward(ctx, grad):
        parts = torch.empty_like(grad)
        dist.all_to_all_single(parts, grad.contiguous(), group=ctx.group)
        parts = parts.reshape((ctx.world, -1) + tuple(grad.shape[1:]))
        total = parts[0]
        for source in range(1, ctx.world):
            total = total + parts[source]
        return total, None


def all_gather_rows(rows: torch.Tensor, group) -> torch.Tensor:
    """Rows of every rank of ``group`` stacked in rank order, differentiable:
    each rank's gradient is the sum of every rank's gradient of its rows."""
    return _AllGather.apply(rows, group)


def key_to_f32(key: torch.Tensor) -> torch.Tensor:
    """Radix keys (int64 holding 32-bit values) carried bit for bit as
    float32, for a float payload."""
    signed = torch.where(key >= 1 << 31, key - (1 << 32), key)
    return signed.to(torch.int32).view(torch.float32)


def f32_to_key(col: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`key_to_f32`."""
    return col.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF


def _band_rows_of(image: Optional[torch.Tensor], band: int, band_h: int):
    """A full-image background's rows of the band (a solid one is kept)."""
    if image is None or image.dim() == 1:
        return image
    return image[band * band_h : (band + 1) * band_h]


def _local_band_render(
    cloud_shard,
    camera: Camera,
    settings: CloudSettings,
    model_transform,
    background,
    time,
    width: int,
    height: int,
    mesh: Mesh,
    exchange: str = "allgather",
    band_budget: Optional[int] = None,
    pairs_hint: Optional[int] = None,
    differentiable: bool = True,
) -> torch.Tensor:
    """One rank's band: project the shard, exchange, bin in the full frame
    windowed to the band, composite at ``y0 = band * band_h`` ->
    [height / n_bands, width, 4], differentiable in the shard's tensors.

    ``exchange``: "allgather" gives every rank all projected rows;
    "bounded" routes each row only to the bands its rectangle meets, at
    most ``band_budget`` rows per source (default the shard's size).  The
    bounding-box overlay trains (``differentiable``) through the plain
    ``composite_tiles`` at the band's ``y0``, as ``render_tiled`` does."""
    if exchange not in ("allgather", "bounded"):
        raise ValueError(f"exchange must be 'allgather' or 'bounded', got {exchange!r}")
    group = mesh.get_group(TILES_AXIS)
    n_bands = mesh.shape[TILES_AXIS]
    band = mesh.get_local_rank(TILES_AXIS)
    band_h = height // n_bands
    band_rows = band_h // TILE
    tx_count = width // TILE

    splats = project_for_binning(cloud_shard, camera, settings, model_transform, time=time, size=(width, height))
    params_local = splats["params"]
    c = params_local.shape[1]
    keyf = key_to_f32(splats["sort_key"])[:, None]
    center = splats["center_ndc"].detach()
    if exchange == "bounded":
        ty0, ty1, active = tile_row_range(splats, width, height)
        b0, b1 = band_interval(ty0, ty1, band_rows)
        payload = torch.cat([params_local, center, keyf, active.to(torch.float32)[:, None]], dim=1)
        # inactive rows may carry NaN from masked projections: select them to zero
        payload = torch.where(active[:, None], payload, torch.zeros((), device=payload.device))
        budget = band_budget if band_budget is not None else params_local.shape[0]
        received = band_exchange(payload, b0, b1, active, n_bands, budget, group)
    else:
        payload = torch.cat([params_local, center, keyf, splats["mask"].to(torch.float32)[:, None]], dim=1)
        received = all_gather_rows(payload, group)
    mask = received[:, c + 3] > 0.5
    g_splats = {
        "mask": mask,
        "center_ndc": received[:, c : c + 2].detach(),
        "sort_key": torch.where(mask, f32_to_key(received[:, c + 2]), torch.full_like(mask, sort_ops.SENTINEL_KEY,
                                                                                      dtype=torch.int64)),
    }
    params = received[:, :c]
    # the extents come from the packed rows (their layout follows the mode)
    if settings.gaussian_mode == GaussianMode.GAUSSIAN_2D:
        g_splats["surfel_radius"] = params[:, 2].detach()
    elif settings.aabb:
        g_splats["radius_vp"] = params[:, 5].detach()
    else:
        g_splats["obb_axis"] = params[:, 2:4].detach()
        g_splats["obb_bounds"] = params[:, 4:6].detach()

    # the one-rank frame's sizes: its per-tile budget and its chunk grid
    n_frame = len(cloud_shard) * n_bands
    k_max = tile_budget(n_frame)
    p_max = pairs_budget(params.shape[0], pairs_hint)
    mode = kernel_mode(settings)
    y0 = band * band_h
    with span("gs.bin"):
        g_s, tile_s, valid_s, total, order, _, cum, perm = bin_gaussians(
            g_splats, width, height, p_max, tile_row0=band * band_rows, band_tile_rows=band_rows
        )
        start, end = tile_ranges(tile_s, tx_count * band_rows)
    if settings.visualize_bounding_box and differentiable:
        out_raw = composite_tiles(params[g_s], valid_s, start, end - start, tx_count, width, height, k_max, mode, y0=y0)
    else:
        # the compositor's chunk grid is anchored at 128-aligned pair
        # positions: place the band's pairs where the one-rank frame has them
        # (mod 128), so that its early exits fall where that frame's do
        shift = _pairs_before(torch.clamp(total, max=p_max), group, band) % 128
        if shift:
            g_s = torch.cat([g_s.new_zeros(shift), g_s])
            order = torch.cat([torch.arange(p_max, p_max + shift, device=order.device), order])
            start = start + shift
            end = end + shift
        out_raw = composite_core(
            params, g_s, start, torch.clamp(end - start, max=k_max), order, cum, perm, tx_count=tx_count,
            width=width, full_height=height, y0=y0,
            chunk=preferred_chunk(pairs_budget(n_frame), tx_count * (height // TILE)), mode=mode,
            bbox=settings.visualize_bounding_box,
        )
    return composite_epilogue(out_raw, _band_rows_of(background, band, band_h), width, band_h)


def _pairs_before(total: torch.Tensor, group, band: int) -> int:
    """The pairs of the bands above this one (every band's count, gathered)."""
    return int(all_gather_rows(total.reshape(1).to(torch.int64), group)[:band].sum())


def _check_height(height: int, n_bands: int) -> None:
    if height % (n_bands * TILE):
        raise ValueError(f"height {height} must be divisible by n_bands*TILE = {n_bands * TILE}")


def _assemble(img_band: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The bands of every rank of the tiles group -> the full image."""
    band_h, width, _ = img_band.shape
    rows = all_gather_rows(img_band.reshape(band_h, width * 4), mesh.get_group(TILES_AXIS))
    return rows.reshape(-1, width, 4)


def _defaults(cloud, model_transform, background):
    dev = cloud.device
    if model_transform is None:
        model_transform = torch.eye(4, dtype=torch.float32, device=dev)
    if background is None:
        background = torch.zeros(4, dtype=torch.float32, device=dev)
    return model_transform, background


def make_sharded_render(
    mesh: Mesh,
    settings: CloudSettings,
    width: int,
    height: int,
    exchange: str = "allgather",
    band_budget: Optional[int] = None,
    pairs_hint: Optional[int] = None,
):
    """Sharded forward: ``fn(cloud_shard, camera, model_transform=None,
    background=None, time=0.0)`` -> the full [H, W, 4] image on every rank
    of the mesh (each rank passes its own :func:`shard_cloud`).
    ``pairs_hint``: ``plan_exchange(with_pairs=True)``'s worst-band count."""
    n_bands = mesh.shape[TILES_AXIS]
    _check_height(height, n_bands)

    def fn(cloud_shard, camera, model_transform=None, background=None, time=0.0):
        model_transform, background = _defaults(cloud_shard, model_transform, background)
        img_band = _local_band_render(
            cloud_shard, camera, settings, model_transform, background, time, width, height, mesh,
            exchange=exchange, band_budget=band_budget, pairs_hint=pairs_hint, differentiable=False,
        )
        return _assemble(img_band, mesh)

    return fn


def _own_cameras(cameras, mesh: Mesh) -> list:
    """This rank's cameras of a batch split along the camera axis."""
    if isinstance(cameras, Camera):
        cameras = _unstack_cameras(cameras)
    cams = mesh.shape[CAMERA_AXIS]
    if len(cameras) % cams:
        raise ValueError(f"{len(cameras)} cameras do not split over a camera axis of {cams}")
    per = len(cameras) // cams
    row = mesh.get_local_rank(CAMERA_AXIS)
    return list(cameras[row * per : (row + 1) * per])


def make_sharded_render_multicam(
    mesh: Mesh,
    settings: CloudSettings,
    width: int,
    height: int,
    exchange: str = "allgather",
    band_budget: Optional[int] = None,
    pairs_hint: Optional[int] = None,
):
    """Camera-parallel and pixel-parallel forward on a (camera, tiles)
    mesh: ``fn(cloud_shard, cameras, model_transform=None, background=None,
    time=0.0)`` with a list of C cameras (or a ``stack_cameras`` batch), C a
    multiple of the camera axis -> [C, H, W, 4] on every rank.  Each camera
    row renders its share of the cameras band by band."""
    if CAMERA_AXIS not in mesh.shape:
        raise ValueError("mesh needs a camera axis (make_mesh(camera_parallel=k))")
    _check_height(height, mesh.shape[TILES_AXIS])

    def fn(cloud_shard, cameras, model_transform=None, background=None, time=0.0):
        model_transform, background = _defaults(cloud_shard, model_transform, background)
        images = torch.stack([
            _assemble(_local_band_render(
                cloud_shard, camera, settings, model_transform, background, time, width, height, mesh,
                exchange=exchange, band_budget=band_budget, pairs_hint=pairs_hint, differentiable=False,
            ), mesh)
            for camera in _own_cameras(cameras, mesh)
        ])
        c, h, w, _ = images.shape
        out = all_gather_rows(images.reshape(c, h * w * 4), mesh.get_group(CAMERA_AXIS))
        return out.reshape(-1, h, w, 4)

    return fn


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------


def photometric_loss(image: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean((image - target) ** 2)


@dataclasses.dataclass
class ShardTrainState:
    """A rank's shard as trainable parameters, its Adam, and the counters
    of ``optax.apply_if_finite``'s state."""

    model: TrainableCloud
    optimizer: torch.optim.Optimizer
    notfinite_count: int = 0
    total_notfinite: int = 0
    last_finite: bool = True

    def cloud(self):
        return self.model.cloud()


def _make_init(learning_rate: float):
    def init(cloud_shard) -> ShardTrainState:
        model = TrainableCloud(cloud_shard)
        return ShardTrainState(model, adam(model, learning_rate))

    return init


def _apply(state: ShardTrainState, mesh: Mesh, skip_nonfinite: int) -> None:
    """Adam on the shard, or, with ``skip_nonfinite`` = k > 0, the update
    of ``optax.apply_if_finite(adam, k)``: a step whose gradients hold a NaN
    or an infinity on any rank of the mesh is skipped (parameters and Adam's
    state untouched) unless it is past the k-th such step in a row."""
    if skip_nonfinite:
        grads = [p.grad for p in state.model.parameters() if p.grad is not None]
        bad = torch.stack([(~torch.isfinite(g)).any() for g in grads]).any().to(torch.float32).reshape(1)
        dist.all_reduce(bad, group=mesh.get_group(None))
        finite = float(bad.item()) == 0.0
        state.notfinite_count = 0 if finite else state.notfinite_count + 1
        state.total_notfinite += 0 if finite else 1
        state.last_finite = finite
        if not (finite or state.notfinite_count > skip_nonfinite):
            return
    state.optimizer.step()


def _sum_loss(loss_local: torch.Tensor, group) -> torch.Tensor:
    total = loss_local.detach().clone().reshape(1)
    dist.all_reduce(total, group=group)
    return total[0]


def make_train_step(
    mesh: Mesh,
    settings: CloudSettings,
    width: int,
    height: int,
    learning_rate: float = 1e-2,
    loss: str = "l2",
    skip_nonfinite: int = 0,
    exchange: str = "allgather",
    band_budget: Optional[int] = None,
    pairs_hint: Optional[int] = None,
):
    """Sharded training step -> ``(step, init)``: ``state = init(cloud_shard)``,
    then ``step(state, camera, target, time=0.0)`` renders, takes this
    band's term of the loss against the band's rows of the full [H, W, 4]
    ``target``, back-propagates (the exchange's backward sums every band's
    share into the shard's gradient once) and steps Adam on the shard; it
    returns the mesh's whole loss.  ``state.cloud()`` is the updated shard.

    ``loss``: "l2" (mean squared error) or "l1_ssim"
    (``gaussian_splatting_loss`` per band divided by the band count: the
    SSIM windows see zero padding at a band's edge, as in the JAX package).
    ``skip_nonfinite`` = k > 0: ``optax.apply_if_finite``'s semantics
    (:func:`_apply`)."""
    if loss not in ("l2", "l1_ssim"):
        raise ValueError(f"loss must be 'l2' or 'l1_ssim', got {loss!r}")
    n_bands = mesh.shape[TILES_AXIS]
    _check_height(height, n_bands)

    def step(state: ShardTrainState, camera: Camera, target: torch.Tensor, time=0.0) -> torch.Tensor:
        state.optimizer.zero_grad(set_to_none=True)
        shard = state.cloud()
        model_transform, background = _defaults(shard, None, None)
        img_band = _local_band_render(
            shard, camera, settings, model_transform, background, time, width, height, mesh,
            exchange=exchange, band_budget=band_budget, pairs_hint=pairs_hint,
        )
        target_band = _band_rows_of(target, mesh.get_local_rank(TILES_AXIS), height // n_bands)
        if loss == "l1_ssim":
            loss_local = gaussian_splatting_loss(img_band, target_band) / n_bands
        else:
            loss_local = torch.sum((img_band - target_band) ** 2) / (height * width * 4)
        loss_local.backward()
        _apply(state, mesh, skip_nonfinite)
        return _sum_loss(loss_local, mesh.get_group(TILES_AXIS))

    return step, _make_init(learning_rate)


def make_train_step_multicam(
    mesh: Mesh,
    settings: CloudSettings,
    width: int,
    height: int,
    learning_rate: float = 1e-2,
    exchange: str = "allgather",
    band_budget: Optional[int] = None,
    pairs_hint: Optional[int] = None,
):
    """Camera-parallel and pixel-parallel training on a (camera, tiles)
    mesh -> ``(step, init)``; ``step(state, cameras, targets, time=0.0)``
    with C cameras and targets [C, H, W, 4]: each rank renders its camera
    row's share of the cameras in its band, back-propagates its squared
    error over C * H * W * 4, the gradients are summed over the camera axis
    (data parallelism over views) and Adam steps the shard.  Returns the
    mesh's whole loss, the mean squared error over every view."""
    if CAMERA_AXIS not in mesh.shape:
        raise ValueError("mesh needs a camera axis (make_mesh(camera_parallel=k))")
    n_bands = mesh.shape[TILES_AXIS]
    _check_height(height, n_bands)

    def step(state: ShardTrainState, cameras: Sequence[Camera], targets: torch.Tensor, time=0.0) -> torch.Tensor:
        state.optimizer.zero_grad(set_to_none=True)
        shard = state.cloud()
        model_transform, background = _defaults(shard, None, None)
        own = _own_cameras(cameras, mesh)
        first = mesh.get_local_rank(CAMERA_AXIS) * len(own)
        band = mesh.get_local_rank(TILES_AXIS)
        cams_total = len(own) * mesh.shape[CAMERA_AXIS]
        loss_local = 0.0
        for k, camera in enumerate(own):
            img = _local_band_render(
                shard, camera, settings, model_transform, background, time, width, height, mesh,
                exchange=exchange, band_budget=band_budget, pairs_hint=pairs_hint,
            )
            loss_local = loss_local + torch.sum((img - _band_rows_of(targets[first + k], band, height // n_bands)) ** 2)
        loss_local = loss_local / (cams_total * height * width * 4)
        loss_local.backward()
        for p in state.model.parameters():
            if p.grad is not None:
                dist.all_reduce(p.grad, group=mesh.get_group(CAMERA_AXIS))
        state.optimizer.step()
        return _sum_loss(loss_local, mesh.get_group(None))

    return step, _make_init(learning_rate)
