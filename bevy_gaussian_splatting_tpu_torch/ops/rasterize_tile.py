"""Tile-binned renderer: binning and the pipeline.

The counterpart of the JAX package's ``ops/rasterize_tile.py``
``render_tiled(..., compositor="pallas")`` for 3DGS with OBB or AABB bounds,
2DGS surfels and 4DGS (which bins and composites as 3DGS, OBB or AABB, at
the frame time), in every rasterize, draw and sort mode
(the DEPTH ramp's range from the sorted-entry quirk, :func:`depth_range`),
serving and training alike.  It reproduces that path's integer artifacts
exactly:

  1. project every gaussian, take its radix depth key and pack its
     compositor row (ops/cuda/project.py);
  2. each splat's clipped tile rectangle from its OBB screen extent, or the
     square of its AABB or surfel radius;
  3. a stable depth pre-sort, front to back, inactive gaussians first;
  4. inclusive pair counts, capped at the budget ``p_max`` (the farthest
     pairs drop when the cap binds);
  5. pair expansion (kernel, ops/cuda/expand.py);
  6. a stable pair sort keyed by tile only (pairs are born depth-ordered);
  7. per-tile ranges, counts clipped at ``k_max``;
  8. tile compositing (kernel, ops/cuda/tile_fwd.py) and the epilogue.

The image is differentiable in the cloud's tensors: compositing runs inside
``ops/cuda/core.py``'s autograd Function, whose backward is the backward
compositor and segmented reduce kernels; autograd carries the per-gaussian
gradients on through packing and projection.  The bounding-box overlay has
no backward kernel: trained (``differentiable=True``), it composites with
:func:`composite_tiles`, plain PyTorch under autograd, as the JAX package
moves it to its XLA compositor; served, it runs the kernel.

Heights that are not a multiple of 16 render on a padded tile grid with
fragments in the true frame (``full_height``); the pad rows are cropped.
A full-image background is padded with zero rows to the grid first.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

from bevy_gaussian_splatting_tpu_torch.models.camera import Camera
from bevy_gaussian_splatting_tpu_torch.models.settings import CloudSettings, GaussianMode, RasterizeMode
from bevy_gaussian_splatting_tpu_torch.ops import sort as sort_ops
from bevy_gaussian_splatting_tpu_torch.ops.cuda.core import composite_core
from bevy_gaussian_splatting_tpu_torch.ops.cuda.expand import expand_pairs
from bevy_gaussian_splatting_tpu_torch.ops.cuda.project import project_splats
from bevy_gaussian_splatting_tpu_torch.ops.cuda.tile_fwd import (
    MODE_2D,
    MODE_AABB,
    MODE_OBB,
    PIX,
    composite_epilogue,
    overlay_alpha,
    overlay_rgb,
    preferred_chunk,
    splat_falloff,
    tile_ndc,
    tiles_to_image,
)
from bevy_gaussian_splatting_tpu_torch.ops.project import as_float32
from bevy_gaussian_splatting_tpu_torch.ops.transforms import apply_transform
from bevy_gaussian_splatting_tpu_torch.utils import trace

TILE = 16  # pixels per tile side
PAIRS_HEADROOM = 1.25  # budget over a measured pair count
XLA_CHUNK = 64  # pairs per chunk of composite_tiles (rasterize_tile.py:1115)


def pairs_budget(
    n: int,
    hint: Optional[int] = None,
    headroom: float = PAIRS_HEADROOM,
    quantum: Optional[int] = None,
) -> int:
    """Static (gaussian, tile) pair capacity (rasterize_tile.py:63-100).

    Without a hint: 6N, capped.  With a measured pair count: the next
    1-1.5-2-3 bucket above ``headroom * hint``, or, with ``quantum``, the
    next multiple of ``quantum`` above it (for a pair count measured on the
    workload itself: every pair-proportional stage scales with the budget,
    so the coarse buckets can cost up to half again).  Overflow truncates
    the farthest pairs."""
    cap = int(min(max(6 * n, 1 << 14), 3 << 22))
    if hint is None:
        return cap
    need = max(int(hint * headroom) + 1, 1 << 14)
    if quantum is not None:
        return int(min((need + quantum - 1) // quantum * quantum, cap))
    bucket = 1 << 14
    while bucket < need:
        bucket *= 2
    if bucket // 2 * 3 // 2 >= need:
        bucket = bucket // 2 * 3 // 2
    return int(min(bucket, cap))


def pad_to_tile(v: int) -> int:
    """Next multiple of TILE at or above ``v``."""
    return -(-v // TILE) * TILE


def tile_budget(n: int) -> int:
    """Per-tile splat budget ``k_max`` (rasterize_tile.py:156)."""
    return int(min(max(2 * n, 1 << 10), 1 << 13))


@trace.spanned("gs.project")
def project_for_binning(
    cloud, camera: Camera, settings: CloudSettings, model_transform=None, depth_minmax=None, time=None, size=None,
    surface: bool = False,
) -> dict:
    """The frame's projection at ``time`` (default ``settings.time``), as
    ``render_tiled`` prepares it: ``ops/cuda/project.py``
    :func:`project_splats`, the binning's fields and the compositor's rows
    (``params``) packed for an image of ``size`` (default the camera's),
    from one kernel where it applies and the eager chain elsewhere;
    ``surface`` adds the 2DGS surface columns.  Each call counts
    ``project.calls`` (``utils/trace.py``)."""
    trace.count("project.calls")
    return project_splats(cloud, camera, settings, model_transform, time, size, depth_minmax, surface)


def _pixel_extents(splats: dict, width: int, height: int):
    """Per-splat centre (cx, cy) and half-extents (rx, ry) in pixels: the
    square of the surfel or AABB radius where the projection gave one, else
    the OBB's rotated rectangle (rasterize_tile.py:166-183)."""
    cx_px = (splats["center_ndc"][:, 0] + 1.0) * 0.5 * width
    cy_px = (1.0 - splats["center_ndc"][:, 1]) * 0.5 * height
    for key in ("surfel_radius", "radius_vp"):
        if key in splats:
            r = splats[key] * 0.5  # doubled / vp units -> px
            return cx_px, cy_px, r, r
    e1 = splats["obb_axis"]
    b = splats["obb_bounds"]
    # rotated-rect bbox: |e1|*b1 + |e2|*b2 with e2 = (e1.y, -e1.x)
    rx = (e1[:, 0].abs() * b[:, 0] + e1[:, 1].abs() * b[:, 1]) * 0.5
    ry = (e1[:, 1].abs() * b[:, 0] + e1[:, 0].abs() * b[:, 1]) * 0.5
    return cx_px, cy_px, rx, ry


def _row_cells(splats: dict, width: int, height: int):
    """Per-splat pixel extents, activity and clipped tile rows as floats ->
    (cx, rx, ty0, ty1, active) on the padded grid, the quantities binning
    and the band window share (rasterize_tile.py:186-202, :424-436)."""
    ty_count = pad_to_tile(height) // TILE
    cx, cy, rx, ry = _pixel_extents(splats, width, height)
    on_screen = (cx + rx >= 0.0) & (cx - rx <= width) & (cy + ry >= 0.0) & (cy - ry <= height)
    active = splats["mask"] & (rx > 0.0) & (ry > 0.0) & on_screen
    ty0 = torch.clamp(torch.floor((cy - ry) / TILE), 0, ty_count - 1)
    ty1 = torch.clamp(torch.floor((cy + ry) / TILE), 0, ty_count - 1)
    return cx, rx, ty0, ty1, active


def tile_row_range(splats: dict, width: int, height: int):
    """Clipped tile-row interval [ty0, ty1] of every splat on the padded
    grid and its activity -> (ty0, ty1, active), int64 with zeros where
    inactive: exactly the rows the band window of :func:`tile_rects` keeps
    (rasterize_tile.py:186), so the bounded band exchange routes a splat to
    precisely the bands whose binning keeps it."""
    _, _, ty0, ty1, active = _row_cells(splats, width, height)
    zero = torch.zeros_like(ty0)
    return (
        torch.where(active, ty0, zero).to(torch.int64),
        torch.where(active, ty1, zero).to(torch.int64),
        active,
    )


def tile_rects(splats: dict, width: int, height: int, tile_row0=None, band_tile_rows: Optional[int] = None):
    """Clipped tile rectangle of every splat on the padded grid ->
    (tx0, ty0, rect_w, rect_h, active), int64 with zeros where inactive.

    With ``tile_row0`` (an int) and ``band_tile_rows``, the grid is the band
    of tile rows [tile_row0, tile_row0 + band_tile_rows) of the full frame:
    splats whose rows miss it turn inactive and the rows of the rest are
    clipped into it, band-local (rasterize_tile.py:438-443).  The extents
    stay in the full frame (``height`` the full height), so a band's pairs
    are exactly its slice of the whole frame's."""
    tx_count = width // TILE
    cx, rx, ty0, ty1, active = _row_cells(splats, width, height)
    if tile_row0 is not None:
        rows = band_tile_rows
        active = active & (ty1 >= tile_row0) & (ty0 <= tile_row0 + rows - 1)
        ty0 = torch.clamp(ty0 - tile_row0, 0, rows - 1)
        ty1 = torch.clamp(ty1 - tile_row0, 0, rows - 1)

    def cell(v):
        return torch.where(active, v, torch.zeros_like(v)).to(torch.int64)

    tx0 = cell(torch.clamp(torch.floor((cx - rx) / TILE), 0, tx_count - 1))
    tx1 = cell(torch.clamp(torch.floor((cx + rx) / TILE), 0, tx_count - 1))
    ty0, ty1 = cell(ty0), cell(ty1)
    zero = torch.zeros_like(tx0)
    rect_w = torch.where(active, tx1 - tx0 + 1, zero)
    rect_h = torch.where(active, ty1 - ty0 + 1, zero)
    return tx0, ty0, rect_w, rect_h, active


def pair_count(cloud, camera: Camera, settings: CloudSettings, model_transform=None, time=None) -> torch.Tensor:
    """Exact (gaussian, tile) pair count of this frame at ``time`` (default
    ``settings.time``; int64 scalar tensor): N-sized work only, the
    budget-sizing prepass."""
    splats = project_for_binning(cloud, camera, settings, model_transform, time=time)
    _, _, rect_w, rect_h, _ = tile_rects(splats, camera.width, camera.height)
    return torch.sum(rect_w * rect_h)


def front_depth_perm(back_key: torch.Tensor, active: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Front-to-back permutation: the exact reverse of the reference's stable
    back-to-front radix order (key ascending, index ascending).

    The front key is ``0xFFFFFFFF - back_key``, zeroed for inactive
    gaussians so they come first; ties break by DESCENDING cloud index,
    which a stable sort of the reversed key array gives."""
    n = back_key.shape[0]
    front_key = sort_ops.SENTINEL_KEY - back_key
    if active is not None:
        front_key = torch.where(active, front_key, torch.zeros_like(front_key))
    _, pos = torch.sort(front_key.flip(0), stable=True)
    return (n - 1) - pos


def expansion_inputs(
    splats: dict, width: int, height: int, p_max: int, tile_row0=None, band_tile_rows: Optional[int] = None
):
    """The expansion kernel's inputs -> ``((cum, rect_w, tx0, ty0, perm), total)``.

    Gaussians in front-to-back order, inactive ones first; ``cum`` holds the
    inclusive pair counts clamped at ``p_max`` (slot owners below ``p_max``
    are unchanged by the clamp, and the int32 table cannot overflow),
    ``perm`` the cloud index of each.  All int32 [N].  ``total`` is the
    uncapped pair count (int64 scalar tensor).  ``tile_row0`` and
    ``band_tile_rows`` window a band (:func:`tile_rects`)."""
    tx0, ty0, rect_w, rect_h, active = tile_rects(splats, width, height, tile_row0, band_tile_rows)
    with trace.span("gs.bin.sort_depth"):
        perm = front_depth_perm(splats["sort_key"], active)
    cum = torch.cumsum((rect_w * rect_h)[perm], dim=0)
    total = cum[-1] if cum.numel() else cum.new_zeros(())

    def i32(v):
        return v.to(torch.int32).contiguous()

    table = (i32(torch.clamp(cum, max=p_max)), i32(rect_w[perm]), i32(tx0[perm]), i32(ty0[perm]), i32(perm))
    return table, total


def bin_gaussians(
    splats: dict, width: int, height: int, p_max: int, tile_row0=None, band_tile_rows: Optional[int] = None
):
    """Sorted (tile, pair) assignment -> ``(g_s, tile_s, valid_s, total,
    order, rank, cum, perm)``.

    With ``tile_row0`` and ``band_tile_rows`` it bins the band of tile rows
    [tile_row0, tile_row0 + band_tile_rows) of the full ``height`` frame,
    with band-local tile ids and sentinel (rasterize_tile.py:360, :438-443).

    ``g_s`` / ``tile_s`` [p_max] int32: cloud index and tile of each pair,
    sorted by tile, front to back within a tile; slots past the total carry
    the sentinel tile ``tx_count * ty_count`` (and cloud index 0).
    ``total`` is the uncapped pair count (int64 scalar tensor).

    The rest is what the backward needs to carry per-pair gradients back to
    the cloud: ``order`` [p_max] int64, the expansion slot of each sorted
    pair (``tile_s == tile[order]``); ``rank`` [p_max] int32, the depth rank
    owning each slot (N past the total; ``rank[order]`` is the JAX package's
    ``gidx_s``); ``cum`` [N] int32, the inclusive pair counts clamped at
    ``p_max``; ``perm`` [N] int32, the cloud index of each depth rank."""
    tx_count = width // TILE
    rows = pad_to_tile(height) // TILE if tile_row0 is None else band_tile_rows
    sentinel = tx_count * rows
    table, total = expansion_inputs(splats, width, height, p_max, tile_row0, band_tile_rows)
    with trace.span("gs.bin.expand"):
        tile, g_cloud, rank = expand_pairs(*table, p_max, tx_count, sentinel)
    # born depth-ordered: a stable sort on the tile alone keeps depth order
    with trace.span("gs.bin.sort_tile"):
        tile_s, order = torch.sort(tile, stable=True)
    cum, perm = table[0], table[4]
    return g_cloud[order], tile_s, tile_s < sentinel, total, order, rank, cum, perm


@trace.spanned("gs.bin.ranges")
def tile_ranges(pair_tile: torch.Tensor, num_tiles: int):
    """Contiguous [start, end) of every tile in the tile-sorted pairs, from
    one search over ``num_tiles + 1`` tile ids (end[t] == start[t + 1])."""
    tids = torch.arange(num_tiles + 1, dtype=pair_tile.dtype, device=pair_tile.device)
    bounds = torch.searchsorted(pair_tile, tids).to(torch.int32)
    return bounds[:num_tiles], bounds[1:]


def kernel_mode(settings: CloudSettings) -> int:
    """The compositing kernels' mode for ``settings`` (tile_fwd.py:81-84)."""
    if settings.gaussian_mode == GaussianMode.GAUSSIAN_2D:
        return MODE_2D
    return MODE_AABB if settings.aabb else MODE_OBB


class TileBins(NamedTuple):
    """Binning artifacts of one frame (see :func:`bin_gaussians`)."""

    g_s: torch.Tensor  # [P] int32 cloud index of each tile-sorted pair
    start: torch.Tensor  # [T] int32 first pair of each tile
    count: torch.Tensor  # [T] int32 pairs of each tile, clipped at k_max
    order: torch.Tensor  # [P] int64 expansion slot of each tile-sorted pair
    cum: torch.Tensor  # [N] int32 inclusive pair counts (depth order), clamped
    perm: torch.Tensor  # [N] int32 cloud index of each depth rank


def tile_bins(
    splats: dict, width: int, height: int, p_max: int, tile_row0=None, band_tile_rows: Optional[int] = None,
    pairs_counter: Optional[str] = None,
) -> TileBins:
    """Bin a frame on the padded tile grid, or on the band that
    ``tile_row0`` and ``band_tile_rows`` window (:func:`bin_gaussians`): tile
    ranges with counts clipped at ``k_max``, plus the inverse maps the
    backward needs.  ``pairs_counter`` names a counter (``utils/trace.py``
    :func:`count_later`) that gets the uncapped pair count."""
    rows = pad_to_tile(height) // TILE if tile_row0 is None else band_tile_rows
    num_tiles = (width // TILE) * rows
    with trace.span("gs.bin"):
        g_s, tile_s, _, total, order, _, cum, perm = bin_gaussians(
            splats, width, height, p_max, tile_row0, band_tile_rows
        )
        start, end = tile_ranges(tile_s, num_tiles)
        count = torch.clamp(end - start, max=tile_budget(splats["mask"].shape[0]))
    if pairs_counter is not None:
        trace.count_later(pairs_counter, total)
    return TileBins(g_s, start, count, order, cum, perm)


def depth_range(cloud, camera: Camera, settings: CloudSettings, model_transform=None):
    """(min, max) camera distance of the DEPTH ramp, the reference's quirk
    (gaussian.wgsl:329-347): the distances of back-sorted entries ``n - 1``
    and ``min(1, n - 1)``, sentinels included, found by reductions
    (``sort.back_sorted_entry_indices``), as the JAX package's
    ``render_tiled`` finds them (rasterize_tile.py:1150-1164).  The
    positions are the stored ones, also in 4DGS: the reference's ramp reads
    the unshifted positions, so the range takes no time."""
    cloud = as_float32(cloud)
    if model_transform is None:
        model_transform = torch.eye(4, dtype=torch.float32, device=cloud.device)
    back_key = sort_ops.radix_depth_key(
        cloud.position, model_transform, camera.clip_from_world, camera.world_position,
        settings.radix_sort_depth_bits.bits,
    )
    first, last = sort_ops.back_sorted_entry_indices(back_key)
    wp = apply_transform(model_transform, cloud.position)
    return (
        torch.linalg.norm(wp[last] - camera.world_position),
        torch.linalg.norm(wp[first] - camera.world_position),
    )


def composite_tiles(
    params_sorted: torch.Tensor,
    pair_valid: torch.Tensor,
    tile_start: torch.Tensor,
    tile_count: torch.Tensor,
    tx_count: int,
    width: int,
    full_height: int,
    k_max: int,
    mode: int = MODE_OBB,
    y0: int = 0,
) -> torch.Tensor:
    """Front-to-back compositing with the bounding-box overlay in plain
    PyTorch, differentiable by autograd -> raw [T, 4, 256] (rows 0-2
    premultiplied rgb, row 3 final transmittance, as
    ``composite_tiles_raw``).

    The JAX package's XLA compositor in its ``differentiable=True`` form
    (rasterize_tile.py:946-1100), its route for training the bounding-box
    overlay, which has no backward kernel (:1178-1181): the pair rows
    ``params_sorted`` [P, param_width(mode)] zeroed where ``pair_valid`` is
    false, one zero pad row for the lanes past a tile's ``tile_count``
    (clipped at ``k_max``), chunks of ``XLA_CHUNK`` pairs from each tile's start
    blended by an exclusive ``cumprod``, and no early exit; each chunk is
    recomputed in the backward (``torch.utils.checkpoint``), as JAX remats
    it.  The chunks past every tile's count blend nothing (alpha 0 adds 0
    and multiplies T by 1, exactly), so the loop stops after the last
    chunk that some tile reaches instead of at ``ceil(k_max / chunk)``.

    ``y0`` is the first pixel row of a band of the ``full_height`` frame
    (the tile grid is the band's): the JAX compositor's ``pixel_y0``, the
    sharded overlay's training route (parallel/render.py:356-364)."""
    num_tiles = tile_start.shape[0]
    p_max, cols = params_sorted.shape
    dev = params_sorted.device
    padded = torch.cat(
        [params_sorted * pair_valid[:, None].to(params_sorted.dtype), params_sorted.new_zeros((1, cols))]
    )
    x, y = tile_ndc(torch.arange(num_tiles, device=dev), tx_count, width, full_height, y0)
    if mode != MODE_2D:  # vp units; the 2DGS falloff works in NDC
        x, y = x * float(width), y * float(full_height)
    px, py = x[:, None, :], y[:, None, :]
    count = torch.clamp(tile_count.to(torch.int64), max=k_max)
    chunk = XLA_CHUNK
    lane = torch.arange(chunk, device=dev)
    start = tile_start.to(torch.int64)[:, None]

    def blend(padded, accum, trans, c: int):
        in_range = lane[None, :] + c * chunk < count[:, None]
        idx = torch.where(in_range, start + c * chunk + lane, p_max)
        q = padded[idx]  # [T, chunk, cols]
        g, _, _, edge = splat_falloff(q, px, py, mode, width, full_height, with_edge=True)
        alpha, edge = overlay_alpha(g, edge, q, mode)
        cum = torch.cumprod(1.0 - alpha, dim=1)
        excl = torch.cat([torch.ones_like(cum[:, :1]), cum[:, :-1]], dim=1)
        w = alpha * excl * trans[:, None, :]
        accum = accum + torch.stack([torch.sum(w * overlay_rgb(q, edge, mode, ch), dim=1) for ch in range(3)], dim=1)
        return accum, trans * cum[:, -1]

    accum = torch.zeros((num_tiles, 3, PIX), dtype=torch.float32, device=dev)
    trans = torch.ones((num_tiles, PIX), dtype=torch.float32, device=dev)
    n_chunks = -(-min(k_max, int(count.max()) if num_tiles else 0) // chunk)
    for c in range(n_chunks):
        if padded.requires_grad:
            accum, trans = checkpoint(blend, padded, accum, trans, c, use_reentrant=False)
        else:
            accum, trans = blend(padded, accum, trans, c)
    return torch.cat([accum, trans[:, None, :]], dim=1)


def supports(settings: CloudSettings) -> bool:
    """Whether the tiled renderer takes ``settings`` (rasterize_tile.py:59):
    every mode is ported, so always."""
    return True


def render_tiled(
    cloud,
    camera: Camera,
    settings: CloudSettings,
    model_transform: Optional[torch.Tensor] = None,
    background: Optional[torch.Tensor] = None,
    pairs_max: Optional[int] = None,
    differentiable: bool = True,
    time=None,
    width: Optional[int] = None,
    height: Optional[int] = None,
    pairs_hint: Optional[int] = None,
    counter: Optional[str] = None,
    aux_near: Optional[float] = None,
):
    """Render -> [H, W, 4] linear premultiplied RGBA on the cloud's device,
    differentiable in the cloud's tensors (and in ``background``) where
    they require grad.  ``background`` is None, a solid [4] RGBA or a full
    image [H, W, 4]; ``pairs_max`` is the pair budget (default:
    ``pairs_budget(N, pairs_hint)``, the 6N cap without a hint); ``time``
    the 4DGS frame time (a number or a float32 scalar tensor, default
    ``settings.time``); ``width`` and ``height`` the image size (default
    the camera's); ``counter`` names the frame's two counters
    (``utils/trace.py``): ``<counter>.budget`` gets its pair budget,
    ``<counter>.pairs`` its uncapped pair count (:func:`count_later`).

    Compositing runs the kernels (``composite_core``), except for the
    bounding-box overlay with ``differentiable=True``: there, as in the JAX
    package, the plain ``composite_tiles`` that autograd differentiates.
    ``render()`` serves with ``differentiable=False``, ``train_step``
    trains with the default.

    ``aux_near`` (2DGS, without the bounding-box overlay; the official
    rasteriser's near plane is ``tile_fwd.AUX_NEAR``) returns ``(image,
    maps)``: the image as above and a dict of [H, W] maps (``normal`` [H,
    W, 3]), each differentiable, composited in the same pass (``ops/cuda/
    tile_fwd.py``): ``alpha`` (1 - T, without the background), ``normal``
    (sum w n, view space), ``depth`` (sum w z), ``distortion`` (sum over
    fragment pairs j < i of w_i w_j (1/z_i - 1/z_j)^2) and ``median`` (the
    median fragment's depth, 0 where there is none), over the fragments
    at a depth of ``aux_near`` or more (``train/losses.py``
    ``SurfaceLoss`` takes them)."""
    surface = aux_near is not None
    if surface and (settings.gaussian_mode != GaussianMode.GAUSSIAN_2D or settings.visualize_bounding_box):
        raise ValueError("aux_near renders 2DGS surfels (GaussianMode.GAUSSIAN_2D) without the bounding-box overlay")
    width = camera.width if width is None else int(width)
    height = camera.height if height is None else int(height)
    if width % TILE:
        raise ValueError(f"image width must be a multiple of {TILE}")
    h_pad = pad_to_tile(height)
    if background is not None and background.dim() != 1:
        if tuple(background.shape) != (height, width, 4):
            raise ValueError(f"background must be [4] or [{height}, {width}, 4], got {tuple(background.shape)}")
        if h_pad != height:
            # full-image backgrounds pad along rows with zeros; the pad rows
            # are cropped again below (rasterize_tile.py:1136-1145)
            background = torch.cat([background, background.new_zeros((h_pad - height, width, 4))])
    cloud = as_float32(cloud)
    tx_count = width // TILE
    n = len(cloud)
    p_max = pairs_max if pairs_max is not None else pairs_budget(n, pairs_hint)
    pairs_counter = None if counter is None else counter + ".pairs"
    if counter is not None:
        trace.count(counter + ".budget", p_max)

    depth_minmax = None
    if settings.rasterize_mode == RasterizeMode.DEPTH:
        depth_minmax = depth_range(cloud, camera, settings, model_transform)
    splats = project_for_binning(cloud, camera, settings, model_transform, depth_minmax, time, (width, height),
                                 surface=surface)
    params = splats["params"]
    mode = kernel_mode(settings)
    if settings.visualize_bounding_box and differentiable:
        with trace.span("gs.bin"):
            g_s, tile_s, valid_s, total = bin_gaussians(splats, width, height, p_max)[:4]
            start, end = tile_ranges(tile_s, tx_count * (h_pad // TILE))
        if pairs_counter is not None:
            trace.count_later(pairs_counter, total)
        with trace.span("gs.composite"):
            out_raw = composite_tiles(
                params[g_s], valid_s, start, end - start, tx_count, width, height, tile_budget(n), mode
            )
    else:
        bins = tile_bins(splats, width, height, p_max, pairs_counter=pairs_counter)
        out_raw = composite_core(
            params, *bins, tx_count=tx_count, width=width, full_height=height,
            chunk=preferred_chunk(p_max, bins.start.shape[0]), mode=mode,
            bbox=settings.visualize_bounding_box, aux_near=aux_near,
        )
    if surface:
        out_raw, maps = out_raw
    img = composite_epilogue(out_raw, background, width, h_pad)
    img = img[:height] if h_pad != height else img
    if not surface:
        return img
    with trace.span("gs.composite"):
        rows = torch.cat([1.0 - out_raw[:, 3:4], maps], dim=1).transpose(1, 2)
        planes = tiles_to_image(rows, width, h_pad)[:height]
    return img, {"alpha": planes[..., 0], "normal": planes[..., 1:4], "depth": planes[..., 4],
                 "distortion": planes[..., 5], "median": planes[..., 6]}


def make_tiled_pipeline(
    settings: CloudSettings,
    width: int,
    height: int,
    differentiable: bool = False,
    pairs_hint: Optional[int] = None,
    pairs_max: Optional[int] = None,
):
    """The forward pipeline of one (settings, size, budget) as a plain
    closure ``fn(cloud, camera, model_transform, background, time)``
    (rasterize_tile.py:1290).  PyTorch runs eagerly, so nothing is compiled
    or cached: the closure only fixes the arguments."""

    def fn(cloud, camera, model_transform=None, background=None, time=None):
        return render_tiled(
            cloud, camera, settings, model_transform, background, pairs_max=pairs_max,
            differentiable=differentiable, time=time, width=width, height=height, pairs_hint=pairs_hint,
        )

    return fn
