"""Tile-binned forward renderer: binning, parameter packing and the pipeline.

The counterpart of the JAX package's ``ops/rasterize_tile.py`` serving path
(``render_tiled(..., compositor="pallas", differentiable=False)``) for the
default configuration: 3DGS, OBB bounds, COLOR mode.  It reproduces that
path's integer artifacts exactly:

  1. project every gaussian (ops/project.py) and take its radix depth key;
  2. each splat's clipped tile rectangle from its OBB screen extent;
  3. a stable depth pre-sort, front to back, inactive gaussians first;
  4. inclusive pair counts, capped at the budget ``p_max`` (the farthest
     pairs drop when the cap binds);
  5. pair expansion (kernel, ops/cuda/expand.py);
  6. a stable pair sort keyed by tile only (pairs are born depth-ordered);
  7. per-tile ranges, counts clipped at ``k_max``;
  8. tile compositing (kernel, ops/cuda/tile_fwd.py) and the epilogue.

Heights that are not a multiple of 16 render on a padded tile grid with
fragments in the true frame (``full_height``); the pad rows are cropped.
"""

from __future__ import annotations

from typing import Optional

import torch

from bevy_gaussian_splatting_tpu_torch.models.camera import Camera
from bevy_gaussian_splatting_tpu_torch.models.settings import CloudSettings
from bevy_gaussian_splatting_tpu_torch.ops import sort as sort_ops
from bevy_gaussian_splatting_tpu_torch.ops.cuda.expand import expand_pairs
from bevy_gaussian_splatting_tpu_torch.ops.cuda.tile_fwd import (
    composite_epilogue,
    composite_tiles_raw,
    preferred_chunk,
)
from bevy_gaussian_splatting_tpu_torch.ops.project import project_gaussians

TILE = 16  # pixels per tile side
PAIRS_HEADROOM = 1.25  # budget over a measured pair count


def pairs_budget(n: int, hint: Optional[int] = None) -> int:
    """Static (gaussian, tile) pair capacity (rasterize_tile.py:63).

    Without a hint: 6N, capped.  With a measured pair count: the next
    1-1.5-2-3 bucket above ``PAIRS_HEADROOM * hint``.  Overflow truncates
    the farthest pairs."""
    cap = int(min(max(6 * n, 1 << 14), 3 << 22))
    if hint is None:
        return cap
    need = max(int(hint * PAIRS_HEADROOM) + 1, 1 << 14)
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


def project_for_binning(cloud, camera: Camera, settings: CloudSettings, model_transform=None) -> dict:
    """``project_gaussians`` with the sentinel cull of its radix key
    (``sort_key``) folded into ``mask``, as ``render_tiled`` prepares them."""
    splats = project_gaussians(cloud, camera, settings, model_transform)
    splats["mask"] = splats["mask"] & (splats["sort_key"] != sort_ops.SENTINEL_KEY)
    return splats


def _pixel_extents(splats: dict, width: int, height: int):
    """Per-splat centre (cx, cy) and OBB half-extents (rx, ry) in pixels."""
    cx_px = (splats["center_ndc"][:, 0] + 1.0) * 0.5 * width
    cy_px = (1.0 - splats["center_ndc"][:, 1]) * 0.5 * height
    e1 = splats["obb_axis"]
    b = splats["obb_bounds"]
    # rotated-rect bbox: |e1|*b1 + |e2|*b2 with e2 = (e1.y, -e1.x)
    rx = (e1[:, 0].abs() * b[:, 0] + e1[:, 1].abs() * b[:, 1]) * 0.5
    ry = (e1[:, 1].abs() * b[:, 0] + e1[:, 0].abs() * b[:, 1]) * 0.5
    return cx_px, cy_px, rx, ry


def tile_rects(splats: dict, width: int, height: int):
    """Clipped tile rectangle of every splat on the padded grid ->
    (tx0, ty0, rect_w, rect_h, active), int64 with zeros where inactive."""
    tx_count = width // TILE
    ty_count = pad_to_tile(height) // TILE
    cx, cy, rx, ry = _pixel_extents(splats, width, height)
    on_screen = (cx + rx >= 0.0) & (cx - rx <= width) & (cy + ry >= 0.0) & (cy - ry <= height)
    active = splats["mask"] & (rx > 0.0) & (ry > 0.0) & on_screen

    def cell(v, count):
        v = torch.clamp(torch.floor(v / TILE), 0, count - 1)
        return torch.where(active, v, torch.zeros_like(v)).to(torch.int64)

    tx0, tx1 = cell(cx - rx, tx_count), cell(cx + rx, tx_count)
    ty0, ty1 = cell(cy - ry, ty_count), cell(cy + ry, ty_count)
    zero = torch.zeros_like(tx0)
    rect_w = torch.where(active, tx1 - tx0 + 1, zero)
    rect_h = torch.where(active, ty1 - ty0 + 1, zero)
    return tx0, ty0, rect_w, rect_h, active


def pair_count(cloud, camera: Camera, settings: CloudSettings, model_transform=None) -> torch.Tensor:
    """Exact (gaussian, tile) pair count of this frame (int64 scalar tensor):
    N-sized work only, the budget-sizing prepass."""
    splats = project_for_binning(cloud, camera, settings, model_transform)
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


def expansion_inputs(splats: dict, width: int, height: int, p_max: int):
    """The expansion kernel's inputs -> ``((cum, rect_w, tx0, ty0, perm), total)``.

    Gaussians in front-to-back order, inactive ones first; ``cum`` holds the
    inclusive pair counts clamped at ``p_max`` (slot owners below ``p_max``
    are unchanged by the clamp, and the int32 table cannot overflow),
    ``perm`` the cloud index of each.  All int32 [N].  ``total`` is the
    uncapped pair count (int64 scalar tensor)."""
    tx0, ty0, rect_w, rect_h, active = tile_rects(splats, width, height)
    perm = front_depth_perm(splats["sort_key"], active)
    cum = torch.cumsum((rect_w * rect_h)[perm], dim=0)
    total = cum[-1] if cum.numel() else cum.new_zeros(())

    def i32(v):
        return v.to(torch.int32).contiguous()

    table = (i32(torch.clamp(cum, max=p_max)), i32(rect_w[perm]), i32(tx0[perm]), i32(ty0[perm]), i32(perm))
    return table, total


def bin_gaussians(splats: dict, width: int, height: int, p_max: int):
    """Sorted (tile, pair) assignment -> ``(g_s, tile_s, valid_s, total)``.

    ``g_s`` / ``tile_s`` [p_max] int32: cloud index and tile of each pair,
    sorted by tile, front to back within a tile; slots past the total carry
    the sentinel tile ``tx_count * ty_count`` (and cloud index 0).
    ``total`` is the uncapped pair count (int64 scalar tensor)."""
    tx_count = width // TILE
    sentinel = tx_count * (pad_to_tile(height) // TILE)
    table, total = expansion_inputs(splats, width, height, p_max)
    tile, g_cloud, _ = expand_pairs(*table, p_max, tx_count, sentinel)
    # born depth-ordered: a stable sort on the tile alone keeps depth order
    tile_s, order = torch.sort(tile, stable=True)
    return g_cloud[order], tile_s, tile_s < sentinel, total


def tile_ranges(pair_tile: torch.Tensor, num_tiles: int):
    """Contiguous [start, end) of every tile in the tile-sorted pairs, from
    one search over ``num_tiles + 1`` tile ids (end[t] == start[t + 1])."""
    tids = torch.arange(num_tiles + 1, dtype=pair_tile.dtype, device=pair_tile.device)
    bounds = torch.searchsorted(pair_tile, tids).to(torch.int32)
    return bounds[:num_tiles], bounds[1:]


def pack_raster_param_cols(splats: dict, width: int, height: int) -> list:
    """Per-splat compositor parameters as a list of columns, in the kernel's
    OBB order ``[cx_vp, cy_vp, e1x, e1y, b1, b2, r, g, b, alpha]``
    (rasterize_tile.py:854-858)."""
    cx_vp = splats["center_ndc"][:, 0] * width
    cy_vp = splats["center_ndc"][:, 1] * height
    rgb = splats["rgb"]
    alpha = splats["alpha"] * splats["mask"].to(torch.float32)
    e1 = splats["obb_axis"]
    b = splats["obb_bounds"]
    return [cx_vp, cy_vp, e1[:, 0], e1[:, 1], b[:, 0], b[:, 1], rgb[:, 0], rgb[:, 1], rgb[:, 2], alpha]


def pack_raster_params(splats: dict, width: int, height: int) -> torch.Tensor:
    """[N, 10] packed per-splat parameters for the compositor."""
    return torch.stack(pack_raster_param_cols(splats, width, height), dim=-1)


def composite_inputs(splats: dict, width: int, height: int, p_max: int):
    """The compositor kernel's inputs -> ``(params_sorted, start, count)``:
    pair-sorted [p_max, 10] parameters and each tile's range, its count
    clipped at ``k_max``, on the padded tile grid."""
    num_tiles = (width // TILE) * (pad_to_tile(height) // TILE)
    g_s, tile_s, _, _ = bin_gaussians(splats, width, height, p_max)
    start, end = tile_ranges(tile_s, num_tiles)
    count = torch.clamp(end - start, max=tile_budget(splats["mask"].shape[0]))
    # slots past the total hold row 0 of the table; tile ranges never
    # reach them, so the compositor never reads those rows
    params_sorted = pack_raster_params(splats, width, height)[g_s].contiguous()
    return params_sorted, start, count


def render_tiled(
    cloud,
    camera: Camera,
    settings: CloudSettings,
    model_transform: Optional[torch.Tensor] = None,
    background: Optional[torch.Tensor] = None,
    pairs_max: Optional[int] = None,
) -> torch.Tensor:
    """Forward render -> [H, W, 4] linear premultiplied RGBA on the cloud's
    device.  ``background`` is None or a solid [4] RGBA; ``pairs_max`` is
    the pair budget (default: ``pairs_budget(N)``, the 6N cap)."""
    width, height = camera.width, camera.height
    if width % TILE:
        raise ValueError(f"image width must be a multiple of {TILE}")
    if background is not None and background.dim() != 1:
        raise NotImplementedError(
            "full-image [H, W, 4] backgrounds arrive with slice 3 of the port"
        )
    h_pad = pad_to_tile(height)
    tx_count = width // TILE
    p_max = pairs_max if pairs_max is not None else pairs_budget(len(cloud))

    splats = project_for_binning(cloud, camera, settings, model_transform)
    params_sorted, start, count = composite_inputs(splats, width, height, p_max)
    out_raw = composite_tiles_raw(
        params_sorted, start, count, tx_count, width, height,
        chunk=preferred_chunk(p_max, start.shape[0]),
    )
    img = composite_epilogue(out_raw, background, width, h_pad)
    return img[:height] if h_pad != height else img
